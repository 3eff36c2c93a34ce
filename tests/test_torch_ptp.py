"""The port's prompt-to-prompt editing held against the JAX package, on the
CPU: ``seq_aligner``, the time-word alphas and equalizers, the editors of
``utils/ptp.py`` (replace, refine, reweight with and without ``inner``),
``LocalBlend``, the UNet with an ``attn_editor`` and ``ptp_sample``.

Both packages read the hash-fallback tokenizer (no CLIP vocabulary in the
repo).  The tiny UNet is ``tests/test_ptp.py:88-91``'s geometry
(``UNET_TINY``) on a 16x16 latent, whose level-0 maps have the 256 tokens
``LocalBlend`` reads: the port's seeded init with 0.02 N(0, 1) on every
parameter and the q and k projections x4 (sharper maps, so the blend mask is
not flat), read into flax through the JAX ingest; contexts and x_T from
``np.random.default_rng``.

Tolerances: the aligner, the alphas and equalizers exactly (integers and
float32 copies); an editor's output 1e-6 absolute on probabilities in
[0, 1] (reweight's 2.0 weights 2e-6: a product of f32 values reordered),
its unconditional half bit-equal to the input; ``LocalBlend`` 1e-6 (the
same f32 mask on both sides, the threshold crossed at the same values);
the UNet's eps 1e-5 x max(1, max|ref|) (f32 sums in another order); the
sampled latents after three steps at CFG 7.5 2e-3 x max|ref|.  The blend's
mask is a threshold: the end-to-end test also asserts that every mask value
the port computes lies farther from 0.3 than the two packages' drift can
move it (1e-4; the smallest distance read 3.6e-4 here, against
differences of the maps of about 1e-7).
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.core.schedules as jsch  # noqa: E402
import fgdm_tpu.utils.ptp as jptp  # noqa: E402
import fgdm_tpu.utils.seq_aligner as jsa  # noqa: E402
from fgdm_tpu.diffusion.latent_diffusion import (  # noqa: E402
    LatentDiffusion as JLatentDiffusion)
from fgdm_tpu.models.clip import CLIPTokenizer as JTokenizer  # noqa: E402
from fgdm_tpu.sampling.ptp_sampler import ptp_sample as j_ptp_sample  # noqa: E402
from fgdm_tpu_torch.core.schedules import DiffusionSchedule  # noqa: E402
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion  # noqa: E402
from fgdm_tpu_torch.models.clip import CLIPTokenizer  # noqa: E402
from fgdm_tpu_torch.sampling.ptp_sampler import ptp_sample  # noqa: E402
from fgdm_tpu_torch.utils import ptp as tptp  # noqa: E402
from fgdm_tpu_torch.utils import seq_aligner as tsa  # noqa: E402
from test_torch_capture import tiny_unet  # noqa: E402
from test_torch_train import SCHED, nchw  # noqa: E402

torch.set_num_threads(2)

JTOK, TTOK = JTokenizer(), CLIPTokenizer()
EDIT_TOL = 1e-6
UNET_TOL = 1e-5
SAMPLE_TOL = 2e-3
STEPS = 10            # the controllers' steps in the editor tests
# base first; equal word counts for replace ("ice-cream" is three tokens,
# "hot-dog" three: the 1/len(target) spreading and its mirror), other
# lengths for refine
REPLACE = ["a cat on a mat", "a dog on a mat", "a ice-cream on a mat"]
REPLACE_SPREAD = ["a hot-dog on a mat", "a cat on a mat"]
REFINE = ["a cat on a mat", "a fluffy cat on a mat", "a cat on a red mat"]


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


# --- seq_aligner ---------------------------------------------------------------

def _edited(rng, x):
    """x with a few seeded substitutions, insertions and deletions."""
    y = list(x)
    for _ in range(3):
        op, pos = rng.integers(3), int(rng.integers(len(y) + 1))
        if op == 0 and pos < len(y):
            y[pos] = int(rng.integers(1, 9))
        elif op == 1:
            y.insert(pos, int(rng.integers(1, 9)))
        elif pos < len(y) and len(y) > 1:
            del y[pos]
    return y


@pytest.mark.parametrize("seed", range(6))
def test_aligned_mapper_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = [int(v) for v in rng.integers(1, 9, int(rng.integers(3, 12)))]
    y = _edited(rng, x)
    for a, b in ((x, y), (y, x), (x, x)):
        got, ref = tsa.aligned_mapper(a, b), jsa.aligned_mapper(a, b)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(tsa.global_align(a, b),
                                      jsa.global_align(a, b))
        for m, r in zip(tsa.get_mapper(a, b), jsa.get_mapper(a, b)):
            assert m.dtype == r.dtype
            np.testing.assert_array_equal(m, r)


@pytest.mark.parametrize("prompts", [REFINE, REPLACE[:2],
                                     ["a cat", "a very very big cat"],
                                     ["the red car is fast", "the car"]])
def test_refinement_mapper_matches_jax(prompts):
    got = tsa.get_refinement_mapper(prompts, TTOK)
    ref = jsa.get_refinement_mapper(prompts, JTOK)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == (len(prompts) - 1, 77)
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("prompts", [REPLACE, REPLACE_SPREAD],
                         ids=["equal-and-spread", "source-spread"])
def test_replacement_mapper_matches_jax(prompts):
    got = tsa.get_replacement_mapper(prompts, TTOK)
    ref = jsa.get_replacement_mapper(prompts, JTOK)
    assert got.dtype == ref.dtype and got.shape == (len(prompts) - 1, 77, 77)
    np.testing.assert_array_equal(got, ref)
    # one token onto three spreads 1/3 over them; three onto one map each
    # with weight 1 (1 / len(target))
    if prompts is REPLACE:
        assert np.isclose(got[1], 1 / 3).any()
    else:
        assert (got[0].sum(axis=0) == 3).any()


def test_replacement_mapper_refuses_unequal_word_counts():
    for mod, tok in ((tsa, TTOK), (jsa, JTOK)):
        with pytest.raises(ValueError, match="equal-length"):
            mod.get_replacement_mapper(["a cat", "a big cat"], tok)


@pytest.mark.parametrize("text,word", [
    ("a photo of a cat riding a bike", "cat"),
    ("a photo of a cat riding a bike", "a"),
    ("a hot-dog on a mat", "hot-dog"),
    ("a hot-dog on a mat", 4), ("don't stop", "stop"),
    ("a cat", "dog")])
def test_word_inds_match_jax(text, word):
    got = tsa.get_word_inds(text, word, TTOK)
    ref = jsa.get_word_inds(text, word, JTOK)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


# --- alphas, equalizers ---------------------------------------------------------

@pytest.mark.parametrize("spec", [
    0.8, 0.5, (0.2, 0.7), {"default_": 0.6, "dog": (0.0, 0.3)},
    {"ice-cream": 0.4}], ids=["float", "half", "tuple", "dict", "word-only"])
def test_time_words_alpha_matches_jax(spec):
    """Each package gets its own copy of a dict spec: both add
    ``"default_"`` to it."""
    mine, theirs = copy.deepcopy(spec), copy.deepcopy(spec)
    got = tptp.get_time_words_attention_alpha(REPLACE, STEPS, mine, TTOK)
    ref = jptp.get_time_words_attention_alpha(REPLACE, STEPS, theirs, JTOK)
    assert got.dtype == ref.dtype and got.shape == (STEPS + 1, 2, 1, 1, 77)
    np.testing.assert_array_equal(got, ref)
    assert mine == theirs


@pytest.mark.parametrize("words,values", [("dog", [2.0]),
                                          (("dog", "mat"), [0.5, 3.0])])
def test_equalizer_matches_jax(words, values):
    got = tptp.get_equalizer(REPLACE[1], words, values, TTOK)
    ref = jptp.get_equalizer(REPLACE[1], words, values, JTOK)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


# --- the editors ----------------------------------------------------------------

def controllers(kind, cfg_doubled=True):
    """``(port, jax)`` controllers of ``kind`` over ``STEPS``: replace and
    reweight on ``REPLACE`` (reweight's ``inner`` a replace controller with
    ``-inner``), refine on ``REFINE``."""
    prompts = REFINE if kind == "refine" else REPLACE
    kw = dict(num_steps=STEPS, cross_replace_steps=0.8,
              self_replace_steps=0.4, cfg_doubled=cfg_doubled)
    base = kind.split("-")[0]
    pair = []
    for mod, tok in ((tptp, TTOK), (jptp, JTOK)):
        extra = {}
        if base == "reweight":
            extra["equalizer"] = mod.get_equalizer(
                prompts[1], "dog", [2.0, 0.5], tok)
            if kind.endswith("inner"):
                extra["inner"] = mod.make_controller(prompts, tok,
                                                     kind="replace", **kw)
        pair.append(mod.make_controller(prompts, tok, kind=base, **kw,
                                        **extra))
    return pair


KINDS = ["replace", "refine", "reweight", "reweight-inner"]


@pytest.mark.parametrize("cfg_doubled", [True, False],
                         ids=["cfg", "no-cfg"])
@pytest.mark.parametrize("kind", KINDS)
def test_editor_matches_jax(kind, cfg_doubled):
    """Cross and self probabilities at N = 64, 256 and 1024, at steps where
    the self replace and the cross replace are on, where only the cross one
    is, and where neither is."""
    tctl, jctl = controllers(kind, cfg_doubled)
    P = 3
    b = 2 * P if cfg_doubled else P
    rng = np.random.default_rng(KINDS.index(kind) + 10 * cfg_doubled)
    tol = 2 * EDIT_TOL if kind.startswith("reweight") else EDIT_TOL
    for n in (64, 256, 1024):
        for is_cross in (True, False):
            m = 77 if is_cross else n
            p = rng.random((b, 2, n, m)).astype(np.float32)
            p /= p.sum(-1, keepdims=True)
            tp = torch.from_numpy(p)
            for step in (0, 3, 5, 9):
                got = tctl.editor(step)(tp, is_cross, "down")
                ref = np.asarray(jctl.editor(jnp.asarray(step))(
                    jnp.asarray(p), is_cross, "down"))
                assert got.shape == p.shape and got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                           atol=tol)
                if cfg_doubled:
                    assert torch.equal(got[:P], tp[:P])
                # the base prompt's maps are never edited
                assert torch.equal(got[b - P], tp[b - P])
                # cross maps replaced below 0.8 of the steps, self maps
                # at N <= 256 below 0.4
                edited = not np.array_equal(ref, p)
                assert edited == (step < 8 if is_cross
                                  else n <= 256 and step < 4), \
                    (n, is_cross, step)


def test_editor_stores_the_16x16_cross_maps():
    tctl, _ = controllers("replace")
    tctl.store = []
    rng = np.random.default_rng(3)
    maps = [torch.from_numpy(rng.random((6, 2, n, m)).astype(np.float32))
            for n, m in ((256, 77), (64, 77), (256, 256))]
    for mp, cross in zip(maps, (True, True, False)):
        tctl.editor(1)(mp, cross, "up")
    assert len(tctl.store) == 1 and tctl.store[0] is maps[0]


def test_reweight_needs_an_equalizer():
    with pytest.raises(ValueError, match="equalizer"):
        tptp.make_controller(REPLACE, TTOK, STEPS, kind="reweight")


@pytest.mark.parametrize("hw", [64, 24], ids=["16to64", "16to24"])
def test_local_blend_matches_jax(hw):
    """Shared numpy maps (two layers, CFG-doubled and not), latents at a
    whole and a fractional resize ratio (half-pixel centres on both
    sides)."""
    P = 2
    words = [["cat"], ["dog"]]
    tlb = tptp.LocalBlend.create(REPLACE[:2], words, TTOK)
    jlb = jptp.LocalBlend.create(REPLACE[:2], words, JTOK)
    np.testing.assert_array_equal(tlb.alpha_layers.numpy(),
                                  np.asarray(jlb.alpha_layers))
    rng = np.random.default_rng(hw)
    # maps peaked on a few positions at the blended words' tokens, so the
    # mask is neither empty nor full
    maps = []
    for b in (2 * P, P):
        m = rng.random((b, 2, 256, 77)).astype(np.float32) * 0.01
        m[:, :, rng.integers(0, 256, 40), 2] += 1.0
        maps.append(m / m.sum(-1, keepdims=True))
    x = rng.standard_normal((P, hw, hw, 4)).astype(np.float32)
    ref = np.asarray(jlb(jnp.asarray(x), [jnp.asarray(m) for m in maps]))
    got = tlb(nchw(x), [torch.from_numpy(m) for m in maps])
    np.testing.assert_allclose(nhwc(got), ref, rtol=0, atol=EDIT_TOL)
    kept = np.all(ref[1] == x[0], axis=-1)
    assert 0.05 < kept.mean() < 0.95
    np.testing.assert_array_equal(nhwc(got)[0], x[0])


# --- the UNet with an editor ----------------------------------------------------

@pytest.fixture(scope="module")
def unet_pair():
    jdef, jp, unet = tiny_unet(80, qk_scale=4.0)
    return jdef, jp, unet.requires_grad_(False)


@pytest.fixture(scope="module")
def unet_inputs():
    rng = np.random.default_rng(81)
    return dict(x=rng.standard_normal((4, 16, 16, 4)).astype(np.float32),
                t=np.array([501, 501, 501, 501]),
                ctx=rng.standard_normal((4, 77, 64)).astype(np.float32))


def _kind_controllers(kind):
    """Two-prompt controllers (the CFG batch of 4) for the UNet tests."""
    prompts = REFINE[:2] if kind == "refine" else REPLACE[:2]
    kw = dict(num_steps=STEPS)
    pair = []
    for mod, tok in ((tptp, TTOK), (jptp, JTOK)):
        extra = {}
        if kind.startswith("reweight"):
            extra = dict(equalizer=mod.get_equalizer(prompts[1], "dog",
                                                     [2.0], tok),
                         inner=mod.make_controller(prompts, tok,
                                                   kind="replace", **kw))
        pair.append(mod.make_controller(prompts, tok,
                                        kind=kind.split("-")[0], **kw,
                                        **extra))
    return pair


@pytest.mark.parametrize("kind", ["replace", "refine", "reweight-inner"])
def test_unet_with_editor_matches_jax(unet_pair, unet_inputs, kind):
    jdef, jp, unet = unet_pair
    tctl, jctl = _kind_controllers(kind)
    places = []

    def tedit(p, is_cross, place):
        places.append(place)
        return tctl.editor(2)(p, is_cross, place)

    i = unet_inputs
    ref = jdef.apply(jp, jnp.asarray(i["x"]), jnp.asarray(i["t"]),
                     context=jnp.asarray(i["ctx"]),
                     attn_editor=jctl.editor(jnp.asarray(2)))
    with torch.no_grad():
        got = unet(nchw(i["x"]), torch.from_numpy(i["t"]),
                   context=torch.from_numpy(i["ctx"]), attn_editor=tedit)
        plain = unet(nchw(i["x"]), torch.from_numpy(i["t"]),
                     context=torch.from_numpy(i["ctx"]))
    ref = np.asarray(ref)
    np.testing.assert_allclose(nhwc(got), ref, rtol=0,
                               atol=UNET_TOL * max(1.0, np.abs(ref).max()))
    # the edit moves eps; every layer saw it: two a transformer, its place
    # by block (2 down, 1 mid, 4 up at this geometry)
    assert np.abs(nhwc(plain) - ref).max() > 1e-3
    assert places == ["down"] * 4 + ["mid"] * 2 + ["up"] * 8


def test_identity_editor_is_the_probs_path(unet_pair, unet_inputs):
    """An editor that changes nothing gives the ``"probs"`` capture's eps
    bit for bit, and with ``capture`` it returns what the capture does;
    with ``capture=True`` it returns head-averaged scores, as JAX's."""
    jdef, jp, unet = unet_pair
    i = unet_inputs
    args = (nchw(i["x"]), torch.from_numpy(i["t"]))
    ctx = torch.from_numpy(i["ctx"])

    def ident(p, is_cross, place):
        return p

    with torch.no_grad():
        eps = unet(*args, context=ctx, attn_editor=ident)
        cap, sa, ca = unet(*args, context=ctx, capture="probs")
        cap2, sa2, ca2 = unet(*args, context=ctx, capture="probs",
                              attn_editor=ident)
        _, sims, simc = unet(*args, context=ctx, capture=True,
                             attn_editor=ident)
    assert torch.equal(eps, cap) and torch.equal(cap2, cap)
    for a, b in ((sa, sa2), (ca, ca2)):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    _, jsims, jsimc = jdef.apply(
        jp, jnp.asarray(i["x"]), jnp.asarray(i["t"]),
        context=jnp.asarray(i["ctx"]), capture=True,
        attn_editor=lambda p, is_cross, place: p)
    # scores of q and k scaled x4 each: terms 16x the plain init's, so the
    # f32 cancellation is held at 1e-4 of max|ref| (read 1.1e-5 here)
    for got, ref in ((sims, jsims), (simc, jsimc)):
        assert sorted(got) == sorted(ref)
        for k in ref:
            r = np.asarray(ref[k])
            assert got[k].shape == r.shape and r.ndim == 3
            np.testing.assert_allclose(got[k].numpy(), r, rtol=1e-4,
                                       atol=1e-4 * np.abs(r).max())


# --- ptp_sample end to end ------------------------------------------------------

@pytest.fixture(scope="module")
def pipes(unet_pair):
    jdef, jp, unet = unet_pair
    jld = JLatentDiffusion(
        unet_def=jdef, vae_def=None, clip_def=None, unet_params=jp,
        schedule=jsch.DiffusionSchedule.create(1000, "linear", **SCHED))
    ld = LatentDiffusion(unet, None,
                         DiffusionSchedule.create(1000, "linear", **SCHED))
    rng = np.random.default_rng(82)
    return dict(jld=jld, ld=ld,
                x=np.repeat(rng.standard_normal((1, 16, 16, 4)), 2,
                            0).astype(np.float32),
                ctx=rng.standard_normal((3, 77, 64)).astype(np.float32),
                uc=rng.standard_normal((2, 77, 64)).astype(np.float32))


def _sample_pair(pipes, blend, monkeypatch):
    prompts = REPLACE[:2]
    tctl = tptp.make_controller(prompts, TTOK, 3, kind="replace")
    jctl = jptp.make_controller(prompts, JTOK, 3, kind="replace")
    tlb = jlb = None
    if blend:
        tlb = tptp.LocalBlend.create(prompts, [["cat"], ["dog"]], TTOK)
        jlb = jptp.LocalBlend.create(prompts, [["cat"], ["dog"]], JTOK)
    p = pipes
    ref = j_ptp_sample(p["jld"], jctl, jax.random.PRNGKey(0),
                       jnp.asarray(p["ctx"][:2]), jnp.asarray(p["uc"]),
                       latent_hw=(16, 16), num_steps=3, local_blend=jlb,
                       x_T=jnp.asarray(p["x"]))
    dist = []
    if tlb is not None:
        # the smallest distance of a mask value from the threshold
        inner = tptp.LocalBlend.mask

        def mask(self, shape, maps):
            m = inner(self, shape, maps)
            dist.append((m - self.threshold).abs().min().item())
            return m

        monkeypatch.setattr(tptp.LocalBlend, "mask", mask)
    got = ptp_sample(p["ld"], tctl, torch.from_numpy(p["ctx"][:2]),
                     torch.from_numpy(p["uc"]), latent_hw=(16, 16),
                     num_steps=3, local_blend=tlb, x_T=nchw(p["x"]))
    return got, np.asarray(ref), dist


@pytest.mark.parametrize("blend", [False, True], ids=["plain", "local-blend"])
def test_ptp_sample_matches_jax(pipes, blend, monkeypatch):
    got, ref, dist = _sample_pair(pipes, blend, monkeypatch)
    assert got.shape == (2, 4, 16, 16)
    np.testing.assert_allclose(nhwc(got), ref, rtol=0,
                               atol=SAMPLE_TOL * np.abs(ref).max())
    # the edit moved item 1 away from the base
    assert np.abs(ref[1] - ref[0]).max() > 1e-2
    if blend:
        # 3 steps of 1000 // 3: four DDIM steps, a blend after each
        assert len(dist) == 4 and min(dist) > 1e-4, dist
        # the blend keeps item 0's latent somewhere and not everywhere
        kept = np.all(ref[1] == ref[0], axis=-1).mean()
        assert 0.0 < kept < 1.0, kept


def test_item_zero_does_not_depend_on_the_edit(pipes):
    """The base prompt's latent is the same bit for bit whichever edit
    prompt rides beside it (with and without the blend)."""
    p = pipes
    outs = []
    for edit, ctx in ((REPLACE[1], p["ctx"][1:2]), (REPLACE[2],
                                                     p["ctx"][2:3])):
        prompts = [REPLACE[0], edit]
        ctl = tptp.make_controller(prompts, TTOK, 3, kind="replace")
        lb = tptp.LocalBlend.create(prompts, [["cat"], [edit.split()[1]]],
                                    TTOK)
        cond = torch.from_numpy(np.concatenate([p["ctx"][:1], ctx]))
        outs.append(ptp_sample(p["ld"], ctl, cond, torch.from_numpy(p["uc"]),
                               latent_hw=(16, 16), num_steps=3,
                               local_blend=lb, x_T=nchw(p["x"])))
    assert torch.equal(outs[0][0], outs[1][0])
    assert not torch.equal(outs[0][1], outs[1][1])


def test_ptp_sample_draws_one_x_t_for_every_prompt(pipes):
    """Without x_T, one draw from the generator seeds every prompt: with
    the identity of a replace edit (the same prompt twice) both items are
    equal."""
    p = pipes
    prompts = [REPLACE[0], REPLACE[0]]
    ctl = tptp.make_controller(prompts, TTOK, 2, kind="replace")
    cond = torch.from_numpy(np.concatenate([p["ctx"][:1]] * 2))
    uc = torch.from_numpy(np.concatenate([p["uc"][:1]] * 2))
    out = ptp_sample(p["ld"], ctl, cond, uc, latent_hw=(16, 16), num_steps=2,
                     generator=torch.Generator().manual_seed(5))
    assert torch.equal(out[0], out[1])
    with pytest.raises(ValueError, match="x_T or a generator"):
        ptp_sample(p["ld"], ctl, cond, uc, latent_hw=(16, 16), num_steps=2)
