"""The N-factor chain (text -> seg -> depth -> normal -> image) held against
the JAX package: the time adapter, the multi-adapter UNet, each factor of a
three-factor ``all_pconds`` chain, ``NpleAutoencoderKL`` and the ingest of
time-adapter and multi-adapter checkpoints; then the port's own contracts
for ``fgdm_chain_n`` (composition, one factor = ``fgdm_chain``, per-slot
streams, conditioning on the previous factor) and the leaf-by-leaf CFG
concat of list-valued conds.

Tiny geometries of ``tests/test_torch_chain.py``, float32 on the CPU.  Flax
params (perturbed by 0.02 N(0, 1) so zero-init heads work) go into the port
through ``convert.unet_state_dict`` with ``load_state_dict(strict=True)``;
JAX's extra adapters ``adapters_{k}`` exist once ``extra_pconds`` is traced
at init, as ``fgdm_tpu/checkpoint/loader.py:128-131`` does.  Torch cannot
draw ``jax.random``'s bits, so both packages' ``fgdm_chain_n`` run on the
same numpy x_T, injected through their ``_sample_factor_latents``; each
factor then reads its own package's latents of the factors before it.

Tolerances: a whole model (UNet, time adapter, VAE) max |port - jax| <=
1e-4 * max(1, max |jax|) (float32, sums in another order), and the same
for a factor's latent after three DDIM steps at CFG 7.5 (the error read
3.5e-6 of max |jax| on an x86 CPU).  The port-only contracts hold bit for
bit.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.sampling.chain as jchain  # noqa: E402
import fgdm_tpu.sampling.ddim as jddim  # noqa: E402
from fgdm_tpu import config as jconfig  # noqa: E402
from fgdm_tpu.checkpoint import loader as jloader  # noqa: E402
from fgdm_tpu.checkpoint import torch_ingest as jti  # noqa: E402
from fgdm_tpu.diffusion.latent_diffusion import (  # noqa: E402
    LatentDiffusion as JLatentDiffusion)
from fgdm_tpu.models.adapter import TimeAdapter as JTimeAdapter  # noqa: E402
from fgdm_tpu.models.autoencoder import (  # noqa: E402
    AutoencoderKL as JAutoencoderKL)
from fgdm_tpu.models.autoencoder import (  # noqa: E402
    NpleAutoencoderKL as JNpleAutoencoderKL)
from fgdm_tpu.models.unet import UNetModel as JUNetModel  # noqa: E402
from fgdm_tpu_torch import builders, config  # noqa: E402
from fgdm_tpu_torch.checkpoint import convert, loader  # noqa: E402
from fgdm_tpu_torch.checkpoint import torch_ingest as ti  # noqa: E402
from fgdm_tpu_torch.diffusion.control import ControlLDM  # noqa: E402
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion  # noqa: E402
from fgdm_tpu_torch.models.adapter import TimeAdapter  # noqa: E402
from fgdm_tpu_torch.models.autoencoder import (  # noqa: E402
    AutoencoderKL, NpleAutoencoderKL)
from fgdm_tpu_torch.models.clip import CLIPTextEncoder  # noqa: E402
from fgdm_tpu_torch.models.controlnet import ControlNet  # noqa: E402
from fgdm_tpu_torch.models.unet import UNetModel  # noqa: E402
from fgdm_tpu_torch.nn.layers import init_params_  # noqa: E402
from fgdm_tpu_torch.sampling import chain as tchain  # noqa: E402
from fgdm_tpu_torch.sampling import ddim as tddim  # noqa: E402
from test_torch_chain import (TINY, VAE_TINY, nchw, nhwc,  # noqa: E402
                              sd14_jax_schedule)

torch.set_num_threads(2)

TOL = 1e-4          # a whole model, float32 on both sides
FACTOR_TOL = 1e-4   # a factor's latent after STEPS DDIM steps at CFG 7.5
STEPS = 3
LAT = 8             # latent side of the JAX comparisons
COND_HW, IMAGE_HW = (32, 32), (64, 64)
CLIP_TINY = dict(vocab_size=49408, embed_dim=64, num_layers=1, num_heads=4)
F32 = dict(dtype=torch.float32, device="cpu")


def perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), params)


def assert_close(port, ref, tol=TOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def without(params, *heads):
    tree = params.get("params", params)
    return {"params": {k: v for k, v in tree.items() if k not in heads}}


def port_unet(params, **kw):
    tm = UNetModel(**TINY, **F32, **kw)
    tm.load_state_dict(convert.unet_state_dict(params), strict=True)
    return tm.eval()


def _zeros():
    return (jnp.zeros((1, LAT, LAT, 4)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 77, 64)))


def seeded_tree(module, seed, **kw):
    """Flax params of ``module`` with seeded values: the tree of its init
    traced on shapes alone (``loader._abstract_init``; the extra adapters
    appear when ``extra_pconds`` is traced), kernels N(0, 1/fan_in), norm
    scales 1 and biases 0, each plus 0.02 N(0, 1).  Flax's own eager init
    would run every op at batch 1, which the tests never use."""
    x, t, ctx = _zeros()
    tree = jloader._abstract_init(module, x, t, ctx, **kw)
    rng = np.random.default_rng(seed)

    def fill(path, a):
        shape, leaf = a.shape, path[-1].key
        base = np.ones(shape) if leaf == "scale" else np.zeros(shape)
        if leaf == "kernel":
            base = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        return (base + 0.02 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def jparams():
    """Flax params: the UNet with two extra adapters (``adapters_0``,
    ``adapters_1``; drop them for ``num_prompts`` 2 or 1) and the
    time-adapter UNet."""
    x = _zeros()[0]
    return {"multi": seeded_tree(JUNetModel(**TINY, num_prompts=3,
                                            dtype=jnp.float32), 10,
                                 extra_pconds=[x, x]),
            "time": seeded_tree(JUNetModel(**TINY, use_time_adapter=True,
                                           dtype=jnp.float32), 11)}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    lat = (2, LAT, LAT, 4)
    return dict(x=rng.standard_normal(lat).astype(np.float32),
                t=np.array([3, 811], np.int32),
                ctx=rng.standard_normal((2, 77, 64)).astype(np.float32),
                pconds=[rng.standard_normal(lat).astype(np.float32)
                        for _ in range(3)])


# --- the time adapter and the multi-adapter UNet ------------------------------

def test_time_adapter_features_match_jax(jparams, inputs):
    """``TimeAdapter`` alone: one feature a level, the blocks ResBlocks on the
    timestep embedding (unfused GroupNorm, as JAX builds them)."""
    ad = jparams["time"]["params"]["adapter"]
    jm = JTimeAdapter(channels=(32, 64), nums_rb=2, cin=4, emb_ch=128,
                      dtype=jnp.float32)
    emb = np.random.default_rng(1).standard_normal((2, 128)).astype(
        np.float32)
    ref = jm.apply({"params": ad}, jnp.asarray(inputs["x"]),
                   jnp.asarray(emb))
    tm = TimeAdapter(channels=(32, 64), nums_rb=2, cin=4, emb_ch=128,
                     dtype=torch.float32)
    sd = convert.unet_state_dict({"adapter": ad})
    tm.load_state_dict({k[len("adapter."):]: v for k, v in sd.items()},
                       strict=True)
    assert "adapter.body.0.in_layers.2.weight" in sd
    assert "body.0.in_conv.weight" not in tm.state_dict()
    with torch.no_grad():
        out = tm(nchw(inputs["x"]), torch.from_numpy(emb))
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        assert_close(nhwc(o), r)
    assert not any(m.fused_norm for m in tm.body)


def test_time_adapter_unet_matches_jax(jparams, inputs):
    p = jparams["time"]
    jm = JUNetModel(**TINY, use_time_adapter=True, dtype=jnp.float32)
    tm = port_unet(p, use_time_adapter=True)
    assert isinstance(tm.adapter, TimeAdapter)
    for pc in (None, inputs["pconds"][0]):
        ref = jm.apply(p, jnp.asarray(inputs["x"]), jnp.asarray(inputs["t"]),
                       jnp.asarray(inputs["ctx"]),
                       pcond=None if pc is None else jnp.asarray(pc))
        with torch.no_grad():
            out = tm(nchw(inputs["x"]), torch.from_numpy(inputs["t"]),
                     context=torch.from_numpy(inputs["ctx"]),
                     pcond=None if pc is None else nchw(pc))
        assert_close(nhwc(out), ref)


@pytest.mark.parametrize("num_prompts", [2, 3])
@pytest.mark.parametrize("n_extra", [0, 1, 2])
def test_multi_adapter_unet_matches_jax(jparams, inputs, num_prompts,
                                        n_extra):
    """``num_prompts - 1`` extra adapters read the first ``extra_pconds``;
    an empty list (or more prompts than adapters) is read as JAX reads
    it."""
    p = without(jparams["multi"], *[f"adapters_{k}" for k in
                                    range(num_prompts - 1, 2)])
    jm = JUNetModel(**TINY, num_prompts=num_prompts, dtype=jnp.float32)
    tm = port_unet(p, num_prompts=num_prompts)
    assert len(tm.adapters) == num_prompts - 1
    extra = inputs["pconds"][1:1 + n_extra]
    ref = jm.apply(p, jnp.asarray(inputs["x"]), jnp.asarray(inputs["t"]),
                   jnp.asarray(inputs["ctx"]),
                   pcond=jnp.asarray(inputs["pconds"][0]),
                   extra_pconds=[jnp.asarray(e) for e in extra])
    with torch.no_grad():
        out = tm(nchw(inputs["x"]), torch.from_numpy(inputs["t"]),
                 context=torch.from_numpy(inputs["ctx"]),
                 pcond=nchw(inputs["pconds"][0]),
                 extra_pconds=[nchw(e) for e in extra])
        base = tm(nchw(inputs["x"]), torch.from_numpy(inputs["t"]),
                  context=torch.from_numpy(inputs["ctx"]),
                  pcond=nchw(inputs["pconds"][0]), extra_pconds=None)
    assert_close(nhwc(out), ref)
    # the extra adapters change the output exactly when one of them runs
    assert torch.equal(out, base) == (n_extra == 0)


# --- each factor of the three-factor all_pconds chain ------------------------

@pytest.fixture(scope="module")
def factors(jparams):
    """Three factor pipelines on both sides: factors 1 and 2 plain
    (``num_prompts`` 1), factor 3 with one extra adapter, as the CLI builds
    them under ``--all_pconds``; each UNet on its own perturbed weights, one
    seeded VAE read into flax through the JAX ingest."""
    sched, tsched = sd14_jax_schedule(), builders.sd14_schedule()
    vae = init_params_(AutoencoderKL(**VAE_TINY, **F32),
                       torch.Generator().manual_seed(12), 0.02).eval()
    jvae = JAutoencoderKL(**VAE_TINY, dtype=jnp.float32)
    vae_p, missing, unexpected = jti.ingest_vae(
        {ti.VAE_PREFIX + k: v.numpy() for k, v in vae.state_dict().items()},
        expect=jloader._abstract_init(jvae, jnp.zeros((1, 64, 64, 3)),
                                      sample_posterior=False))
    assert missing == [] and unexpected == []
    out = []
    for k, n in enumerate((1, 1, 2)):
        p = perturbed(without(jparams["multi"], *[
            f"adapters_{j}" for j in range(n - 1, 2)]), 20 + k)
        jm = JUNetModel(**TINY, num_prompts=n, dtype=jnp.float32)
        jld = JLatentDiffusion(unet_def=jm, vae_def=jvae, clip_def=None,
                               unet_params=p, vae_params=vae_p,
                               schedule=sched)
        ld = LatentDiffusion(port_unet(p, num_prompts=n), vae, tsched)
        out.append((jld, ld))
    return out


def injected_latents(mp, pkg, xts):
    """Patch ``pkg._sample_factor_latents`` to draw its x_T from ``xts``
    (NCHW numpy), call by call, and to record the latents it returns.  Both
    packages' ``fgdm_chain_n`` and ``sample_image_factor`` call it, so the
    chain runs as it stands on injected noise."""
    real, zs = pkg._sample_factor_latents, []

    if pkg is jchain:
        def fn(*a, **kw):
            kw["x_T"] = jnp.asarray(xts[len(zs)].transpose(0, 2, 3, 1))
            zs.append(real(*a, **kw))
            return zs[-1]
    else:
        def fn(ld, shape, cond, uncond, steps, scale, eta, x_T, *rest):
            zs.append(real(ld, shape, cond, uncond, steps, scale, eta,
                           torch.from_numpy(xts[len(zs)]), *rest))
            return zs[-1]

    mp.setattr(pkg, "_sample_factor_latents", fn)
    return zs


@pytest.fixture(scope="module")
def chain_n_runs(factors):
    """``fgdm_chain_n`` of both packages on the three factors with
    ``all_pconds`` (factor k > 0 prompted by the latent before it, factor 3
    also by factor 1's through its extra adapter), on the same injected x_T
    and contexts: each factor's latent and decoded map."""
    rng = np.random.default_rng(2)
    xts = [rng.standard_normal((2, 4, LAT, LAT)).astype(np.float32)
           for _ in range(3)]
    ctxs = [rng.standard_normal((2, 77, 64)).astype(np.float32)
            for _ in range(4)]
    kw = dict(cond_hw=(8 * LAT, 8 * LAT), factor_steps=STEPS,
              all_pconds=True)
    jlds = [jld for jld, _ in factors]
    with pytest.MonkeyPatch.context() as mp:
        jzs = injected_latents(mp, jchain, xts)

        @jax.jit
        def run(ctxs):
            out = jchain.fgdm_chain_n(jlds, None, jax.random.PRNGKey(0),
                                      ctxs[:3], ctxs[3], **kw)
            return list(jzs), out["conditions"]

        ref_z, ref_c = run([jnp.asarray(c) for c in ctxs])
        zs = injected_latents(mp, tchain, xts)
        out = tchain.fgdm_chain_n([ld for _, ld in factors], None,
                                  [torch.from_numpy(c) for c in ctxs[:3]],
                                  torch.from_numpy(ctxs[3]),
                                  generator=torch.Generator(), **kw)
    return dict(xts=xts, ctxs=ctxs, ref_z=[np.asarray(z) for z in ref_z],
                ref_c=[np.asarray(c) for c in ref_c],
                zs=[nhwc(z) for z in zs],
                conds=[nhwc(c) for c in out["conditions"]])


@pytest.mark.parametrize("k", [0, 1, 2])
def test_chain_n_factor_matches_jax(chain_n_runs, k):
    """Factor k of the two packages' ``fgdm_chain_n``: its latent and its
    decoded map."""
    r = chain_n_runs
    assert len(r["zs"]) == len(r["ref_z"]) == 3
    assert np.abs(r["ref_z"][k]).max() > 0.1
    assert_close(r["zs"][k], r["ref_z"][k], FACTOR_TOL)
    assert r["ref_c"][k].std() > 1e-2
    assert_close(r["conds"][k], r["ref_c"][k], FACTOR_TOL)


def test_chain_n_factors_condition_on_the_previous_ones(factors,
                                                         chain_n_runs):
    """Factor 3 without its pconds gives another latent: the chain's
    conditioning is not a no-op at these weights."""
    ld = factors[2][1]
    ctxs = [torch.from_numpy(c) for c in chain_n_runs["ctxs"]]
    with torch.inference_mode():
        z = tchain._sample_factor_latents(
            ld, (2, 4, LAT, LAT), {"c_crossattn": ctxs[2]},
            {"c_crossattn": ctxs[3]}, STEPS, 7.5, 0.0,
            torch.from_numpy(chain_n_runs["xts"][2]), None, None, "ddim")
    assert np.abs(nhwc(z) - chain_n_runs["ref_z"][2]).max() > 10 * FACTOR_TOL


# --- NpleAutoencoderKL ----------------------------------------------------------

@pytest.fixture(scope="module")
def nple():
    """The port's seeded tiny VAE read into flax through the JAX ingest."""
    tm = NpleAutoencoderKL(**VAE_TINY, nple=2, **F32)
    init_params_(tm, torch.Generator().manual_seed(3), 0.02)
    jm = JNpleAutoencoderKL(**VAE_TINY, nple=2, dtype=jnp.float32)
    expect = jloader._abstract_init(jm, jnp.zeros((1, 64, 64, 3)),
                                    sample_posterior=False)
    tree, missing, unexpected = jti.ingest_vae(
        {ti.VAE_PREFIX + k: v.numpy() for k, v in tm.state_dict().items()},
        expect=expect)
    assert missing == [] and unexpected == []
    return jm, tree, tm.eval()


@pytest.mark.parametrize("method", ["encode_nple", "decode_nple"])
def test_nple_autoencoder_matches_jax(nple, method):
    jm, p, tm = nple
    rng = np.random.default_rng(4)
    if method == "encode_nple":
        xs = [rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
              for _ in range(2)]
        ref = [jm.apply(p, [jnp.asarray(x) for x in xs],
                        method=JNpleAutoencoderKL.encode_nple)]
        with torch.no_grad():
            out = [tm.encode_nple([nchw(x) for x in xs])]
        assert out[0].shape == (1, 8, 8, 8)
    else:
        z = rng.standard_normal((1, 8, 8, 8)).astype(np.float32)
        ref = jm.apply(p, jnp.asarray(z), method=JNpleAutoencoderKL.decode_nple)
        with torch.no_grad():
            out = tm.decode_nple(nchw(z))
        assert len(out) == 2 and out[0].shape == (1, 3, 64, 64)
        with pytest.raises(ValueError, match="equal chunks"):
            tm.decode_nple(nchw(z)[:, :7])
    for o, r in zip(out, ref):
        assert_close(nhwc(o), r)


def test_nple_config_target_builds_it():
    params = {"embed_dim": 4, "nple": 2, "ddconfig": {
        "ch": 32, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 1,
        "resolution": 64, "z_channels": 4, "double_z": True,
        "in_channels": 3, "out_ch": 3, "attn_resolutions": []}}
    cfg = {"target": "ldm.models.autoencoder.NpleAutoencoderKL",
           "params": params}
    tdef = config.instantiate_from_config(cfg, dtype=torch.float32)
    jdef = jconfig.instantiate_from_config(cfg, dtype=jnp.float32)
    assert tdef.cls is NpleAutoencoderKL and isinstance(jdef,
                                                        JNpleAutoencoderKL)
    for k, v in tdef.kwargs.items():
        if k != "dtype":
            assert getattr(jdef, k) == v, k
    vae = tdef.build("cpu")
    assert isinstance(vae, NpleAutoencoderKL) and vae.nple == 2


# --- checkpoints ------------------------------------------------------------------

def _tiny_presets(mp):
    mp.setattr(loader, "sd_unet", lambda dtype, device, **o: UNetModel(
        **TINY, dtype=dtype, device=device, **o))
    mp.setattr(loader, "sd_vae", lambda dtype, device: AutoencoderKL(
        **VAE_TINY, dtype=dtype, device=device))
    mp.setattr(loader, "sd_clip", lambda dtype, device: CLIPTextEncoder(
        **CLIP_TINY, dtype=dtype, device=device))


def _save(path, unet):
    torch.save({"state_dict": {ti.UNET_PREFIX + k: v for k, v in
                               unet.state_dict().items()}}, path)
    return str(path)


def test_time_adapter_checkpoint_loads_with_no_missing_key(jparams, tmp_path,
                                                          monkeypatch):
    """A time-adapter file in the reference's schema: its blocks' convs are
    ``in_layers.2`` and load as such (the plain adapter's rename to
    ``in_conv`` does not apply), 0 missing and 0 unexpected on both sides,
    every tensor equal to JAX's loaded param."""
    src = port_unet(jparams["time"], use_time_adapter=True)
    path = _save(tmp_path / "time.pth", src)
    _tiny_presets(monkeypatch)
    ld = loader.load_fgdm(path, dtype=torch.float32, use_time_adapter=True,
                          device="cpu", verbose=False)
    assert isinstance(ld.unet.adapter, TimeAdapter)
    assert ld.load_report["missing"]["unet"] == []
    assert ld.load_report["unexpected"] == []
    x, t, ctx = _zeros()
    tree, jm, ju = jti.ingest_unet(
        jti.load_torch_state_dict(path), expect=jloader._abstract_init(
            JUNetModel(**TINY, use_time_adapter=True, dtype=jnp.float32),
            x, t, ctx))
    assert jm == [] and ju == []
    ref = convert.unet_state_dict(jax.tree.map(np.asarray, tree))
    got = ld.unet.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_extra_adapter_keys_are_read_as_jax_reads_them(tmp_path,
                                                       monkeypatch):
    """JAX's schema maps no ``adapters.*`` key: a file's extra-adapter keys
    are unexpected and the extra adapter keeps its init, counted as
    missing, on both sides; the rest loads."""
    src = UNetModel(**TINY, num_prompts=2, **F32)
    init_params_(src, torch.Generator().manual_seed(5), 0.02)
    path = _save(tmp_path / "multi.pth", src)
    _tiny_presets(monkeypatch)
    unet = UNetModel(**TINY, num_prompts=2, **F32)
    ld = loader.load_fgdm(path, dtype=torch.float32, unet=unet,
                          device="cpu", verbose=False)
    extra = sorted(k for k in src.state_dict() if k.startswith("adapters."))
    assert extra
    assert sorted(ld.load_report["missing"]["unet"]) == extra
    assert sorted(ld.load_report["unexpected"]) == extra
    fresh = loader.seeded_init_(UNetModel(**TINY, num_prompts=2, **F32), 0)
    got, want, file_sd = (ld.unet.state_dict(), fresh.state_dict(),
                          src.state_dict())
    for k in got:
        assert torch.equal(got[k], want[k] if k in extra else file_sd[k]), k
    x, t, ctx = _zeros()
    _, jm, ju = jti.ingest_unet(
        jti.load_torch_state_dict(path), expect=jloader._abstract_init(
            JUNetModel(**TINY, num_prompts=2, dtype=jnp.float32), x, t, ctx,
            extra_pconds=[x]))
    assert len(jm) == len(extra) and len(ju) == len(extra)
    assert all(k.startswith("params/adapters_0/") for k in jm)


# --- the CFG concat ------------------------------------------------------------------

def test_cfg_inputs_concat_lists_leaf_by_leaf():
    """A list-valued cond (``extra_pconds``) concatenates leaf by leaf, as
    ``jax.tree.map`` does in JAX's ``cfg_eps``; tensor-valued conds are
    ``torch.cat`` of [uncond, cond], bit for bit, as before."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    t = np.array([7, 7], np.int32)
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    c = {"c": arr(2, 5), "p": [arr(2, 3, 3, 4), arr(2, 3, 3, 4)]}
    u = {"c": arr(2, 5), "p": [arr(2, 3, 3, 4), arr(2, 3, 3, 4)]}

    def fn(xx, tt, cond, mod):
        return (xx * cond["c"].sum(-1)[:, None, None, None]
                + cond["p"][0] - 2.0 * cond["p"][1])

    ref = jddim.cfg_eps(lambda *a: fn(*a, jnp), jnp.asarray(x),
                        jnp.asarray(t), jax.tree.map(jnp.asarray, c),
                        jax.tree.map(jnp.asarray, u), 7.5)
    tc = {"c": torch.from_numpy(c["c"]), "p": [nchw(p) for p in c["p"]]}
    tu = {"c": torch.from_numpy(u["c"]), "p": [nchw(p) for p in u["p"]]}
    out = tddim.cfg_eps(lambda *a: fn(*a, torch), nchw(x),
                        torch.from_numpy(t), tc, tu, 7.5)
    assert_close(nhwc(out), ref, 1e-6)

    _, _, c_in = tddim.cfg_inputs(nchw(x), torch.from_numpy(t), tc, tu)
    assert torch.equal(c_in["c"], torch.cat([tu["c"], tc["c"]]))
    assert type(c_in["p"]) is list and len(c_in["p"]) == 2
    for got, a, b in zip(c_in["p"], tu["p"], tc["p"]):
        assert torch.equal(got, torch.cat([a, b]))
    with pytest.raises(ValueError, match="differ in length"):
        tddim.cfg_inputs(nchw(x), torch.from_numpy(t),
                         tc, {**tu, "p": tu["p"][:1]})


# --- fgdm_chain_n: the port's own contracts -----------------------------------------

@pytest.fixture(scope="module")
def chain():
    """Three port factors (factor 3 with one extra adapter), a ControlNet
    stage and a VAE, seeded with 0.02 N(0, 1) on every weight."""
    gen = torch.Generator().manual_seed(7)
    sched = builders.sd14_schedule()

    def seeded(m):
        return init_params_(m, gen, 0.02).eval()

    vae = seeded(AutoencoderKL(**VAE_TINY, **F32))
    factors = [LatentDiffusion(seeded(UNetModel(**TINY, num_prompts=n,
                                                **F32)), vae, sched)
               for n in (1, 1, 2)]
    cldm = ControlLDM(seeded(UNetModel(**TINY, use_adapter=False, **F32)),
                      vae, sched, control=seeded(ControlNet(**TINY, **F32)),
                      control_scales=(1.0,) * 5)
    rng = np.random.default_rng(8)
    ctxs = [torch.from_numpy(rng.standard_normal((1, 77, 64)).astype(
        np.float32)) for _ in range(6)]
    return dict(factors=factors, cldm=cldm, ctxs=ctxs)


def run_chain(chain, factors=None, cldm=True, b=1, **kw):
    factors = chain["factors"] if factors is None else factors
    c = [x.expand(b, -1, -1) for x in chain["ctxs"]]
    return tchain.fgdm_chain_n(
        factors, chain["cldm"] if cldm else None, c[:len(factors)], c[3],
        cn_prompt_ctx=c[4], cn_neg_ctx=c[5], cond_hw=COND_HW,
        image_hw=IMAGE_HW, factor_steps=2, f2_steps=2, **kw)


def test_fgdm_chain_n_is_the_composition(chain):
    """With slot seeds: each factor sampled from its per-slot x_T
    (``factor_slot_seeds(s, k + 1)``), prompted by the earlier latents
    (``all_pconds``), decoded once; the render from ``len(factors) + 1``."""
    out = run_chain(chain, slot_seeds=[7], all_pconds=True)
    ctx = chain["ctxs"]
    lat = (1, 4, COND_HW[0] // 8, COND_HW[1] // 8)
    zs, conds = [], []
    with torch.inference_mode():
        for k, ld in enumerate(chain["factors"]):
            cond, uncond = {"c_crossattn": ctx[k]}, {"c_crossattn": ctx[3]}
            if k > 0:
                cond["pcond"] = uncond["pcond"] = zs[-1]
            if k > 1:
                cond["extra_pconds"] = uncond["extra_pconds"] = zs[:-1]
            xt = tddim.slot_noise(tchain.factor_slot_seeds([7], k + 1), lat,
                                  tddim.SLOT_INIT_TAG, "cpu")
            zs.append(tchain._sample_factor_latents(
                ld, lat, cond, uncond, 2, 7.5, 0.0, xt, None, None, "ddim"))
            conds.append(((ld.decode_first_stage(zs[-1]) + 1.0) / 2.0)
                         .clamp(0.0, 1.0))
        hint = tchain.condition_to_hint(conds[-1], IMAGE_HW)
        xt = tddim.slot_noise(tchain.factor_slot_seeds([7], 4),
                              (1, 4) + tuple(s // 8 for s in IMAGE_HW),
                              tddim.SLOT_INIT_TAG, "cpu")
        z_img = tchain.sample_image_factor(chain["cldm"], hint, ctx[4],
                                           ctx[5], num_steps=2, x_T=xt)
        image = chain["cldm"].decode_first_stage(z_img)
    assert len(out["conditions"]) == 3
    for got, ref in zip(out["conditions"], conds):
        assert got.shape == (1, 3) + COND_HW
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(out["image"], image, rtol=0, atol=0)
    assert out["image"].shape == (1, 3) + IMAGE_HW
    assert out["image"].std() > 1e-2
    # without the ControlNet stage there is no image
    assert run_chain(chain, cldm=False, slot_seeds=[7])["image"] is None


@pytest.mark.parametrize("noise", ["slot_seeds", "generator"])
def test_one_factor_chain_n_is_fgdm_chain(chain, noise):
    ld, c = chain["factors"][0], chain["ctxs"]

    def kw():
        return ({"slot_seeds": [5]} if noise == "slot_seeds" else
                {"generator": torch.Generator().manual_seed(5)})

    got = tchain.fgdm_chain_n([ld], chain["cldm"], [c[0]], c[3],
                              cn_prompt_ctx=c[4], cn_neg_ctx=c[5],
                              cond_hw=COND_HW, image_hw=IMAGE_HW,
                              factor_steps=2, f2_steps=2, **kw())
    ref = tchain.fgdm_chain(ld, chain["cldm"], c[0], c[3], c[4], c[5],
                            cond_hw=COND_HW, image_hw=IMAGE_HW, f1_steps=2,
                            f2_steps=2, **kw())
    torch.testing.assert_close(got["conditions"][0], ref["condition"],
                               rtol=0, atol=0)
    torch.testing.assert_close(got["image"], ref["image"], rtol=0, atol=0)


def test_chain_n_permuted_slots_give_permuted_outputs(chain):
    """Per-slot streams across every factor and the render: the same batch
    with its slots swapped gives the swapped outputs, bit for bit
    (``tests/test_controlnet.py:312-345``)."""
    a = run_chain(chain, b=2, slot_seeds=[3, 9], all_pconds=True)
    p = run_chain(chain, b=2, slot_seeds=[9, 3], all_pconds=True)
    for x, y in zip(a["conditions"] + [a["image"]],
                    p["conditions"] + [p["image"]]):
        torch.testing.assert_close(x.flip(0), y, rtol=0, atol=0)
    assert (a["image"][0] - a["image"][1]).abs().max() > 1e-2


def test_factor_2_changes_with_factor_1s_weights(chain):
    """The chain conditions on the previous factor: new weights for factor
    1 change factor 2's map (``tests/test_controlnet.py:259-309``)."""
    f1 = chain["factors"][0]
    unet = UNetModel(**TINY, **F32)
    unet.load_state_dict(f1.unet.state_dict())
    with torch.no_grad():
        g = torch.Generator().manual_seed(9)
        for p in unet.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    other = [LatentDiffusion(unet.eval(), f1.vae, f1.schedule)] + chain[
        "factors"][1:2]
    a = run_chain(chain, chain["factors"][:2], cldm=False, slot_seeds=[4])
    b = run_chain(chain, other, cldm=False, slot_seeds=[4])
    assert (a["conditions"][1] - b["conditions"][1]).abs().max() > 1e-3


def test_chain_n_refusals(chain):
    with pytest.raises(ValueError, match="slot_seeds or a generator"):
        run_chain(chain)
    with pytest.raises(ValueError, match="one prompt context per factor"):
        tchain.fgdm_chain_n(chain["factors"], None, chain["ctxs"][:2],
                            chain["ctxs"][3], slot_seeds=[1])
