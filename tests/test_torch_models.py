"""The port's UNet, ControlNet, VAE and CLIP held against the JAX package.

Tiny geometries of ``tests/test_golden_chain.py:38-43``, float32, on the CPU.
Flax params (the port's seeded init with 0.02 N(0, 1) on every parameter,
so zero-init heads do work, read into flax by the JAX ingest against
flax's abstract init: ``test_torch_train.ingested``) go through
``fgdm_tpu_torch.checkpoint.convert`` into the port with ``strict=True``;
inputs come from ``np.random.default_rng``.

Tolerance: max |port - jax| <= 1e-4 * max(1, max |jax|) for a whole model
(float32 on both sides; the sums run in another order).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from fgdm_tpu.checkpoint.torch_export import (export_clip,  # noqa: E402
                                              export_controlnet, export_unet,
                                              export_vae)
from fgdm_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL  # noqa: E402
from fgdm_tpu.models.clip import CLIPTextEncoder as JCLIPTextEncoder  # noqa: E402
from fgdm_tpu.models.clip import CLIPTokenizer as JCLIPTokenizer  # noqa: E402
from fgdm_tpu.models.controlnet import ControlNet as JControlNet  # noqa: E402
from fgdm_tpu.models.controlnet import guess_mode_scales as j_guess_scales  # noqa: E402
from fgdm_tpu.models.unet import UNetModel as JUNetModel  # noqa: E402
from fgdm_tpu_torch.checkpoint import convert  # noqa: E402
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL  # noqa: E402
from fgdm_tpu_torch.models.clip import CLIPTextEncoder, CLIPTokenizer  # noqa: E402
from fgdm_tpu_torch.models.controlnet import (ControlNet,  # noqa: E402
                                              guess_mode_scales)
from fgdm_tpu_torch.models.unet import UNetModel  # noqa: E402
from test_torch_train import ingested  # noqa: E402

torch.set_num_threads(2)

TINY = dict(model_channels=32, num_heads=4, context_dim=64,
            channel_mult=(1, 2), attention_resolutions=(1, 2),
            num_res_blocks=1)
VAE_TINY = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1, resolution=64,
                z_channels=4, embed_dim=4)
CLIP_TINY = dict(vocab_size=128, embed_dim=64, num_layers=2, num_heads=4)
TOL = 1e-4


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def assert_close(port, ref, tol=TOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def adapter_key(k):
    # the port names an Adapter block's channel-changing conv as the
    # reference does (in_conv); torch_export writes in_layers.2
    return k.replace(".in_layers.2.", ".in_conv.") if k.startswith(
        "adapter.") else k


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return dict(
        x=rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
        t=np.array([3, 811], np.int32),
        ctx=rng.standard_normal((2, 77, 64)).astype(np.float32),
        pcond=rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
        hint=rng.random((2, 64, 64, 3)).astype(np.float32),
    )


def _init_unet(use_adapter, seed):
    jm = JUNetModel(**TINY, use_adapter=use_adapter, dtype=jnp.float32)
    tm = UNetModel(**TINY, use_adapter=use_adapter, dtype=torch.float32,
                   device="cpu")
    p = ingested("unet", tm, seed, jm, jnp.zeros((1, 8, 8, 4)),
                 jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64)))
    tm.load_state_dict(convert.unet_state_dict(p), strict=True)
    return jm, p, tm.eval()


@pytest.fixture(scope="module")
def unets():
    return {True: _init_unet(True, 1), False: _init_unet(False, 2)}


@pytest.fixture(scope="module")
def controlnet():
    jm = JControlNet(**TINY, dtype=jnp.float32)
    tm = ControlNet(**TINY, dtype=torch.float32, device="cpu")
    p = ingested("cn", tm, 3, jm, jnp.zeros((1, 8, 8, 4)),
                 jnp.zeros((1, 64, 64, 3)), jnp.zeros((1,), jnp.int32),
                 jnp.zeros((1, 77, 64)))
    tm.load_state_dict(convert.controlnet_state_dict(p), strict=True)
    return jm, p, tm.eval()


@pytest.mark.parametrize("use_adapter", [True, False])
def test_unet_keys_match_export(unets, use_adapter):
    _, p, tm = unets[use_adapter]
    exported = {adapter_key(k) for k in export_unet(p, prefix="")}
    ported = convert.unet_state_dict(p)
    assert set(tm.state_dict()) == exported == set(ported)
    assert len(ported) == len(jax.tree.leaves(p))
    for k, v in export_unet(p, prefix="").items():
        np.testing.assert_array_equal(ported[adapter_key(k)].numpy(), v)


def test_adapter_in_conv_is_reference_name(unets):
    keys = set(unets[True][2].state_dict())
    assert "adapter.body.2.in_conv.weight" in keys
    assert not any("adapter" in k and "in_layers" in k for k in keys)


@pytest.mark.parametrize("case", ["adapter", "adapter_pcond", "adapter_off",
                                  "no_adapter", "control", "control_mid"])
def test_unet_forward_matches_jax(unets, controlnet, inputs, case):
    use_adapter = case.startswith("adapter")
    jm, p, tm = unets[use_adapter]
    kw_j, kw_t = {}, {}
    if case == "adapter_pcond":
        kw_j["pcond"] = jnp.asarray(inputs["pcond"])
        kw_t["pcond"] = nchw(inputs["pcond"])
    if case == "adapter_off":
        kw_j["adapter_on"] = kw_t["adapter_on"] = False
    if case.startswith("control"):
        rng = np.random.default_rng(7)
        shapes = [(2, 8, 8, 32)] * 2 + [(2, 4, 4, 32), (2, 4, 4, 64),
                                          (2, 4, 4, 64)]
        res = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        kw_j["control"] = [jnp.asarray(r) for r in res]
        kw_t["control"] = [nchw(r) for r in res]
        kw_j["only_mid_control"] = kw_t["only_mid_control"] = (
            case == "control_mid")
    ref = jm.apply(p, jnp.asarray(inputs["x"]), jnp.asarray(inputs["t"]),
                   jnp.asarray(inputs["ctx"]), **kw_j)
    with torch.no_grad():
        out = tm(nchw(inputs["x"]), torch.from_numpy(inputs["t"]),
                 context=torch.from_numpy(inputs["ctx"]), **kw_t)
    assert out.dtype == torch.float32
    assert_close(nhwc(out), ref)


def test_unet_fused_norm_matches_jax(inputs):
    """fused_norm_silu=True on both sides (the plain versions on the CPU)."""
    jm = JUNetModel(**TINY, fused_norm_silu=True, dtype=jnp.float32)
    tm = UNetModel(**TINY, fused_norm_silu=True, dtype=torch.float32,
                   device="cpu")
    p = ingested("unet", tm, 4, jm, jnp.zeros((1, 8, 8, 4)),
                 jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64)))
    tm.load_state_dict(convert.unet_state_dict(p), strict=True)
    ref = jm.apply(p, jnp.asarray(inputs["x"]), jnp.asarray(inputs["t"]),
                   jnp.asarray(inputs["ctx"]))
    with torch.no_grad():
        out = tm(nchw(inputs["x"]), torch.from_numpy(inputs["t"]),
                 context=torch.from_numpy(inputs["ctx"]))
    assert_close(nhwc(out), ref)


def test_controlnet_keys_match_export(controlnet):
    _, p, tm = controlnet
    exported = export_controlnet(p, prefix="")
    ported = convert.controlnet_state_dict(p)
    assert set(tm.state_dict()) == set(exported) == set(ported)
    assert len(ported) == len(jax.tree.leaves(p))


@pytest.mark.parametrize("mode", ["hint", "hint_emb", "hint_only"])
def test_controlnet_matches_jax(controlnet, inputs, mode):
    jm, p, tm = controlnet
    x, t, ctx = inputs["x"], inputs["t"], inputs["ctx"]
    hint = inputs["hint"]
    jhint = jnp.asarray(hint)
    if mode == "hint_only":
        ref = jm.apply(p, None, jhint, None, None, hint_only=True)
        with torch.no_grad():
            out = tm(None, nchw(hint), None, None, hint_only=True)
        assert_close(nhwc(out), ref)
        return
    kw_j, kw_t = {}, {}
    if mode == "hint_emb":
        emb = jm.apply(p, None, jhint, None, None, hint_only=True)
        kw_j["hint_emb"], kw_t["hint_emb"] = emb, nchw(emb)
        jhint, thint = None, None
    else:
        thint = nchw(hint)
    refs = jm.apply(p, jnp.asarray(x), jhint, jnp.asarray(t),
                    jnp.asarray(ctx), **kw_j)
    with torch.no_grad():
        outs = tm(nchw(x), thint, torch.from_numpy(t),
                  torch.from_numpy(ctx), **kw_t)
    assert len(outs) == len(refs) == 5
    for o, r in zip(outs, refs):
        assert_close(nhwc(o), r)


@pytest.mark.parametrize("strength", [1.0, 0.6])
def test_guess_mode_scales_match_jax(strength):
    np.testing.assert_allclose(guess_mode_scales(strength),
                               np.asarray(j_guess_scales(strength)), rtol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_vae_decoder_matches_jax(fused):
    jm = JAutoencoderKL(**VAE_TINY, fused_norm=fused, dtype=jnp.float32)
    tm = AutoencoderKL(**VAE_TINY, fused_norm=fused, dtype=torch.float32,
                       device="cpu")
    p = ingested("vae", tm, 5, jm, jnp.zeros((1, 64, 64, 3)),
                 sample_posterior=False)
    sd = convert.vae_state_dict(p)
    tm.load_state_dict(sd, strict=True)
    exported = export_vae(p, prefix="")
    assert set(sd) == set(tm.state_dict()) == set(exported)
    assert len(sd) == len(jax.tree.leaves(p))
    for k, v in exported.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)

    z = np.random.default_rng(6).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    from fgdm_tpu.models.autoencoder import AutoencoderKL as J

    ref = jm.apply(p, jnp.asarray(z), method=J.decode)
    with torch.no_grad():
        out = tm.decode(nchw(z))
    assert out.shape == (2, 3, 64, 64)
    assert_close(nhwc(out), ref)


@pytest.fixture(scope="module")
def vae_pair():
    jm = JAutoencoderKL(**VAE_TINY, dtype=jnp.float32)
    p = ingested("vae", AutoencoderKL(**VAE_TINY, dtype=torch.float32,
                                      device="cpu"), 8, jm,
                 jnp.zeros((1, 64, 64, 3)), sample_posterior=False)
    return jm, p


@pytest.mark.parametrize("fused", [False, True])
def test_vae_encoder_matches_jax(vae_pair, fused):
    """``encode``: the posterior's mean and logvar, and a sample with an
    injected eps, against ``AutoencoderKL.encode`` + ``sample``."""
    _, p = vae_pair
    jm = JAutoencoderKL(**VAE_TINY, fused_norm=fused, dtype=jnp.float32)
    tm = AutoencoderKL(**VAE_TINY, fused_norm=fused, dtype=torch.float32,
                       device="cpu")
    tm.load_state_dict(convert.vae_state_dict(p), strict=True)
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    eps = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    from fgdm_tpu.models.autoencoder import AutoencoderKL as J

    post = jm.apply(p, jnp.asarray(x), method=J.encode)
    with torch.no_grad():
        tpost = tm.encode(nchw(x))
        sample = tpost.sample(eps=nchw(eps))
    assert tpost.mean.shape == (2, 4, 8, 8)
    assert_close(nhwc(tpost.mean), post.mean)
    assert_close(nhwc(tpost.logvar), post.logvar)
    assert_close(nhwc(sample), post.mean + post.std * jnp.asarray(eps))
    assert_close(tpost.kl().numpy(), post.kl())
    assert torch.equal(tpost.mode(), tpost.mean)


@pytest.fixture(scope="module")
def clip_pair():
    jm = JCLIPTextEncoder(**CLIP_TINY)
    tm = CLIPTextEncoder(**CLIP_TINY, device="cpu")
    p = ingested("clip", tm, 10, jm, jnp.zeros((1, 77), jnp.int32))
    sd = convert.clip_state_dict(p)
    tm.load_state_dict(sd, strict=True)
    return jm, p, tm, sd


def test_clip_keys_match_export(clip_pair):
    _, p, tm, sd = clip_pair
    exported = export_clip(p, prefix="")
    assert set(tm.state_dict()) == set(sd) == set(exported)
    assert len(sd) == len(jax.tree.leaves(p))
    for k, v in exported.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)


@pytest.mark.parametrize("n", [77, 12])
def test_clip_text_encoder_matches_jax(clip_pair, n):
    jm, p, tm, _ = clip_pair
    ids = np.random.default_rng(11).integers(0, 128, (2, n)).astype(np.int32)
    ref = jm.apply(p, jnp.asarray(ids))
    with torch.no_grad():
        out = tm(torch.from_numpy(ids).long())
    assert out.dtype == torch.float32 and out.shape == (2, n, 64)
    assert_close(out.numpy(), ref)


PROMPTS = ["a photograph of an astronaut riding a horse",
           "Two  dogs &amp; a cat, 3 birds!", "", "ÉLAN vital — naïve café",
           "a " * 100, "it's the dog's toy, isn't it?"]


def test_tokenizer_ids_match_jax(monkeypatch):
    """The hash fallback (no vocabulary in the repo) gives JAX's ids."""
    monkeypatch.delenv("FGDM_CLIP_VOCAB_DIR", raising=False)
    ids = CLIPTokenizer()(PROMPTS)
    ref = JCLIPTokenizer()(PROMPTS)
    assert ids.shape == (len(PROMPTS), 77)
    np.testing.assert_array_equal(ids.numpy(), ref)
    assert not CLIPTokenizer().has_real_vocab


def test_tokenizer_bpe_vocab_matches_jax(tmp_path):
    """With a (toy) vocabulary both tokenizers run the same BPE merges."""
    merges = ["#version: 0.2", "h o", "ho r", "hor s", "hors e</w>", "a </w>"]
    vocab = {tok: i for i, tok in enumerate(
        ["a</w>", "h", "o", "r", "s", "e</w>", "ho", "hor", "hors",
         "horse</w>", "!</w>"])}
    (tmp_path / "merges.txt").write_text("\n".join(merges))
    (tmp_path / "vocab.json").write_text(__import__("json").dumps(vocab))
    texts = ["a horse!", "horses", "A HORSE a horse"]
    ids = CLIPTokenizer(str(tmp_path))(texts)
    ref = JCLIPTokenizer(str(tmp_path))(texts)
    np.testing.assert_array_equal(ids.numpy(), ref)
    assert CLIPTokenizer(str(tmp_path)).has_real_vocab


def test_tokenizer_check_production(monkeypatch):
    monkeypatch.delenv("FGDM_ALLOW_HASH_TOKENIZER", raising=False)
    with pytest.raises(SystemExit, match="FGDM_CLIP_VOCAB_DIR"):
        CLIPTokenizer().check_production()
    monkeypatch.setenv("FGDM_ALLOW_HASH_TOKENIZER", "1")
    CLIPTokenizer().check_production()


def test_converter_rejects_unknown_paths(unets):
    _, p, _ = unets[True]
    bad = {"params": {**p["params"], "mystery": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(KeyError, match="mystery"):
        convert.unet_state_dict(bad)
