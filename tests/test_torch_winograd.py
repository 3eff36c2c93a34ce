"""The port's Winograd F(2x2, 3x3) conv (``fgdm_tpu_torch/kernels/
winograd.py``) held against the JAX package's ``conv3x3_winograd`` on the
CPU, with its gate, its dispatch inside ``Conv2d`` behind
``FGDM_WINOGRAD_CONV`` and one tiny chain with the flag on.

Inputs are numpy-seeded; the port reads NCHW/OIHW, JAX NHWC/HWIO, so each
side gets the transposed copy.  float32: the port within 2e-4 of JAX's
Winograd and of the direct conv (JAX's own bound, ``tests/test_winograd.
py``).  bf16: both compute the transforms and contractions in float32 on
the CPU and round the output once, so they agree to one bf16 step (2^-8
relative) of the output's largest magnitude.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import fgdm_tpu.nn.layers as jl  # noqa: E402
from fgdm_tpu.kernels import winograd as jw  # noqa: E402
from fgdm_tpu_torch.kernels import conv as kconv  # noqa: E402
from fgdm_tpu_torch.kernels import winograd as tw  # noqa: E402
from fgdm_tpu_torch.nn import layers as tl  # noqa: E402

torch.set_num_threads(2)
TOL = 2e-4


def _case(h, w, c, co, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, c, h, w)).astype(np.float32)
    wt = (rng.standard_normal((co, c, 3, 3)) * 0.05).astype(np.float32)
    b = rng.standard_normal((co,)).astype(np.float32)
    return x, wt, b


_jw_conv = jax.jit(jw.conv3x3_winograd)   # one compile, not one an op


def _jax(x, wt, b, dtype=jnp.float32):
    out = _jw_conv(jnp.asarray(x.transpose(0, 2, 3, 1), dtype),
                   jnp.asarray(wt.transpose(2, 3, 1, 0), dtype),
                   jnp.asarray(b, dtype))
    return np.asarray(out.astype(jnp.float32)).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("h,w_len,c,co", [
    (16, 16, 64, 64),
    (8, 8, 128, 64),      # small even
    (15, 17, 64, 128),    # odd sizes exercise the crop path
    (32, 32, 320, 320),   # UNet hot shape
])
def test_winograd_matches_jax_f32(h, w_len, c, co):
    x, wt, b = _case(h, w_len, c, co)
    assert tw.winograd_ok(x.shape, wt.shape)
    got = tw.conv3x3_winograd(torch.from_numpy(x), torch.from_numpy(wt),
                              torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (2, co, h, w_len)
    ref = _jax(x, wt, b)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    direct = F.conv2d(torch.from_numpy(x), torch.from_numpy(wt),
                      torch.from_numpy(b), padding=1)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=TOL,
                               atol=TOL)


def test_winograd_bf16_matches_jax():
    x, wt, b = _case(16, 16, 128, 128, seed=1)
    b[:] = 0
    got = tw.conv3x3_winograd(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(wt).bfloat16(),
                              torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    ref = _jax(x, wt, b, jnp.bfloat16)
    scale = np.abs(ref).max()
    assert np.abs(got.float().numpy() - ref).max() <= 2 ** -8 * scale
    direct = F.conv2d(torch.from_numpy(x), torch.from_numpy(wt), padding=1)
    assert (np.abs(got.float().numpy() - direct.numpy()).max()
            / np.abs(direct.numpy()).max()) < 0.03   # JAX's bound


@pytest.mark.parametrize("x_shape,w_shape", [
    ((1, 32, 8, 8), (32, 32, 3, 3)),      # too narrow
    ((1, 64, 8, 8), (64, 64, 1, 1)),      # not 3x3
    ((1, 320, 64, 64), (320, 320, 3, 3)),
    ((1, 64, 65, 8), (64, 64, 3, 3)),     # plane above _MAX_HW
    ((1, 64, 64, 64), (32, 64, 3, 3)),    # too few output channels
])
def test_winograd_gate_matches_jax(x_shape, w_shape):
    n, c, h, w = x_shape
    co, ci, kh, kw = w_shape
    assert tw.winograd_ok(x_shape, w_shape) == jw.winograd_ok(
        (n, h, w, c), (kh, kw, ci, co))


def _count(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_conv2d_dispatch_matches_jax(monkeypatch):
    """``FGDM_WINOGRAD_CONV=1`` routes ``Conv2d``'s 3x3 stride-1 convs with
    a bias through the Winograd path in both packages, on the same
    weights; a 1x1 conv and a narrow one do not take it."""
    x, wt, b = _case(12, 12, 64, 64, seed=2)
    conv = tl.Conv2d(64, 64, 3)
    conv.load_state_dict({"weight": torch.from_numpy(wt),
                          "bias": torch.from_numpy(b)})
    calls = _count(monkeypatch, tw, "conv3x3_winograd")
    monkeypatch.setattr(tl, "_WINOGRAD_CONV", True)
    monkeypatch.setattr(jl, "_WINOGRAD_CONV", True)
    with torch.no_grad():
        got = conv(torch.from_numpy(x))
    assert len(calls) == 1
    jconv = jl.Conv2d(64, kernel_size=3, dtype=jnp.float32)
    jparams = {"params": {"kernel": jnp.asarray(wt.transpose(2, 3, 1, 0)),
                          "bias": jnp.asarray(b)}}
    ref = np.asarray(jax.jit(jconv.apply)(jparams, jnp.asarray(
        x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    with torch.no_grad():
        tl.Conv2d(64, 64, 1, padding=0)(torch.from_numpy(x))
        tl.Conv2d(32, 32, 3)(torch.from_numpy(x[:, :32]))
    assert len(calls) == 1
    monkeypatch.setattr(tl, "_WINOGRAD_CONV", False)
    with torch.no_grad():
        off = conv(torch.from_numpy(x))
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), off.numpy(), rtol=TOL, atol=TOL)


def test_conv_kernel_gate_comes_first(monkeypatch):
    """With both flags on, a bf16 or float32 conv that K7's gate admits
    takes K7 (the order of ``fgdm_tpu/nn/layers.py:158-181``); one that
    K7's gate refuses (fewer than 128 channels) and Winograd's admits takes
    Winograd."""
    k7 = _count(monkeypatch, kconv, "conv3x3")
    wino = _count(monkeypatch, tw, "conv3x3_winograd")
    monkeypatch.setattr(tl, "_PALLAS_CONV", True)
    monkeypatch.setattr(tl, "_WINOGRAD_CONV", True)
    x = torch.from_numpy(_case(16, 16, 320, 320, seed=3)[0])
    with torch.no_grad():
        tl.Conv2d(320, 320, 3, dtype=torch.bfloat16)(x)
        assert (len(k7), len(wino)) == (1, 0)
        tl.Conv2d(320, 320, 3, dtype=torch.float32)(x)
        assert (len(k7), len(wino)) == (2, 0)
        tl.Conv2d(64, 64, 3, dtype=torch.float32)(x[:, :64])
        assert (len(k7), len(wino)) == (2, 1)


def test_tiny_chain_with_winograd_close_to_direct(monkeypatch):
    """The tiny seg -> image chain with the flag on stays within JAX's
    whole-chain bound (5e-3, ``tests/test_winograd.py``) of the chain with
    the flag off, and the flag reaches the UNets' ResBlock convs
    (``model_channels=64`` puts them over the 64-channel gate)."""
    from fgdm_tpu_torch import builders
    from fgdm_tpu_torch.diffusion.control import ControlLDM
    from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion
    from fgdm_tpu_torch.models.autoencoder import AutoencoderKL
    from fgdm_tpu_torch.models.controlnet import ControlNet
    from fgdm_tpu_torch.models.unet import UNetModel
    from fgdm_tpu_torch.sampling.chain import fgdm_chain

    kw = dict(model_channels=64, num_heads=4, context_dim=64,
              channel_mult=(1, 2), attention_resolutions=(1, 2),
              num_res_blocks=1, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)

    def seeded(m):
        return tl.init_params_(m, gen, perturb=0.02).eval()

    vae = seeded(AutoencoderKL(ch=64, ch_mult=(1, 2, 4, 4), num_res_blocks=1,
                               resolution=64, dtype=torch.float32,
                               device="cpu"))
    sched = builders.sd14_schedule()
    ld = LatentDiffusion(seeded(UNetModel(**kw)), vae, sched)
    cldm = ControlLDM(seeded(UNetModel(**kw, use_adapter=False)), vae, sched,
                      control=seeded(ControlNet(**kw)),
                      control_scales=(1.0,) * 5)
    rng = np.random.default_rng(4)
    ctxs = [torch.from_numpy(rng.standard_normal((1, 77, 64)).astype(
        np.float32) * s) for s in (1.0, 0.1, 1.0, 0.1)]
    calls = _count(monkeypatch, tw, "conv3x3_winograd")

    def run(flag):
        monkeypatch.setattr(tl, "_WINOGRAD_CONV", flag)
        with torch.inference_mode():
            return fgdm_chain(ld, cldm, *ctxs, cond_hw=(64, 64),
                              image_hw=(64, 64), f1_steps=3, f2_steps=2,
                              slot_seeds=[7])

    ref = run(False)
    assert not calls
    got = run(True)
    assert calls
    for k in ("condition", "image"):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=5e-3, atol=5e-3)
    assert float(got["image"].std()) > 1e-4
