"""The port's direct 3x3 conv (K7's module), its gates and the conv-gated
UNet held against the JAX package.

On the CPU ``conv3x3`` takes the plain version ``conv3x3_ref``; it is held
against JAX's ``_xla_conv3x3`` and against the Pallas kernel in interpret
mode through both of its callers (``_conv3x3_fwd``, ``_conv3x3_slab_fwd``),
at the smallest shapes of ``tests/test_conv_kernel.py``.  The CUDA kernel
itself is checked on the card by ``chip_smoke.py``.

Tolerances: forward 2e-4 (float32 both sides, ``test_conv_kernel.py``'s);
``Conv3x3`` gradients against ``jax.vjp(conv3x3)`` 1e-4 for dx and db, 1e-3
for dw (a sum over N*H*W products); the conv-gated UNet 1e-4 * max(1,
max|ref|) in float32, as the other whole-model tests, and 3e-2 * max(1,
max|ref|) in bf16.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.kernels.conv as kc  # noqa: E402
import fgdm_tpu.nn.layers as jlayers  # noqa: E402
from fgdm_tpu.models.unet import UNetModel as JUNetModel  # noqa: E402
from fgdm_tpu_torch.checkpoint import convert  # noqa: E402
from fgdm_tpu_torch.kernels import conv as tc  # noqa: E402
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL  # noqa: E402
from fgdm_tpu_torch.models.controlnet import ControlNet  # noqa: E402
from fgdm_tpu_torch.models.unet import UNetModel  # noqa: E402
from fgdm_tpu_torch.nn import layers as tlayers  # noqa: E402

torch.set_num_threads(2)

TOL = 2e-4


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w_hwio, np.float32), (3, 2, 0, 1))))


def _inputs(rng, n, h, c, co, wscale=0.05):
    x = rng.standard_normal((n, h, h, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, co)) * wscale).astype(np.float32)
    b = rng.standard_normal((co,)).astype(np.float32)
    return x, w, b


# --- the plain version against JAX -----------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3x3_ref_matches_xla_conv(dtype):
    x, w, b = _inputs(np.random.default_rng(0), 2, 9, 16, 24)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = kc._xla_conv3x3(jnp.asarray(x, jd), jnp.asarray(w, jd),
                          jnp.asarray(b))
    out = tc.conv3x3_ref(nchw(x).to(td), oihw(w), torch.from_numpy(b))
    assert out.dtype == td and out.shape == (2, 24, 9, 9)
    # bf16: both round the same f32 sum once (w rounded to bf16 first)
    tol = TOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(nhwc(out), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("caller,h,c,co", [
    ("whole", 16, 128, 128),   # _conv3x3_fwd, the smallest whole plane
    ("slab", 128, 128, 128),   # _conv3x3_slab_fwd, forces s > 1 slabs
])
def test_conv3x3_matches_pallas_interpret(monkeypatch, caller, h, c, co):
    monkeypatch.setattr(kc, "_INTERPRET", True)
    x, w, b = _inputs(np.random.default_rng(1), 1, h, c, co)
    if caller == "whole":
        assert kc.conv3x3_ok(x.shape, w.shape, jnp.float32)
        ref = kc._conv3x3_fwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    else:
        assert kc._pick_slabs(h, h, c, co, 4) is not None
        ref = kc._conv3x3_slab_fwd(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b))
    out = tc.conv3x3(nchw(x), oihw(w), torch.from_numpy(b))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_cpu_wrappers_take_the_plain_version():
    x, w, b = _inputs(np.random.default_rng(2), 1, 8, 8, 16)
    args = (nchw(x), oihw(w), torch.from_numpy(b))
    ref = tc.conv3x3_ref(*args)
    before = sum(tc.conv3x3_kernel.launches.values())
    for fn in (tc.conv3x3, tc.conv3x3_kernel):
        torch.testing.assert_close(fn(*args), ref, rtol=0, atol=0)
    assert sum(tc.conv3x3_kernel.launches.values()) == before


# --- the gradient ----------------------------------------------------------

@pytest.mark.parametrize("n,h,c,co,interpret", [(2, 8, 16, 16, False),
                                                (1, 16, 128, 128, True)])
def test_conv3x3_function_grads_match_jax_vjp(monkeypatch, n, h, c, co,
                                              interpret):
    """``Conv3x3``'s backward equals the custom VJP of ``kc.conv3x3``
    (at 16^2 x 128 JAX's forward is the Pallas kernel in interpret mode)."""
    monkeypatch.setattr(kc, "_INTERPRET", interpret)
    rng = np.random.default_rng(3)
    x, w, b = _inputs(rng, n, h, c, co, wscale=0.1)
    g = rng.standard_normal((n, h, h, co)).astype(np.float32)
    jy, vjp = jax.vjp(kc.conv3x3, jnp.asarray(x), jnp.asarray(w),
                      jnp.asarray(b))
    rdx, rdw, rdb = vjp(jnp.asarray(g))
    xt, wt, bt = (t.requires_grad_() for t in (nchw(x), oihw(w),
                                               torch.from_numpy(b)))
    y = tc.Conv3x3.apply(xt, wt, bt)
    assert type(y.grad_fn).__name__ == "Conv3x3Backward"
    np.testing.assert_allclose(nhwc(y), np.asarray(jy), rtol=TOL, atol=TOL)
    dx, dw, db = torch.autograd.grad(y, (xt, wt, bt), nchw(g))
    np.testing.assert_allclose(nhwc(dx), np.asarray(rdx), atol=1e-4)
    np.testing.assert_allclose(
        dw.numpy(), np.transpose(np.asarray(rdw), (3, 2, 0, 1)), atol=1e-3)
    np.testing.assert_allclose(db.numpy(), np.asarray(rdb), atol=1e-4)


def test_conv3x3_function_bf16_grad_dtypes():
    """In bf16, dx comes back in x's dtype, dw rounded to bf16 and then in
    the f32 parameter's dtype, db in f32 (``conv.py:308-326``)."""
    x, w, b = _inputs(np.random.default_rng(4), 1, 8, 16, 16)
    xt = nchw(x).to(torch.bfloat16).requires_grad_()
    wt, bt = oihw(w).requires_grad_(), torch.from_numpy(b).requires_grad_()
    y = tc.Conv3x3.apply(xt, wt, bt)
    dx, dw, db = torch.autograd.grad(y, (xt, wt, bt), torch.ones_like(y))
    assert (dx.dtype, dw.dtype, db.dtype) == (torch.bfloat16, torch.float32,
                                              torch.float32)
    assert torch.equal(dw, dw.to(torch.bfloat16).float())


# --- gates -----------------------------------------------------------------

# (x NHWC, w HWIO) of tests/test_conv_kernel.py:67-100
GATE_CASES = [
    ((8, 64, 64, 320), (3, 3, 320, 320)), ((8, 32, 32, 640), (3, 3, 640, 640)),
    ((4, 256, 256, 512), (3, 3, 512, 256)), ((4, 64, 64, 512),
                                             (3, 3, 512, 512)),
    ((4, 512, 512, 256), (3, 3, 256, 128)), ((4, 512, 512, 128),
                                             (3, 3, 128, 128)),
    ((1, 1024, 1024, 128), (3, 3, 128, 128)), ((1, 512, 512, 128),
                                               (3, 3, 128, 128)),
    ((1, 64, 64, 320), (1, 1, 320, 320)), ((8, 16, 16, 1280),
                                           (3, 3, 1280, 1280)),
    ((8, 32, 32, 960), (3, 3, 960, 640)),
]


def _port_shapes(xs, ws):
    return ((xs[0], xs[3], xs[1], xs[2]), (ws[3], ws[2], ws[0], ws[1]))


@pytest.mark.parametrize("xs,ws", GATE_CASES)
def test_gates_match_jax(monkeypatch, xs, ws):
    monkeypatch.setattr(kc, "_on_tpu", lambda: True)
    px, pw = _port_shapes(xs, ws)
    bf16 = torch.bfloat16
    assert tc.conv3x3_ok(px, pw, bf16) == kc.conv3x3_ok(xs, ws, jnp.bfloat16)
    assert tc.conv3x3_vae_ok(px, pw, bf16) == kc.conv3x3_vae_ok(
        xs, ws, jnp.bfloat16)
    # K7 reads bf16 only: a float32 conv keeps F.conv2d, where JAX's gate
    # may send it to its Pallas kernel
    assert not tc.conv3x3_ok(px, pw, torch.float32)
    assert not tc.conv3x3_vae_ok(px, pw, torch.float32)


def _served_chain_conv_shapes():
    """Every 3x3 stride-1 conv with a bias of the served chain at batch 4
    (batch 8 through the CFG-doubled UNets), enumerated on the meta
    device: ``{(x NCHW, w OIHW)}``."""
    seen = set()
    orig = tlayers.Conv2d.forward

    def record(self, x):
        if (self.weight.shape[2:] == (3, 3) and self.stride == 1
                and self.padding == 1 and self.bias is not None):
            seen.add((tuple(x.shape), tuple(self.weight.shape)))
        return orig(self, x)

    dev, t = "meta", torch.zeros(8, device="meta")
    ctx = torch.zeros(8, 77, 768, device=dev)
    tlayers.Conv2d.forward = record
    try:
        with torch.no_grad():
            UNetModel(device=dev)(torch.zeros(8, 4, 32, 32, device=dev), t,
                                  context=ctx)
            control = ControlNet(device=dev)(
                torch.zeros(8, 4, 64, 64, device=dev),
                torch.zeros(8, 3, 512, 512, device=dev), t, ctx)
            UNetModel(device=dev, use_adapter=False)(
                torch.zeros(8, 4, 64, 64, device=dev), t, context=ctx,
                control=control, adapter_on=False)
            vae = AutoencoderKL(device=dev)
            for hw in (32, 64):
                vae.decode(torch.zeros(4, 4, hw, hw, device=dev))
    finally:
        tlayers.Conv2d.forward = orig
    return seen


# the served chain's convs that take K7 on the card but the XLA conv on the
# TPU, where JAX's VMEM fit model (dropped by the port) rejects them
PORT_ONLY_SHAPES = {
    ((8, 960, 32, 32), (320, 960, 3, 3)),      # f1 UNet up-block, 32^2
    ((8, 2560, 16, 16), (1280, 2560, 3, 3)),   # f2 UNet up-blocks, 16^2
    ((8, 1920, 32, 32), (640, 1920, 3, 3)),    # f2 UNet up-blocks, 32^2
    ((8, 640, 64, 64), (640, 640, 3, 3)),      # f2 UNet upsample conv
    ((8, 960, 64, 64), (320, 960, 3, 3)),      # f2 UNet up-blocks, 64^2
    ((8, 640, 64, 64), (320, 640, 3, 3)),
}


def test_port_gate_is_a_superset_of_jax_on_the_served_chain(monkeypatch):
    monkeypatch.setattr(kc, "_on_tpu", lambda: True)
    shapes = _served_chain_conv_shapes()
    assert len(shapes) > 40
    port_only, both = set(), 0
    for xs, ws in shapes:
        n, c, h, w = xs
        jx, jw = (n, h, w, c), (3, 3, c, ws[0])
        j = (kc.conv3x3_ok(jx, jw, jnp.bfloat16),
             kc.conv3x3_vae_ok(jx, jw, jnp.bfloat16))
        p = (tc.conv3x3_ok(xs, ws, torch.bfloat16),
             tc.conv3x3_vae_ok(xs, ws, torch.bfloat16))
        assert not (j[0] and not p[0]) and j[1] == p[1], (xs, ws, j, p)
        if p[0] and not j[0]:
            port_only.add((xs, ws))
        both += j[0] or j[1]
    assert port_only == PORT_ONLY_SHAPES
    assert both == 20   # distinct shapes where both take the kernel


# --- Conv2d's flags --------------------------------------------------------

def test_conv2d_flags_route_gated_convs_only(monkeypatch):
    calls = []
    real = tc.conv3x3
    monkeypatch.setattr(tc, "conv3x3",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    gen = torch.Generator().manual_seed(0)
    bf16 = torch.bfloat16
    convs = {
        "gated": tlayers.Conv2d(128, 128, 3, dtype=bf16),
        "f32": tlayers.Conv2d(128, 128, 3),   # the gates admit bf16 only
        "stride2": tlayers.Conv2d(128, 128, 3, stride=2, padding=1,
                                  dtype=bf16),
        "1x1": tlayers.Conv2d(128, 128, 1, padding=0, dtype=bf16),
        "narrow": tlayers.Conv2d(64, 128, 3, dtype=bf16),
        "no_bias": tlayers.Conv2d(128, 128, 3, bias=False, dtype=bf16),
    }
    for m in convs.values():
        tlayers.init_params_(m, gen, 0.1)
    x = {k: torch.randn(1, m.weight.shape[1], 16, 16, generator=gen)
         for k, m in convs.items()}
    off = {k: m(x[k]) for k, m in convs.items()}
    assert calls == []
    monkeypatch.setattr(tlayers, "_PALLAS_CONV", True)
    on = {k: m(x[k]) for k, m in convs.items()}
    assert calls == [(1, 128, 16, 16)]
    for k in convs:
        if k != "gated":
            assert torch.equal(on[k], off[k]), k
    g = convs["gated"]
    torch.testing.assert_close(
        on["gated"], tc.conv3x3_ref(x["gated"].to(bf16), g.weight, g.bias),
        rtol=0, atol=0)
    # the VAE flag alone takes only the >= 512^2, 128-channel family
    monkeypatch.setattr(tlayers, "_PALLAS_CONV", False)
    monkeypatch.setattr(tlayers, "_PALLAS_CONV_VAE", True)
    convs["gated"](x["gated"])
    assert len(calls) == 1


def test_conv2d_gated_bf16_adds_the_bias_in_f32(monkeypatch):
    """Flag on, the bias is added to the f32 sum before the one rounding
    (the JAX kernel path); flag off, ``F.conv2d`` adds a bf16 bias."""
    gen = torch.Generator().manual_seed(1)
    m = tlayers.Conv2d(128, 128, 3, dtype=torch.bfloat16)
    tlayers.init_params_(m, gen, 0.0)
    with torch.no_grad():
        m.bias.copy_(torch.randn(128, generator=gen) * 3)
    x = torch.randn(1, 128, 16, 16, generator=gen).to(torch.bfloat16)
    monkeypatch.setattr(tlayers, "_PALLAS_CONV", True)
    with torch.no_grad():
        on = m(x)
    assert on.dtype == torch.bfloat16
    torch.testing.assert_close(on, tc.conv3x3_ref(x, m.weight, m.bias),
                               rtol=0, atol=0)


# --- the conv-gated UNet against JAX ---------------------------------------

# max|d| <= tol * max(1, max|ref|): float32 as the other whole-model tests;
# bf16 8 ulps of 2**-8 (about 4 observed at three seeds), since the two
# packages round their bf16 activations in different places
UNET_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
GATED = dict(model_channels=128, num_heads=4, context_dim=64,
             channel_mult=(1, 2), attention_resolutions=(1, 2),
             num_res_blocks=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_gated_unet_matches_jax(monkeypatch, dtype):
    """Flags on in both packages (JAX's Pallas conv in interpret mode).  In
    bf16 every 3x3 conv at 16^2 with >= 128 channels takes the conv3x3
    path; in float32 the port's gates keep ``F.conv2d`` (K7 reads bf16
    only), which gives the same f32 sum plus f32 bias."""
    monkeypatch.setattr(kc, "_INTERPRET", True)
    monkeypatch.setattr(jlayers, "_PALLAS_CONV", True)
    monkeypatch.setattr(tlayers, "_PALLAS_CONV", True)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    t = np.array([981, 3], np.int32)
    jm = JUNetModel(**GATED, dtype=getattr(jnp, dtype))
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)),
                jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64)))
    p = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), p)
    ref = jax.jit(jm.apply)(p, jnp.asarray(x), jnp.asarray(t),
                            jnp.asarray(ctx))
    tm = UNetModel(**GATED, dtype=getattr(torch, dtype), device="cpu")
    tm.load_state_dict(convert.unet_state_dict(p), strict=True)
    calls = []
    real = tc.conv3x3
    monkeypatch.setattr(tc, "conv3x3",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    with torch.no_grad():
        out = tm.eval()(nchw(x), torch.from_numpy(t).long(),
                        context=torch.from_numpy(ctx))
    if dtype == "float32":
        assert calls == []
    else:
        assert len(calls) >= 5 and all(s[2] == 16 for s in calls)
    ref = np.asarray(ref, np.float32)
    assert np.abs(ref).max() > 1e-2
    err = np.abs(nhwc(out) - ref).max()
    tol = UNET_TOL[dtype] * max(1.0, np.abs(ref).max())
    assert err <= tol, (err, tol)
