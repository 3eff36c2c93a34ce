"""The port's direct 3x3 conv (K7's module), its gates and the conv-gated
UNet held against the JAX package.

On the CPU ``conv3x3`` takes the plain version ``conv3x3_ref``; it is held
against JAX's ``_xla_conv3x3`` and against the Pallas kernel in interpret
mode through both of its callers (``_conv3x3_fwd``, ``_conv3x3_slab_fwd``),
at the smallest shapes of ``tests/test_conv_kernel.py``.  The CUDA kernel
itself is checked on the card by ``chip_smoke.py``.

The redesigned kernel's host side is held here too: ``conv3x3_taps_ref``
(the kernel's algorithm in plain torch: NHWC input, the packed ``[Co, 9, C]``
weight, zero halo, f32 sum and bias, one rounding) against ``conv3x3_ref``
and JAX's ``_xla_conv3x3``; the weight pack's cache; ``conv3x3_plan`` over
the served chain's shapes and a grid of ragged admitted ones.

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
    # K7 has a bf16 and a float32 kernel: in both dtypes the port's gates
    # take what JAX's take once its VMEM fit, the one use of the dtype
    # there, is lifted (the port drops that TPU residency limit), and a
    # superset of what JAX's take with it (in float32 the fit refuses four
    # of these shapes at 4 bytes an element)
    for td, jd in ((torch.bfloat16, jnp.bfloat16),
                   (torch.float32, jnp.float32)):
        port = (tc.conv3x3_ok(px, pw, td), tc.conv3x3_vae_ok(px, pw, td))
        fit = (kc.conv3x3_ok(xs, ws, jd), kc.conv3x3_vae_ok(xs, ws, jd))
        assert all(p or not j for p, j in zip(port, fit))
        if td == torch.bfloat16:
            assert port == fit
        with monkeypatch.context() as m:
            m.setattr(kc, "_VMEM_BUDGET", 1 << 40)
            assert port == (kc.conv3x3_ok(xs, ws, jd),
                            kc.conv3x3_vae_ok(xs, ws, jd))


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
        "f32": tlayers.Conv2d(128, 128, 3),   # K7's float32 kernel
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
    assert calls == [(1, 128, 16, 16)] * 2
    for k in convs:
        if k not in ("gated", "f32"):
            assert torch.equal(on[k], off[k]), k
    g, f = convs["gated"], convs["f32"]
    torch.testing.assert_close(
        on["gated"], tc.conv3x3_ref(x["gated"].to(bf16), g.weight, g.bias),
        rtol=0, atol=0)
    torch.testing.assert_close(on["f32"], tc.conv3x3_ref(x["f32"], f.weight,
                                                         f.bias),
                               rtol=0, atol=0)
    # the VAE flag alone takes only the >= 512^2, 128-channel family
    monkeypatch.setattr(tlayers, "_PALLAS_CONV", False)
    monkeypatch.setattr(tlayers, "_PALLAS_CONV_VAE", True)
    convs["gated"](x["gated"])
    convs["f32"](x["f32"])
    assert len(calls) == 2


def test_conv2d_flags_hand_the_kernel_a_contiguous_input(monkeypatch):
    """K7 reads a contiguous NCHW plane and its wrapper refuses anything
    else; an input permuted from HWC (a hint read from an image) is
    channels-last strided, and reached the kernel so on the card."""
    seen = []
    real = tc.conv3x3
    monkeypatch.setattr(tc, "conv3x3", lambda x, w, b: seen.append(
        x.is_contiguous()) or real(x, w, b))
    monkeypatch.setattr(tlayers, "_PALLAS_CONV", True)
    gen = torch.Generator().manual_seed(2)
    m = tlayers.init_params_(tlayers.Conv2d(128, 128, 3,
                                            dtype=torch.bfloat16), gen, 0.1)
    hwc = torch.randn(1, 16, 16, 128, generator=gen).to(torch.bfloat16)
    x = hwc.permute(0, 3, 1, 2)
    assert not x.is_contiguous()
    with torch.no_grad():
        out = m(x)
    assert seen == [True]
    torch.testing.assert_close(out, tc.conv3x3_ref(x.contiguous(), m.weight,
                                                   m.bias), rtol=0, atol=0)


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
    bf16 and in float32 every 3x3 conv at 16^2 with >= 128 channels takes
    the conv3x3 path, as in JAX (K7 has a kernel for each dtype)."""
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
    assert len(calls) >= 5 and all(s[2] == 16 for s in calls)
    ref = np.asarray(ref, np.float32)
    assert np.abs(ref).max() > 1e-2
    err = np.abs(nhwc(out) - ref).max()
    tol = UNET_TOL[dtype] * max(1.0, np.abs(ref).max())
    assert err <= tol, (err, tol)


# --- the kernel's algorithm in plain torch ---------------------------------

# (n, h, w, c, co): served-like (whole 16^2 planes, 128 channels and up) and
# ragged (W % 8 != 0, Co % 128 != 0, C % 64 != 0, H != W)
TAPS_CASES = [(2, 9, 9, 16, 24), (1, 16, 16, 128, 128), (2, 16, 16, 320, 128),
              (3, 24, 24, 136, 200), (2, 17, 23, 128, 136),
              (1, 64, 20, 264, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c,co", TAPS_CASES)
def test_conv_by_taps_matches_ref_and_xla(n, h, w, c, co, dtype):
    rng = np.random.default_rng(h * w + c)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, co)) * (9 * c) ** -0.5).astype(
        np.float32)
    b = rng.standard_normal((co,)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    xla = np.asarray(kc._xla_conv3x3(jnp.asarray(x, jd), jnp.asarray(wt, jd),
                                     jnp.asarray(b)), np.float32)
    xt, w_t, b_t = nchw(x).to(td), oihw(wt), torch.from_numpy(b)
    # the pack is in the activations' dtype: bf16 for K7's bf16 kernel,
    # float32 for its float32 one
    wk, bias = tc.pack_weight(w_t, b_t, td)
    assert wk.shape == (co, 9, c) and wk.dtype == td
    assert wk.is_contiguous() and bias.dtype == torch.float32
    # k = (ky*3 + kx)*C + c
    assert torch.equal(wk[:, 5, 7], w_t[:, 7, 1, 2].to(td))
    x_nhwc = tc.nchw_to_nhwc(xt)
    assert x_nhwc.shape == (n, h, w, c) and x_nhwc.is_contiguous()
    out = tc.conv3x3_taps_ref(x_nhwc, wk, bias)
    ref = tc.conv3x3_ref(xt, w_t, b_t)
    assert out.shape == ref.shape == (n, co, h, w) and out.dtype == td
    tol = TOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(nhwc(out), xla, rtol=tol, atol=tol)


# --- the weight pack's cache -----------------------------------------------

def _conv_module():
    m = tlayers.Conv2d(16, 24, 3)
    tlayers.init_params_(m, torch.Generator().manual_seed(0), 0.1)
    return m


def _pack_is_current(m, pack):
    fresh = tc.pack_weight(m.weight, m.bias)
    return torch.equal(pack[0], fresh[0]) and torch.equal(pack[1], fresh[1])


def _add_(p):
    with torch.no_grad():
        p.add_(1.0)


def _optimizer_step(m):
    opt = torch.optim.AdamW(m.parameters(), lr=0.1)
    m(torch.ones(1, 16, 4, 4)).sum().backward()
    opt.step()


def _load_state_dict(m):
    m.load_state_dict({k: v + 1 for k, v in m.state_dict().items()})


@pytest.mark.parametrize("change", [
    lambda m: _add_(m.weight),
    lambda m: _add_(m.bias),
    _optimizer_step,
    _load_state_dict,
], ids=["w.add_", "b.add_", "optimizer.step", "load_state_dict"])
def test_packed_weight_sees_in_place_updates(change):
    m = _conv_module()
    made = tc.packed_weight.packs
    first = tc.packed_weight(m.weight, m.bias)
    again = tc.packed_weight(m.weight, m.bias)
    assert again[0] is first[0] and again[1] is first[1]
    assert tc.packed_weight.packs == made + 1
    change(m)
    assert not _pack_is_current(m, first)
    after = tc.packed_weight(m.weight, m.bias)
    assert after[0] is not first[0]
    assert _pack_is_current(m, after)
    assert tc.packed_weight.packs == made + 2
    # and the conv that follows computes with the new weight
    x = torch.ones(1, 16, 4, 4)
    torch.testing.assert_close(
        tc.conv3x3_taps_ref(tc.nchw_to_nhwc(x), *after),
        tc.conv3x3_ref(x, m.weight.to(torch.bfloat16), m.bias),
        rtol=1e-5, atol=1e-5)


def test_packed_weight_does_not_keep_a_deleted_weight_alive():
    import gc
    import weakref

    m = _conv_module()
    pack = tc.packed_weight(m.weight, m.bias)
    kept = len(tc._PACKS)
    assert tc._PACKS[m.weight][2] is pack[0]
    w_ref, wk_ref = weakref.ref(m.weight), weakref.ref(pack[0])
    del m, pack
    gc.collect()
    assert w_ref() is None and wk_ref() is None
    assert len(tc._PACKS) == kept - 1


def test_packed_weight_frees_the_pack_of_a_changed_weight():
    """A training loop repacks after every step; the packs of the steps
    before must not pile up while the weight lives."""
    import gc
    import weakref

    m = _conv_module()
    olds = []
    for _ in range(3):
        olds.append(weakref.ref(tc.packed_weight(m.weight, m.bias)[0]))
        _add_(m.weight)
    current = tc.packed_weight(m.weight, m.bias)
    gc.collect()
    assert [r() for r in olds] == [None, None, None]
    assert _pack_is_current(m, current)


def test_packed_weight_is_per_tensor_and_per_bias():
    a, b = _conv_module(), _conv_module()
    pa, pb = (tc.packed_weight(m.weight, m.bias) for m in (a, b))
    assert pa[0] is not pb[0]
    other = torch.zeros(24)
    assert tc.packed_weight(a.weight, other)[1] is not pa[1]
    assert torch.equal(tc.packed_weight(a.weight, other)[1], other)


# --- the plan function -----------------------------------------------------

CONV_SHAPES = [  # (N, C, Co, H, W): the served batch's 26, then ragged ones
    (8, 320, 640, 16, 16), (8, 640, 640, 16, 16), (8, 640, 1280, 16, 16),
    (8, 960, 640, 16, 16), (8, 1280, 640, 16, 16), (8, 1280, 1280, 16, 16),
    (8, 1920, 640, 16, 16), (8, 1920, 1280, 16, 16), (8, 2560, 1280, 16, 16),
    (8, 320, 320, 32, 32), (8, 320, 640, 32, 32), (8, 640, 320, 32, 32),
    (8, 640, 640, 32, 32), (8, 960, 320, 32, 32), (8, 960, 640, 32, 32),
    (8, 1280, 640, 32, 32), (8, 1280, 1280, 32, 32), (8, 1920, 640, 32, 32),
    (8, 320, 320, 64, 64), (8, 640, 320, 64, 64), (8, 640, 640, 64, 64),
    (8, 960, 320, 64, 64), (4, 512, 512, 32, 32), (4, 256, 320, 64, 64),
    (4, 512, 512, 64, 64), (4, 128, 128, 512, 512),
    (3, 136, 200, 24, 24), (2, 128, 136, 17, 23), (1, 264, 128, 64, 20),
]
RAGGED_SHAPES = [(n, c, co, h, w)
                 for n in (1, 3) for c in (128, 136) for co in (128, 200, 320)
                 for h, w in ((16, 16), (17, 23), (24, 24), (33, 31),
                              (64, 20), (64, 64))]


def test_plan_cases_are_the_served_chain_shapes():
    """``CONV_SHAPES[:26]`` (the cases below) are the gate-admitted conv
    shapes of the served chain, the keys under which ``chip_smoke.py`` finds
    K7 launched by the served batch."""
    admitted = {(xs[1], ws[0], xs[2], xs[3])
                for xs, ws in _served_chain_conv_shapes()
                if tc.conv3x3_ok(xs, ws, torch.bfloat16)
                or tc.conv3x3_vae_ok(xs, ws, torch.bfloat16)}
    # batch 8 through the CFG-doubled UNets, 4 through the VAE and through
    # the hint encoder (the enumeration runs the hint at 8)
    assert admitted == {s[1:] for s in CONV_SHAPES[:26]}
    assert len(admitted) == 26 and {s[0] for s in CONV_SHAPES[:26]} == {4, 8}
    for n, c, co, h, w in RAGGED_SHAPES + CONV_SHAPES[26:]:
        assert tc.conv3x3_ok((n, c, h, w), (co, c, 3, 3), torch.bfloat16)


@pytest.mark.parametrize("n,c,co,h,w", CONV_SHAPES + RAGGED_SHAPES)
def test_conv3x3_plan(n, c, co, h, w):
    p = tc.conv3x3_plan(n, c, co, h, w)
    assert p.bm in (64, 128) and 1 <= p.th * p.tw <= p.bm
    assert p.tw <= 64 and 2 <= p.wst <= 8
    # shared memory: what one block may have, and the source's formula
    halo = -(-(p.th + 2) * (p.tw + 2) * 128 // 1024) * 1024
    assert p.smem == 2048 + p.wst * 16384 + max(2 * halo,
                                                128 * (p.bm + 8) * 2)
    assert p.smem <= tc.SMEM_MAX == 232448
    # the grid covers every output exactly once
    assert p.grid == (n * p.tiles_y * p.tiles_x, -(-co // 128))
    cover = np.zeros((n, h, w), np.int32)
    for bx in range(p.grid[0]):
        x0 = (bx % p.tiles_x) * p.tw
        r0 = (bx // p.tiles_x % p.tiles_y) * p.th
        img = bx // (p.tiles_x * p.tiles_y)
        assert r0 < h and x0 < w            # no block without an output
        cover[img, r0:r0 + p.th, x0:x0 + p.tw] += 1
    assert (cover == 1).all()
    assert (p.grid[1] - 1) * 128 < co <= p.grid[1] * 128
    # the halo boxes tile the plane: consecutive tiles' rectangles abut, and
    # a box (th + 2) x (tw + 2) from (r0 - 1, x0 - 1) holds all nine taps
    assert p.tiles_y == -(-h // p.th) and p.tiles_x == -(-w // p.tw)
    assert p.th + 2 <= 256 and p.tw + 2 <= 256   # TMA box limits
    # enough blocks for the card wherever the work allows it
    if n * h * w * co >= tc.SMS * 64 * 128:
        assert p.grid[0] * p.grid[1] >= tc.SMS == 132


def test_conv3x3_plan_forced_tile_and_refusal():
    assert tc._tile(8, 320, 320, 64, 64, 64).bm == 64
    assert tc.conv3x3_plan(8, 320, 320, 64, 64).bm == 128
    assert tc.conv3x3_plan(8, 640, 640, 16, 16).bm == 64   # 160 blocks, not 80
