"""``--precision full`` on the card: the float32 flash-attention (K1-K3)
and 3x3-conv (K7) kernels' algorithms, plans and gates, held against the
JAX package on the CPU.

The kernels (``csrc/flash_attn_fwd_f32.cu``, ``csrc/conv3x3_f32.cu``) run
only on the card, where ``chip_smoke.py`` holds them against the float32
plain versions.  Here:

* a plain-torch emulation of each kernel's own algorithm (the flash
  forward's key tiles in order, its online softmax in base 2 and, at
  d = 512, its KV slices merged by the combine pass; the conv's channel
  chunks of 8 and its nine taps within each) is held against JAX's Pallas
  kernels in interpret mode in float32 and against the plain versions;
* on the ``meta`` device, every float32 attention and 3x3 conv of the
  ``--precision full`` chain (run_inference.sh's flags: the CLI's CFG batch
  of 10 through the UNets and the ControlNet, its VAE batch of 5) that the
  gates admit has a valid float32 plan, and ``chip_smoke.py`` holds the
  path's shapes;
* the attention gate takes the same float32 shapes as JAX's (no dtype
  test in either), and the host side's constants are the sources'.

Tolerances: float32 both sides, sums in another order: 1e-5 against the
plain versions; the Pallas kernels 2e-3 (``tests/test_attention.py``'s) for
attention and 2e-4 (``tests/test_conv_kernel.py``'s) for the conv; the lse
1e-5.
"""

import importlib.util
import math
import pathlib
import re
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.kernels.attention as ka  # noqa: E402
import fgdm_tpu.kernels.conv as kc  # noqa: E402
from fgdm_tpu_torch.kernels import _build  # noqa: E402
from fgdm_tpu_torch.kernels import attention as ta  # noqa: E402
from fgdm_tpu_torch.kernels import conv as tc  # noqa: E402
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL  # noqa: E402
from fgdm_tpu_torch.models.controlnet import ControlNet  # noqa: E402
from fgdm_tpu_torch.models.unet import UNetModel  # noqa: E402
from fgdm_tpu_torch.nn import layers as tlayers  # noqa: E402

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def qkv(seed, b, h, nq, nk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, nq, d), (b, h, nk, d), (b, h, nk, d))]


# --- the float32 flash forward's algorithm ---------------------------------

def f32_flash_arithmetic(q, k, v, scale, bn, splits=1):
    """``flash_attn_fwd_f32.cu`` in plain torch: the keys in ``splits``
    slices of whole ``bn``-key tiles; per slice, tile after tile, the
    scores times scale * log2 e, the running maximum and sum in base 2, P
    unnormalised in float32, the output rescaled then P.V added.  One slice
    divides by its sum; several go through ``combine_ref`` as the partials
    go through the combine pass.  Returns the output and the lse."""
    sl = scale * ta._LOG2E
    b, h, nq, d = q.shape
    tiles = k.shape[2] // bn
    per = -(-tiles // splits)
    parts = []
    for s in range(splits):
        m = torch.full((b, h, nq), -math.inf)
        l = torch.zeros(b, h, nq)
        acc = torch.zeros(b, h, nq, d)
        for t in range(s * per, min((s + 1) * per, tiles)):
            kt, vt = k[:, :, t * bn:(t + 1) * bn], v[:, :, t * bn:(t + 1) * bn]
            sc = torch.matmul(q, kt.transpose(2, 3))
            mn = torch.maximum(m, sc.amax(dim=-1) * sl)
            alpha = torch.exp2(m - mn)
            p = torch.exp2(sc * sl - mn[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.matmul(p, vt)
            m = mn
        parts.append((acc, m, l))
    if splits == 1:
        acc, m, l = parts[0]
        return acc / l[..., None], (m + torch.log2(l)) / ta._LOG2E
    return ta.combine_ref(*(torch.stack(x) for x in zip(*parts)),
                          torch.float32)


# (TPU kernel, its jitted caller, B, H, Nq, Nk, d, splits): K1 at a ragged
# and an even query length, K2 and K3 at the VAE's head, one and several
# KV slices
F32_CASES = [
    ("K1", "_flash_attention_t", 1, 2, 520, 1024, 40, 1),
    ("K1", "_flash_attention_t", 1, 2, 512, 512, 80, 1),
    ("K2", "_flash_attention", 1, 1, 512, 512, 512, 1),
    ("K2", "_flash_attention", 1, 1, 512, 512, 512, 4),
    ("K3", "_flash_attention_kv", 1, 1, 256, 1024, 512, 3),
]


@pytest.mark.parametrize(
    "case", F32_CASES, ids=lambda c: f"{c[0]}-d{c[6]}-nq{c[4]}-s{c[7]}")
def test_f32_flash_arithmetic_matches_plain_and_pallas(case, monkeypatch):
    """In float32 the CPU route is ``attention_ref``; the kernel's
    arithmetic (key tiles of the f32 tile, base 2, KV slices and the combine
    pass) agrees with it within 1e-5 and with JAX's Pallas kernel in
    interpret mode within 2e-3; its lse with the plain version's within
    1e-5."""
    _, fn, b, h, nq, nk, d, splits = case
    monkeypatch.setattr(ka, "_INTERPRET", True)
    arrs = qkv(nq + d + splits, b, h, nq, nk, d)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    scale = d ** -0.5
    plan = ta.flash_f32_plan(b * h, nq, nk, d, splits)
    out, lse = ta.flash_attention(q, k, v, scale, return_lse=True,
                                  splits=splits)
    ref, ref_lse = ta.attention_ref(q, k, v, scale, return_lse=True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    emu, emu_lse = f32_flash_arithmetic(q, k, v, scale, plan.bn, splits)
    assert emu.dtype == torch.float32 and emu.shape == (b, h, nq, d)
    np.testing.assert_allclose(emu.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(emu_lse.numpy(), ref_lse.numpy(), atol=1e-5,
                               rtol=0)
    pallas = np.asarray(getattr(ka, fn)(*(jnp.asarray(a) for a in arrs),
                                        scale, block_q=256, block_k=256))
    assert pallas.dtype == np.float32
    np.testing.assert_allclose(emu.numpy(), pallas, atol=2e-3, rtol=0)


def test_f32_combine_cpu_route_keeps_float32():
    q, k, v = (torch.from_numpy(a) for a in qkv(7, 1, 1, 64, 256, 512))
    parts = ta.attention_split_ref(q, k, v, 512 ** -0.5, 4)
    out, lse = ta.flash_combine(*parts, torch.float32)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(),
                               ta.attention_ref(q, k, v, 512 ** -0.5).numpy(),
                               atol=1e-5, rtol=0)


# --- the float32 conv's algorithm ------------------------------------------

def f32_conv_arithmetic(xt, wk, bias):
    """``conv3x3_f32.cu`` in plain torch: xt ``[N, H, W, C]`` (the
    pre-pass's output) and the float32 pack ``[Co, 9, C]``; channel chunks
    of 8 in order, the nine taps of each chunk in order over a zero halo,
    all in float32, the bias added before the one store."""
    n, h, w, c = xt.shape
    xp = torch.nn.functional.pad(xt, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((n, h, w, wk.shape[0]))
    for c0 in range(0, c, 8):
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            acc += (xp[:, ky:ky + h, kx:kx + w, c0:c0 + 8]
                    @ wk[:, tap, c0:c0 + 8].t())
    return (acc + bias).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("caller,n,h,w,c,co", [
    ("whole", 2, 16, 16, 128, 136),    # _conv3x3_fwd, Co % 128 != 0
    ("whole", 1, 16, 24, 136, 128),    # C % 64 != 0, H != W
    ("slab", 1, 128, 128, 128, 128),   # _conv3x3_slab_fwd, slabs
])
def test_f32_conv_arithmetic_matches_plain_and_pallas(caller, n, h, w, c,
                                                      co, monkeypatch):
    """The float32 pack is the K-major weight in float32; the CPU route is
    ``conv3x3_ref``; the kernel's arithmetic (chunks of 8 channels, taps
    within) agrees with it within 1e-5 * max and with JAX's Pallas kernel
    in interpret mode, through the caller the shape takes, within 2e-4."""
    monkeypatch.setattr(kc, "_INTERPRET", True)
    rng = np.random.default_rng(h * w + c)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, co)) * (9 * c) ** -0.5).astype(
        np.float32)
    b = rng.standard_normal((co,)).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    w_t = torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1)))
    b_t = torch.from_numpy(b)
    wk, bias = tc.pack_weight(w_t, b_t, torch.float32)
    assert wk.dtype == torch.float32 and wk.shape == (co, 9, c)
    assert torch.equal(wk[:, 5, 7], w_t[:, 7, 1, 2])   # k = (ky*3 + kx)*C + c
    ref = tc.conv3x3(xt, w_t, b_t)
    assert torch.equal(ref, tc.conv3x3_ref(xt, w_t, b_t))
    emu = f32_conv_arithmetic(tc.nchw_to_nhwc(xt), wk, bias)
    tol = 1e-5 * ref.abs().max().item()
    np.testing.assert_allclose(emu.numpy(), ref.numpy(), atol=tol, rtol=0)
    if caller == "whole":
        assert kc.conv3x3_ok(x.shape, wt.shape, jnp.float32)
        pallas = kc._conv3x3_fwd(jnp.asarray(x), jnp.asarray(wt),
                                 jnp.asarray(b))
    else:
        assert kc._pick_slabs(h, w, c, co, 4) is not None
        pallas = kc._conv3x3_slab_fwd(jnp.asarray(x), jnp.asarray(wt),
                                      jnp.asarray(b))
    pallas = np.asarray(pallas).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(emu.numpy(), pallas, rtol=2e-4, atol=2e-4)


def test_packed_weight_is_made_in_the_conv_dtype():
    """A weight packed for a float32 conv is float32; one packed for bf16
    is bf16; a change of dtype packs anew."""
    m = tlayers.init_params_(tlayers.Conv2d(16, 24, 3),
                             torch.Generator().manual_seed(0), 0.1)
    made = tc.packed_weight.packs
    a = tc.packed_weight(m.weight, m.bias, torch.float32)
    assert a[0].dtype == torch.float32
    assert tc.packed_weight(m.weight, m.bias, torch.float32)[0] is a[0]
    bb = tc.packed_weight(m.weight, m.bias)
    assert bb[0].dtype == torch.bfloat16
    assert tc.packed_weight.packs == made + 2
    assert torch.equal(a[0], m.weight.detach().permute(0, 2, 3, 1).reshape(
        24, 9, 16))


# --- plans for every float32 call of the --precision full chain ------------

def _precision_full_calls():
    """``({(b, h, nq, nk, d)}, {(n, c, co, h, w)})``: the float32 attention
    and 3x3-conv calls (stride 1, bias) of run_inference.sh's chain with
    ``--precision full``, enumerated on the meta device: factor 1's UNet
    (with the adapter) on 32^2 latents at the CFG batch of 10, the
    ControlNet and factor 2's UNet on 64^2 latents at 10, the VAE decoding
    5 latents of 32^2 and 64^2."""
    attn, convs = set(), set()
    gate, fwd = ta.use_flash, tlayers.Conv2d.forward

    def record_attn(q, k):
        assert q.dtype == torch.float32
        attn.add((*q.shape[:3], k.shape[2], q.shape[3]))
        return False

    def record_conv(self, x):
        if (self.weight.shape[2:] == (3, 3) and self.stride == 1
                and self.padding == 1 and self.bias is not None):
            assert self.dtype == torch.float32
            convs.add((x.shape[0], x.shape[1], self.weight.shape[0],
                       *x.shape[2:]))
        return fwd(self, x)

    dev, f32 = "meta", torch.float32
    t = torch.zeros(10, device=dev)
    ctx = torch.zeros(10, 77, 768, device=dev)
    ta.use_flash = record_attn
    tlayers.Conv2d.forward = record_conv
    try:
        with torch.no_grad():
            UNetModel(device=dev, dtype=f32)(
                torch.zeros(10, 4, 32, 32, device=dev), t, context=ctx)
            control = ControlNet(device=dev, dtype=f32)(
                torch.zeros(10, 4, 64, 64, device=dev),
                torch.zeros(10, 3, 512, 512, device=dev), t, ctx)
            UNetModel(device=dev, dtype=f32, use_adapter=False)(
                torch.zeros(10, 4, 64, 64, device=dev), t, context=ctx,
                control=control, adapter_on=False)
            vae = AutoencoderKL(device=dev, dtype=f32)
            for hw in (32, 64):
                vae.decode(torch.zeros(5, 4, hw, hw, device=dev))
    finally:
        ta.use_flash, tlayers.Conv2d.forward = gate, fwd
    return attn, convs


@pytest.fixture(scope="module")
def calls():
    return _precision_full_calls()


def test_every_admitted_f32_attention_has_a_plan(calls):
    attn, _ = calls
    admitted = {s for s in attn if ta.flash_gate(s[2], s[3])}
    # K1 at factor 1's and factor 2's levels, K2 and K3 at the VAE's
    assert admitted == {(10, 8, 1024, 1024, 40), (10, 8, 4096, 4096, 40),
                        (10, 8, 1024, 1024, 80), (5, 1, 1024, 1024, 512),
                        (5, 1, 4096, 4096, 512)}
    for b, h, nq, nk, d in admitted:
        p = ta.flash_f32_plan(b * h, nq, nk, d)
        assert p == ta.f32_tile(b * h, nq, nk, d, p.splits)
        assert nk % p.bn == 0 and p.smem <= ta._SMEM_LIMIT
        assert p.grid[2] == b * h and p.grid[1] == p.splits
        assert (p.grid[0] - 1) * p.bm < nq <= p.grid[0] * p.bm
        assert p.splits == (ta.kv_splits(b * h, nq, nk) if d == 512 else 1)
    # chip_smoke.py holds the path's float32 rows at these shapes
    cs = chip_smoke()
    rows = {(b, h, nq, nk, d) for _, _, b, h, nq, nk, d, _, path, _
            in cs.ATTN_F32_CASES if path == "precision_full"}
    assert rows == admitted
    assert {(b, n, s) for b, n, s, _ in cs.COMBINE_F32_CASES} == {
        (b, nq, ta.flash_f32_plan(b * h, nq, nk, d).splits)
        for b, h, nq, nk, d in admitted if d == 512}


def test_every_admitted_f32_conv_has_a_plan(calls):
    _, convs = calls
    admitted = {(n, c, co, h, w) for n, c, co, h, w in convs
                if tc.conv3x3_ok((n, c, h, w), (co, c, 3, 3), torch.float32)
                or tc.conv3x3_vae_ok((n, c, h, w), (co, c, 3, 3),
                                     torch.float32)}
    assert len(admitted) > 20
    for n, c, co, h, w in admitted:
        p = tc.conv3x3_plan(n, c, co, h, w, torch.float32)
        assert p.bm == 128 and 1 <= p.th * p.tw <= 128 and c % 8 == 0
        assert p.smem == 8 * ((p.th + 2) * (p.tw + 2) * 12 + 128 * 76)
        assert p.smem <= tc.SMEM_MAX
        assert p.grid == (n * -(-h // p.th) * -(-w // p.tw), -(-co // 128))
    cs = chip_smoke()
    assert {k[:5] for k in cs.CONV_F32_CASES} <= admitted
    assert {k[5] for k in cs.CONV_F32_CASES} == {"float32"}


@pytest.mark.parametrize("d,nk,splits", [
    (64, 1024, 1),      # no float32 tile at this head dim
    (40, 1000, 1),      # Nk not a multiple of the 64-key tile
    (40, 1024, 2),      # a KV split below d = 512
    (512, 1024, 0),
    (512, 96, 4),       # 3 key tiles cannot fill 4 slices
    (512, 1024, 33),    # more slices than key tiles
])
def test_f32_tile_refuses_what_the_kernel_does_not_take(d, nk, splits):
    with pytest.raises(ValueError, match="no float32 tile"):
        ta.f32_tile(1, 1024, nk, d, splits)


# --- gates and the sources' constants --------------------------------------

def fake(*shape):
    return types.SimpleNamespace(device=torch.device("cuda"), shape=shape)


@pytest.mark.parametrize("nq,nk", [(1024, 1024), (4096, 4096), (520, 1024),
                                   (1024, 77), (256, 256), (1024, 768)])
def test_attention_gate_matches_jax_in_float32(nq, nk, monkeypatch):
    """JAX's gate (``attention.py:660-673``) has no dtype test: on a TPU a
    float32 attention takes the flash op wherever a bf16 one does; the
    port's takes its kernels at the same shapes."""
    taken = []
    monkeypatch.setattr(ka, "_on_tpu", lambda: True)
    monkeypatch.setattr(ka, "_HAS_PLTPU", True)
    monkeypatch.setattr(ka, "_flash_op", lambda q, k, v, s: taken.append(1)
                        or ka._xla_attention(q, k, v, s))
    q = jnp.zeros((1, 1, nq, 40), jnp.float32)
    kv = jnp.zeros((1, 1, nk, 40), jnp.float32)
    ka.multihead_attention(q, kv, kv)
    assert bool(taken) == ta.use_flash(fake(1, 1, nq, 40), fake(1, 1, nk, 40))


def test_f32_constants_match_the_sources():
    src = (_build.CSRC / "flash_attn_fwd_f32.cu").read_text()
    tiles = {int(d): (int(bm), int(bn)) for d, bm, bn in re.findall(
        r"struct Tile<(\d+)> \{\s*static constexpr int BM = (\d+), "
        r"BN = (\d+),", src)}
    assert tiles == ta._F32_TILES
    assert set(tiles) == set(ta.KERNEL_HEAD_DIMS)
    assert "4 * ((T::BM + T::BN) * (D + 4) + T::BN * D +" in src
    conv = (_build.CSRC / "conv3x3_f32.cu").read_text()
    assert f"constexpr int BM = {tc._F32_BM};" in conv
    assert "constexpr int BK = 8;" in conv
    assert "constexpr int HPS = BK + 4;" in conv and tc._F32_HPS == 12
    assert "constexpr int WS = 9 * BK + 4;" in conv and tc._F32_WS == 76
    assert "constexpr int STAGES = 2;" in conv
    # every source the wrappers load is built by chip_smoke.py
    assert {"flash_attn_fwd_f32", "conv3x3_f32"} <= {
        p.stem for p in _build.CSRC.glob("*.cu")}
    smoke = (REPO / "chip_smoke.py").read_text()
    assert '"flash_attn_fwd_f32"' in smoke and '"conv3x3_f32"' in smoke
