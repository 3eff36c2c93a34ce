"""``--precision full`` on the card: the float32 flash-attention (K1-K3)
and 3x3-conv (K7) kernels' algorithms, plans and gates, held against the
JAX package on the CPU.

The kernels (``csrc/flash_attn_fwd_f32.cu``, ``csrc/conv3x3_f32.cu``) run
only on the card, where ``chip_smoke.py`` holds them against the float32
plain versions.  Here:

* a plain-torch emulation of each kernel's own algorithm (the flash
  forward's key tiles in order, its online softmax in base 2; at d = 40/80
  each row's sum in its 8 lanes' parts and P.V in its key partitions, at
  d = 512 its KV slices merged by the combine pass; the conv's channel
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

import functools
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

def f32_flash_arithmetic(q, k, v, scale, bn, splits=1, dc=None):
    """``flash_attn_fwd_f32.cu`` in plain torch: the keys in ``splits``
    slices of whole ``bn``-key tiles; per slice, tile after tile, the
    scores (with ``dc``, summed over chunks of ``dc`` columns of d in
    order, as the d = 512 kernel streams K) times scale * log2 e, the
    running maximum and sum in base 2, P unnormalised in float32, the
    output rescaled then P.V added.  One slice divides by its sum; several
    go through ``combine_ref`` as the partials go through the combine
    pass.  Returns the output and the lse."""
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
            if dc is None:
                sc = torch.matmul(q, kt.transpose(2, 3))
            else:
                sc = sum(torch.matmul(q[..., c:c + dc],
                                      kt[..., c:c + dc].transpose(2, 3))
                         for c in range(0, d, dc))
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


# The d = 40/80 kernel's key partitions of P.V (8 / PvSplit<D>::LD)
K1_PARTS = {40: 2, 80: 1}


def k1_f32_arithmetic(q, k, v, scale, bn, parts):
    """``flash_fwd_f32_kernel`` (d = 40/80) in plain torch: key tiles of
    ``bn`` in order; per tile the scores times scale * log2 e, the running
    row maximum, and P unnormalised in float32; each of a row's 8 lanes
    (keys = lane mod 8) keeps its part of the row sum, each of ``parts``
    key partitions (keys = p mod parts) its part of the output, rescaled
    then P.V added.  At the end the lanes' sums are added as the shuffles
    add them, ((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7)), then the
    partitions' outputs, then one division.  Returns the output and the
    lse."""
    sl = scale * ta._LOG2E
    b, h, nq, d = q.shape
    m = torch.full((b, h, nq), -math.inf)
    lanes = torch.zeros(8, b, h, nq)
    acc = torch.zeros(parts, b, h, nq, d)
    for t in range(k.shape[2] // bn):
        kt, vt = k[:, :, t * bn:(t + 1) * bn], v[:, :, t * bn:(t + 1) * bn]
        sc = torch.matmul(q, kt.transpose(2, 3))
        mn = torch.maximum(m, sc.amax(dim=-1) * sl)
        alpha = torch.exp2(m - mn)
        p = torch.exp2(sc * sl - mn[..., None])
        for ln in range(8):
            lanes[ln] = lanes[ln] * alpha + p[..., ln::8].sum(dim=-1)
        for pt in range(parts):
            acc[pt] = (acc[pt] * alpha[..., None]
                       + torch.matmul(p[..., pt::parts], vt[:, :, pt::parts]))
        m = mn
    pairs = [lanes[i] + lanes[i + 1] for i in range(0, 8, 2)]
    l = (pairs[0] + pairs[1]) + (pairs[2] + pairs[3])
    out = acc[0] if parts == 1 else acc[0] + acc[1]
    return out / l[..., None], (m + torch.log2(l)) / ta._LOG2E


# (TPU kernel, its jitted caller, B, H, Nq, Nk, d, splits): K1 at a ragged
# and an even query length, K2 and K3 at the VAE's head, one and several
# KV slices
F32_CASES = [
    ("K1", "_flash_attention_t", 1, 2, 520, 1024, 40, 1),
    ("K1", "_flash_attention_t", 1, 2, 512, 512, 80, 1),
    ("K2", "_flash_attention", 1, 1, 512, 512, 512, 1),
    ("K2", "_flash_attention", 1, 1, 512, 512, 512, 4),
    ("K3", "_flash_attention_kv", 1, 1, 256, 1024, 512, 3),
    ("K2", "_flash_attention", 1, 1, 768, 512, 512, 2),
    ("K3", "_flash_attention_kv", 1, 1, 256, 1024, 512, 8),
]


@pytest.mark.parametrize(
    "case", F32_CASES, ids=lambda c: f"{c[0]}-d{c[6]}-nq{c[4]}-s{c[7]}")
def test_f32_flash_arithmetic_matches_plain_and_pallas(case, monkeypatch):
    """In float32 the CPU route is ``attention_ref``; the kernel's
    arithmetic (key tiles of the planned f32 tile, base 2; at d = 40/80 the
    lanes' row sums and the key partitions, at d = 512 the KV slices and the
    combine pass) agrees with it within 1e-5 and with JAX's Pallas kernel
    in interpret mode within 2e-3; its lse with the plain version's within
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
    if d == 512:
        emu, emu_lse = f32_flash_arithmetic(q, k, v, scale, plan.bn, splits,
                                            ta._F32_D512_DC)
    else:
        emu, emu_lse = k1_f32_arithmetic(q, k, v, scale, plan.bn,
                                         K1_PARTS[d])
    assert emu.dtype == torch.float32 and emu.shape == (b, h, nq, d)
    np.testing.assert_allclose(emu.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(emu_lse.numpy(), ref_lse.numpy(), atol=1e-5,
                               rtol=0)
    pallas = np.asarray(getattr(ka, fn)(*(jnp.asarray(a) for a in arrs),
                                        scale, block_q=256, block_k=256))
    assert pallas.dtype == np.float32
    np.testing.assert_allclose(emu.numpy(), pallas, atol=2e-3, rtol=0)


@functools.lru_cache(maxsize=None)
def _k1_case(d):
    """A ragged [1, 2, 200, 256] float32 forward at head dim ``d`` and JAX's
    Pallas kernel's output on it (interpret mode)."""
    arrs = qkv(d + 1, 1, 2, 200, 256, d)
    old = ka._INTERPRET
    ka._INTERPRET = True
    try:
        pallas = np.asarray(ka._flash_attention_t(
            *(jnp.asarray(a) for a in arrs), d ** -0.5, block_q=128,
            block_k=128))
    finally:
        ka._INTERPRET = old
    return arrs, pallas


@pytest.mark.parametrize("bn", sorted({t[1] for t in ta._K1_F32_TILES}))
@pytest.mark.parametrize("d", [40, 80])
def test_k1_f32_tiles_match_plain_and_pallas(d, bn):
    """Every key tile K1-f32 instantiates: its arithmetic (the lanes' row
    sums, the key partitions) agrees with the plain version within 1e-5,
    its lse too, and with JAX's Pallas kernel within 2e-3."""
    arrs, pallas = _k1_case(d)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    scale = d ** -0.5
    ref, ref_lse = ta.attention_ref(q, k, v, scale, return_lse=True)
    emu, emu_lse = k1_f32_arithmetic(q, k, v, scale, bn, K1_PARTS[d])
    np.testing.assert_allclose(emu.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(emu_lse.numpy(), ref_lse.numpy(), atol=1e-5,
                               rtol=0)
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

def f32_conv_arithmetic(xt, wk, bias, splits=1):
    """``conv3x3_f32.cu`` in plain torch: xt ``[N, H, W, C]`` (the
    pre-pass's output) and the float32 pack ``[Co, 9, C]``; the C / 8
    channel chunks in ``splits`` slices of whole chunks (a cluster's
    blocks), in each slice its chunks of 8 in order and the nine taps of
    each chunk in order over a zero halo, all in float32; the slices'
    partial sums added in rank order, then the bias, before the one
    store."""
    n, h, w, c = xt.shape
    xp = torch.nn.functional.pad(xt, (0, 0, 1, 1, 1, 1))
    chunks = c // 8
    per = -(-chunks // splits)
    total = None
    for s in range(splits):
        acc = torch.zeros((n, h, w, wk.shape[0]))
        for c0 in range(8 * s * per, 8 * min((s + 1) * per, chunks), 8):
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                acc += (xp[:, ky:ky + h, kx:kx + w, c0:c0 + 8]
                        @ wk[:, tap, c0:c0 + 8].t())
        total = acc if total is None else total + acc
    return (total + bias).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("caller,n,h,w,c,co", [
    ("whole", 2, 16, 16, 128, 136),    # _conv3x3_fwd, Co % 128 != 0
    ("whole", 1, 16, 24, 136, 128),    # C % 64 != 0, H != W
    ("slab", 1, 128, 128, 128, 128),   # _conv3x3_slab_fwd, slabs
])
def test_f32_conv_arithmetic_matches_plain_and_pallas(caller, n, h, w, c,
                                                      co, monkeypatch):
    """The float32 pack is the K-major weight in float32; the CPU route is
    ``conv3x3_ref``; the kernel's arithmetic at the shape's plan (chunks of
    8 channels, taps within, the plan's slices: 8, 4 and 1 here) agrees
    with it within 1e-5 * max and with JAX's Pallas kernel in interpret
    mode, through the caller the shape takes, within 2e-4."""
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
    plan = tc.conv3x3_plan(n, c, co, h, w, torch.float32)
    emu = f32_conv_arithmetic(tc.nchw_to_nhwc(xt), wk, bias, plan.splits)
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


@functools.lru_cache(maxsize=None)
def _split_case():
    """A [1, 248, 16, 16] -> 128 conv (31 chunks: at every split count the
    last slice is short) and JAX's Pallas kernel's output on it."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((1, 16, 16, 248)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, 248, 128)) / 47).astype(np.float32)
    b = rng.standard_normal((128,)).astype(np.float32)
    old = kc._INTERPRET
    kc._INTERPRET = True
    try:
        pallas = np.asarray(kc._conv3x3_fwd(
            jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b)))
    finally:
        kc._INTERPRET = old
    return x, wt, b, pallas.transpose(0, 3, 1, 2)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_f32_conv_split_slices_match_plain_and_pallas(splits):
    """Each split count the kernel takes: its plan leaves no slice empty,
    and the slices' partials summed in rank order agree with the plain
    version within 1e-5 * max and with JAX's Pallas kernel within 2e-4."""
    x, wt, b, pallas = _split_case()
    plan = tc.f32_conv_tile(1, 248, 128, 16, 16, 64, 64, 2, splits)
    assert plan.splits == splits and (splits - 1) * plan.per < 31
    assert plan.grid == (plan.tiles_y * plan.tiles_x * splits, 2)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    w_t = torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1)))
    wk, bias = tc.pack_weight(w_t, torch.from_numpy(b), torch.float32)
    ref = tc.conv3x3_ref(xt, w_t, torch.from_numpy(b))
    emu = f32_conv_arithmetic(tc.nchw_to_nhwc(xt), wk, bias, splits)
    np.testing.assert_allclose(emu.numpy(), ref.numpy(),
                               atol=1e-5 * ref.abs().max().item(), rtol=0)
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
        assert p == ta.f32_tile(b * h, nq, nk, d, p.splits,
                                (p.bm, p.bn, p.stages))
        assert nk % p.bn == 0 and p.smem <= ta._SMEM_LIMIT
        assert p.grid[2] == b * h and p.grid[1] == p.splits
        assert (p.grid[0] - 1) * p.bm < nq <= p.grid[0] * p.bm
        assert p.splits == (ta.f32_kv_splits(b * h, nq, nk) if d == 512
                            else 1)
        assert _fills_the_card(p.grid[0] * p.grid[1] * p.grid[2],
                               b * h * p.grid[0] * (8 if d == 512 else 1))
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
    assert len(admitted) == 26
    for shape in admitted:
        _check_f32_conv_plan(*shape)
    cs = chip_smoke()
    assert {k[:5] for k in cs.CONV_F32_CASES} <= admitted
    assert {k[5] for k in cs.CONV_F32_CASES} == {"float32"}
    # the path's other shapes as its run launched them: the ControlNet's
    # hint pyramid (its last conv, 256 -> 320) runs once at the batch of 5
    # in the sampler (``hint_only``), at 10 in the enumeration
    assert len(admitted ^ set(cs.PF_CONV_F32_OTHER)) == 8
    for shape in cs.PF_CONV_F32_OTHER:
        _check_f32_conv_plan(*shape)


def _fills_the_card(blocks, most):
    """At least 96 % of the SMs get a block wherever ``most`` blocks (the
    most any plan of the shape gives) would (``flash_fwd_plan``'s rule)."""
    return blocks >= 0.96 * tc.SMS or blocks == most


def _check_f32_conv_plan(n, c, co, h, w):
    """The float32 K7 plan of a shape is one the kernel takes: a forced
    tile's plan, the source's shared memory, a grid that covers the
    output once a slice, slices of whole chunks none of them empty; and it
    fills the card where the smallest tile at the most slices would."""
    p = tc.conv3x3_plan(n, c, co, h, w, torch.float32)
    assert p == tc.f32_conv_tile(n, c, co, h, w, p.bm, p.bn, p.minb,
                                 p.splits)
    assert (p.bm, p.bn, p.minb) in tc._F32_TILES and c % 8 == 0
    assert 1 <= p.th * p.tw <= p.bm and p.tw <= 64
    chunks = c // 8
    assert p.splits in (1, 2, 4, 8) and p.per == -(-chunks // p.splits)
    assert (p.splits - 1) * p.per < chunks   # the last slice is not empty
    stages = 8 * ((p.th + 2) * (p.tw + 2) * 12 + p.bn * 76)
    assert p.smem == max(stages, 4 * p.bn * (p.bm + 16) * (p.splits > 1))
    assert p.smem <= tc.SMEM_MAX
    assert p.tiles_y == -(-h // p.th) and p.tiles_x == -(-w // p.tw)
    assert p.grid == (n * p.tiles_y * p.tiles_x * p.splits, -(-co // p.bn))
    most = max(tc.f32_conv_tile(n, c, co, h, w, 64, 64, 2, s).grid[0]
               * -(-co // 64) for s in (1, 2, 4, 8)
               if -(-chunks // -(-chunks // s)) == s)
    if (n, c, co, h, w) in FEWER_BLOCKS_FASTER:
        assert p.grid[0] * p.grid[1] == 64
    else:
        assert _fills_the_card(p.grid[0] * p.grid[1], most)


# Two eval shapes where 64 blocks of the 128 x 128 tile at 8 slices beat
# every plan that fills the card (chip_smoke.py --sweep on an H100 80GB
# HBM3: 0.0217 ms against 0.0236 for 256 blocks of 64 x 64 at
# [1,128,32,32]->128, 0.0365 against 0.0388 at [1,256,32,32]->128)
FEWER_BLOCKS_FASTER = {(1, 128, 128, 32, 32), (1, 256, 128, 32, 32)}


# ``eval``'s float32 K7 calls (its metric networks, one image a call or the
# 8 of a chunk): the shapes chip_smoke.py holds and sweeps
EVAL_F32_CONVS = [
    (1, 128, 128, 32, 32), (1, 128, 256, 64, 64), (1, 256, 128, 32, 32),
    (1, 256, 256, 64, 64), (1, 256, 512, 32, 32), (1, 512, 256, 32, 32),
    (1, 512, 512, 32, 32), (8, 256, 256, 24, 24), (8, 256, 256, 48, 48)]


@pytest.mark.parametrize("shape", EVAL_F32_CONVS,
                         ids=lambda s: "x".join(map(str, s)))
def test_eval_f32_convs_have_a_plan_that_fills_the_card(shape):
    n, c, co, h, w = shape
    assert tc.conv3x3_ok((n, c, h, w), (co, c, 3, 3), torch.float32)
    _check_f32_conv_plan(*shape)


def test_eval_f32_conv_cases_are_chip_smokes():
    assert chip_smoke().EVAL_CONV_F32_CASES == EVAL_F32_CONVS


@pytest.mark.parametrize("b,h,nq,nk,d", [
    (8, 8, 1024, 1024, 40),    # train_f32's forward, its distill step's
    (2, 8, 1024, 1024, 40), (6, 8, 1024, 1024, 40),
    (8, 1, 1024, 1024, 512),   # train_f32's VAE encoder (K2)
    (1, 1, 1024, 1024, 512),   # the one-slice row's shape
    (9, 1, 4096, 4096, 512),   # a tiled decode's shape in float32
])
def test_train_f32_attention_plans_fill_the_card(b, h, nq, nk, d):
    p = ta.flash_f32_plan(b * h, nq, nk, d)
    assert p == ta.f32_tile(b * h, nq, nk, d, p.splits,
                            (p.bm, p.bn, p.stages))
    tiles = nk // p.bn
    assert (p.splits - 1) * -(-tiles // p.splits) < tiles
    assert _fills_the_card(p.grid[0] * p.grid[1] * p.grid[2],
                           b * h * p.grid[0] * (8 if d == 512 else 1))


@pytest.mark.parametrize("d,nk,splits", [
    (64, 1024, 1),      # no float32 tile at this head dim
    (40, 1000, 1),      # Nk not a multiple of the 64-key tile
    (40, 1024, 2),      # a KV split below d = 512
    (512, 1024, 0),
    (512, 96, 4),       # Nk not a multiple of the 128-key tile
    (512, 384, 4),      # 3 key tiles cannot fill 4 slices
    (512, 1024, 33),    # more slices than key tiles
])
def test_f32_tile_refuses_what_the_kernel_does_not_take(d, nk, splits):
    with pytest.raises(ValueError, match="no float32 tile"):
        ta.f32_tile(1, 1024, nk, d, splits)


@pytest.mark.parametrize("d,nk,tile", [
    (40, 1024, (64, 64, 4)),    # a tile K1-f32 does not instantiate
    (80, 1024, (32, 32, 2)),
    (40, 1056, (64, 64, 2)),    # Nk a multiple of 32 only
    (512, 1024, (64, 64, 2)),   # the d = 512 kernel has one tile
])
def test_f32_tile_refuses_a_forced_tile(d, nk, tile):
    with pytest.raises(ValueError, match="no float32 tile"):
        ta.f32_tile(1, 1024, nk, d, 1, tile)


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
    table = src[src.index("#define FGDM_K1_F32_TILES(X)"):]
    table = table[:table.index("\n\n")]
    k1 = tuple(tuple(map(int, t)) for t in re.findall(
        r"X\((\d+), (\d+), (\d+)\)", table))
    assert k1 == ta._K1_F32_TILES and len(set(k1)) == len(k1)
    # both head dims are dispatched over the whole table
    assert "if (d == 40)" in src and "if (d == 80)" in src
    d512 = re.search(r"constexpr int D = 512, BM = (\d+), BN = (\d+), "
                     r"DC = (\d+), VK = (\d+), STAGES = (\d+);", src)
    tiles = {40: k1, 80: k1,
             512: (tuple(int(d512.group(i)) for i in (1, 2, 5)),)}
    assert tiles == ta._F32_TILES
    assert set(tiles) == set(ta.KERNEL_HEAD_DIMS)
    assert tuple(map(int, d512.groups()[2:4])) == (
        ta._F32_D512_DC, ta._F32_D512_VK)
    # P.V's key partitions, 8 / LD, as the emulation above splits them
    split = {int(d): 8 // int(ld) for d, ld in re.findall(
        r"struct PvSplit<(\d+)> \{\s*static constexpr int LD = (\d+);",
        src)}
    assert split == K1_PARTS
    assert ("return 4 * (16 * WARPS * (D + 4) + STAGES * 2 * BN * (D + 4) +\n"
            "              16 * WARPS * (BN + 8));") in src
    for d in (40, 80):
        for bm, bn, stages in k1:
            assert ta._f32_smem(d, bm, bn, stages) == 4 * (
                bm // 16 * 16 * (d + 4) + stages * 2 * bn * (d + 4)
                + bm // 16 * 16 * (bn + 8)) <= ta._SMEM_LIMIT
    assert ("SMEM = 4 * (BM * QS + BM * SS + STAGES * BUF + 3 * BM)" in src
            and "QS = D + 4;" in src and "KS = DC + 4;" in src
            and "SS = BN + 4;" in src and "BUF = BN * KS;" in src)
    assert ta._f32_smem(512, *ta._F32_TILES[512][0]) == 221952
    assert 221952 <= ta._SMEM_LIMIT
    assert "atomic" not in src.replace("No atomics", "").replace(
        "no atomics", "")
    conv = (_build.CSRC / "conv3x3_f32.cu").read_text()
    assert "constexpr int BK = 8;" in conv
    assert "constexpr int HPS = BK + 4;" in conv and tc._F32_HPS == 12
    assert "constexpr int WS = 9 * BK + 4;" in conv and tc._F32_WS == 76
    assert "constexpr int STAGES = 2;" in conv
    assert f"constexpr int RPAD = {tc._F32_RPAD};" in conv
    assert f"constexpr int MAX_SPLITS = {max(tc._F32_SPLITS)};" in conv
    assert {(16 * int(i), 16 * int(j), int(m)) for i, j, m in re.findall(
        r"\n  FGDM_CONV_F32\((\d+), (\d+), (\d+)\)", conv)} == set(
            tc._F32_TILES)
    # every source the wrappers load is built by chip_smoke.py
    assert {"flash_attn_fwd_f32", "conv3x3_f32"} <= {
        p.stem for p in _build.CSRC.glob("*.cu")}
    smoke = (REPO / "chip_smoke.py").read_text()
    assert '"flash_attn_fwd_f32"' in smoke and '"conv3x3_f32"' in smoke
