"""The port's kernel modules held against the JAX package, on the CPU.

On the CPU each wrapper takes its kernel's plain version, so this file holds
those plain versions against the JAX package's plain versions
(``_xla_attention``, ``_xla_group_norm``) and against the Pallas kernels run
in interpret mode (the pattern of ``tests/test_attention.py:30``), checks the
dispatch gates, and that the wrappers refuse what they cannot run (the
GroupNorm kernel's launch plan is ``tests/test_torch_groupnorm.py``'s).  The kernels themselves run only on
the card: ``chip_smoke.py`` holds them against the same plain versions there.

The backward (K5, K6) and the two autograd Functions are held against the
Pallas flash backward in interpret mode, ``jax.vjp`` of ``_xla_attention``
and ``jax.grad`` through the ``custom_vjp`` ops ``_flash_op`` /
``_fused_op`` (the pattern of ``tests/test_attention.py:110-159``).

The d = 512 kernel's host logic: the plain split-KV version (per-slice
partials, then the combine pass) is held against ``attention_ref`` and the
streamed-KV Pallas kernel ``_flash_attention_kv`` in interpret mode, and
``kv_splits`` against the block counts it is meant to give.

Tolerances: float32 plain versions 1e-5 (sums in another order); bf16
attention output 1e-2 * max|ref| (one bf16 rounding of P and of the output);
Pallas kernels 2e-3 (the tolerance of ``tests/test_attention.py``); the
logsumexp 1e-5; attention gradients atol 5e-3, rtol 1e-3 (the tolerance of
``tests/test_attention.py:131-136``); GroupNorm+SiLU gradients 1e-4 *
max|ref|; the split-KV version 1e-5 against ``attention_ref`` (float32,
sums in another order) and 2e-3 against the Pallas kernel.
"""

import math
import re
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.kernels.attention as ka  # noqa: E402
import fgdm_tpu.kernels.groupnorm as kg  # noqa: E402
from fgdm_tpu_torch.kernels import _build  # noqa: E402
from fgdm_tpu_torch.kernels import attention as ta  # noqa: E402
from fgdm_tpu_torch.kernels import groupnorm as tg  # noqa: E402

torch.set_num_threads(2)


def qkv(rng, b, h, nq, nk, d):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, nq, d), (b, h, nk, d), (b, h, nk, d))]


def as_torch(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_xla(dtype):
    rng = np.random.default_rng(0)
    q, k, v = qkv(rng, 2, 3, 64, 96, 40)
    scale = 40 ** -0.5
    ref = ka._xla_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                            scale)
    out = ta.attention_ref(*as_torch((q, k, v), getattr(torch, dtype)),
                           scale)
    assert out.dtype == getattr(torch, dtype)
    ref = np.asarray(ref, np.float32)
    tol = 1e-5 if dtype == "float32" else 1e-2 * np.abs(ref).max()
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=0)


# (TPU kernel, its jitted caller, B, H, N, d): K1 at the UNet head dims,
# K2 and K3 at the VAE's single 512-wide head.
PALLAS_CASES = [
    ("K1", "_flash_attention_t", 1, 2, 512, 40),
    ("K1", "_flash_attention_t", 1, 2, 512, 80),
    ("K2", "_flash_attention", 1, 1, 512, 512),
    ("K3", "_flash_attention_kv", 1, 1, 1024, 512),
]


@pytest.mark.parametrize("case", PALLAS_CASES, ids=lambda c: f"{c[0]}-d{c[5]}")
def test_flash_attention_matches_pallas_interpret(case, monkeypatch):
    _, fn, b, h, n, d = case
    monkeypatch.setattr(ka, "_INTERPRET", True)
    rng = np.random.default_rng(d)
    q, k, v = qkv(rng, b, h, n, n, d)
    scale = 1 / math.sqrt(d)
    ref = getattr(ka, fn)(*(jnp.asarray(a) for a in (q, k, v)), scale,
                          block_q=256, block_k=256)
    before = sum(ta.flash_attention.launches.values())
    out = ta.flash_attention(*as_torch((q, k, v)), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3)
    # the CPU takes the plain version and launches nothing
    assert sum(ta.flash_attention.launches.values()) == before


def test_multihead_attention_matches_jax_dispatch():
    """The public entry points agree, default scale included."""
    rng = np.random.default_rng(1)
    q, k, v = qkv(rng, 2, 8, 16, 77, 40)
    ref = ka.multihead_attention(*(jnp.asarray(a) for a in (q, k, v)))
    out = ta.multihead_attention(*as_torch((q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def fake(device, *shape):
    """Something with a device and a shape, enough for the gates."""
    return types.SimpleNamespace(device=torch.device(device), shape=shape)


@pytest.mark.parametrize("nq,nk,want", [
    (1024, 1024, True), (4096, 4096, True), (512, 512, True),
    (1024, 77, False),     # cross-attention
    (256, 256, False),     # below the flash length
    (1024, 768, False),    # nk not a multiple of 512
    (256, 1024, False),    # nq below the flash length
])
def test_flash_gate(nq, nk, want):
    assert ta.use_flash(fake("cuda", 2, 8, nq, 40),
                        fake("cuda", 2, 8, nk, 40)) is want
    assert ta.use_flash(fake("cpu", 2, 8, nq, 40),
                        fake("cpu", 2, 8, nk, 40)) is False


@pytest.mark.parametrize("c,groups,want", [
    (128, 32, True), (320, 32, True), (2560, 32, True),
    (96, 32, False),       # narrower than 128
    (130, 32, False),      # not divisible into the groups
])
def test_groupnorm_gate(c, groups, want):
    assert tg.use_fused_gn(fake("cuda", 2, c, 8, 8), groups) is want
    assert tg.use_fused_gn(fake("cpu", 2, c, 8, 8), groups) is False


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on the card raises: no quiet
    switch to the plain version."""
    q = torch.empty(1, 1, 512, 40, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ta.flash_attention(q, q, q, 0.1)
    x = torch.empty(1, 128, 4, 4, device="meta")
    w = torch.empty(128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tg.group_norm_silu_kernel(x, w, w)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_is_keyed_by_source_hash():
    path = _build.library_path("flash_attn_fwd")
    assert path.parent == _build.BUILD_DIR
    assert re.fullmatch(r"libflash_attn_fwd-[0-9a-f]{16}\.so", path.name)
    assert _build.library_path("flash_attn_fwd") == path
    # the build directory is ignored by git
    root = _build.BUILD_DIR.parents[1]
    ignored = (root / ".gitignore").read_text().split()
    assert "build/" in ignored


def test_kernel_head_dims_match_the_source():
    """The Python list of head dims is the CUDA sources': the switch of
    ``flash_attn_fwd.cu`` (d <= 96) and the one head dim of
    ``flash_attn_fwd_d512.cu``; the tile constants and choices the host's
    plans assume are the kernels'."""
    src = (_build.CSRC / "flash_attn_fwd.cu").read_text()
    body = src[src.index("int fgdm_flash_attn_fwd("):
               src.index("int fgdm_flash_attn_block_n(")]
    dims = tuple(int(d) for d in re.findall(r"case (\d+): return launch", body))
    wide = (_build.CSRC / "flash_attn_fwd_d512.cu").read_text()
    dims += tuple(int(d) for d in re.findall(r"constexpr int D = (\d+);", wide))
    assert dims == ta.KERNEL_HEAD_DIMS
    assert {40, 80, 512} <= set(dims)   # the chain's self-attention heads
    # the tile sizes the host logic assumes are the kernels'
    assert f"constexpr int BM = {ta._D512_BM};" in wide
    assert f"constexpr int BN = {ta._D512_BN};" in wide
    assert f"constexpr int WG_ROWS = {ta._K1_WG_ROWS};" in src
    assert f"constexpr int MAX_STAGES = {ta._K1_MAX_STAGES};" in src
    assert f"constexpr int SMEM_LIMIT = {ta._SMEM_LIMIT};" in src
    assert "constexpr int HEADER = 1024;" in src   # k1_tile's 2048 = 1024 + it
    tiles = set(re.findall(r"if \(bn == (\d+) && wgs == (\d+)\)", src))
    assert tiles == {(str(bn), str(w)) for bn in ta._K1_BNS
                     for w in ta._K1_WGS}


# --- K1's tile plan and arithmetic ------------------------------------------

# (B*H, Nq, Nk, d) of K1's launches on the paths: the chain (CFG, batch 1),
# the training step and the served batch of 4 (both B*H = 8*8)
K1_PATH_SHAPES = [(16, 1024, 1024, 40), (16, 4096, 4096, 40),
                  (16, 1024, 1024, 80), (64, 1024, 1024, 40),
                  (64, 4096, 4096, 40), (64, 1024, 1024, 80)]


@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("nq,nk", [(512, 512), (520, 1024), (1000, 1536),
                                    (1024, 1024), (4096, 4096), (4097, 512),
                                    (600, 2048)])
@pytest.mark.parametrize("bh", [1, 3, 16, 64])
def test_k1_plan_is_a_valid_tile(bh, nq, nk, d):
    """Every shape the gate admits gets a tile the kernel takes: the keys
    per tile divide Nk, the grid covers every query row (a ragged last
    tile included) once, the ring fits the block's shared memory."""
    p = ta.flash_fwd_plan(bh, nq, nk, d)
    assert p.bn in ta._K1_BNS and nk % p.bn == 0
    rows = p.wgs * ta._K1_WG_ROWS
    assert p.grid[1] == bh
    assert (p.grid[0] - 1) * rows < nq <= p.grid[0] * rows
    assert 2 <= p.stages <= ta._K1_MAX_STAGES
    assert p.smem <= ta._SMEM_LIMIT
    assert p == ta.k1_tile(bh, nq, nk, d, p.bn, p.stages, p.wgs)


@pytest.mark.parametrize("shape", K1_PATH_SHAPES,
                         ids=lambda s: "bh{}-n{}-d{}".format(*s[1:]))
def test_k1_plan_fills_the_card(shape):
    """At least 128 blocks (of 132 SMs) at every path shape, with the
    widest key tile (Nk % 512 == 0 there)."""
    p = ta.flash_fwd_plan(*shape)
    assert p.grid[0] * p.grid[1] >= 128
    assert p.bn == max(ta._K1_BNS)


@pytest.mark.parametrize("bn,stages,wgs,d,nk", [
    (96, 2, 2, 40, 1024),     # no such key tile
    (128, 2, 2, 40, 960),     # does not divide Nk
    (128, 1, 2, 40, 1024),    # a ring of one
    (128, 5, 2, 40, 1024),    # deeper than the header's barriers
    (64, 2, 3, 40, 1024),     # three consumer warpgroups
    (128, 2, 3, 40, 1024),
    (128, 4, 2, 80, 1024),    # 247,808 B of shared memory
])
def test_k1_tile_refuses_what_the_kernel_does_not_take(bn, stages, wgs, d,
                                                       nk):
    with pytest.raises(ValueError, match="no tile"):
        ta.k1_tile(16, 1024, nk, d, bn, stages, wgs)


def k1_arithmetic(q, k, vt, scale, bn):
    """The K1 kernel's arithmetic in plain torch: key tiles of ``bn``, an
    online softmax in base 2 with scale * log2 e folded into the scores, P
    rounded to bf16 unnormalised, V handed over transposed (``vt``
    ``[B, H, D, Nk]``), f32 accumulation, one division at the end.  Returns
    the output in q's dtype and the natural-log lse."""
    sl = scale * ta._LOG2E
    b, h, nq, d = q.shape
    m = torch.full((b, h, nq), -math.inf)
    l = torch.zeros(b, h, nq)
    acc = torch.zeros(b, h, nq, d)
    for j in range(0, k.shape[2], bn):
        s = torch.matmul(q.float(), k[:, :, j:j + bn].float().transpose(2, 3))
        mn = torch.maximum(m, s.amax(dim=-1) * sl)
        alpha = torch.exp2(m - mn)
        p = torch.exp2(s * sl - mn[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.matmul(p.to(torch.bfloat16).float(),
                          vt[..., j:j + bn].float().transpose(2, 3))
        acc = acc * alpha[..., None] + pv
        m = mn
    return (acc / l[..., None]).to(q.dtype), (m + torch.log2(l)) / ta._LOG2E


@pytest.mark.parametrize("d,nq,nk,bn", [(40, 520, 1024, 128),
                                        (80, 600, 1024, 128),
                                        (40, 512, 512, 64)])
def test_k1_cpu_route_and_arithmetic_match_plain_and_xla(d, nq, nk, bn):
    """At ragged and even query lengths, in bf16: the CPU route is
    ``attention_ref``; it and the kernel's arithmetic (base 2, V^T, P
    unnormalised) agree with JAX's ``_xla_attention`` within one bf16
    rounding of P and of the output (1e-2 * max|ref|), and their lse within
    1e-4 (f32, exp2 against exp)."""
    rng = np.random.default_rng(d + nq)
    arrs = qkv(rng, 1, 3, nq, nk, d)
    q, k, v = as_torch(arrs, torch.bfloat16)
    scale = d ** -0.5
    out, lse = ta.flash_attention(q, k, v, scale, return_lse=True)
    ref, ref_lse = ta.attention_ref(q, k, v, scale, return_lse=True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    xla = np.asarray(ka._xla_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrs), scale), np.float32)
    tol = 1e-2 * np.abs(xla).max()
    emu, emu_lse = k1_arithmetic(q, k, v.transpose(2, 3).contiguous(), scale,
                                 bn)
    for got in (out, emu):
        assert got.dtype == torch.bfloat16 and got.shape == (1, 3, nq, d)
        np.testing.assert_allclose(got.float().numpy(), xla, atol=tol, rtol=0)
    np.testing.assert_allclose(emu_lse.numpy(), ref_lse.numpy(), atol=1e-4,
                               rtol=0)


def nhwc_to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


@pytest.mark.parametrize("shape,eps,silu", [
    ((2, 8, 8, 320), 1e-5, True),
    ((1, 16, 16, 128), 1e-6, True),
    ((2, 4, 4, 256), 1e-5, False),
])
def test_group_norm_ref_matches_xla_and_pallas(shape, eps, silu, monkeypatch):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32) * 3 + 1
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    xla = kg._xla_group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             32, eps, silu)
    monkeypatch.setattr(kg, "_INTERPRET", True)
    pallas = kg.group_norm_silu(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), eps=eps, apply_silu=silu,
                                use_fused=True)
    out = tg.group_norm_silu(nhwc_to_nchw(x), torch.from_numpy(w),
                             torch.from_numpy(b), 32, eps, silu)
    out = np.moveaxis(out.numpy(), 1, -1)
    np.testing.assert_allclose(out, np.asarray(xla), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=1e-4, rtol=0)


def test_group_norm_ref_bf16_casts_once():
    """bf16 in, bf16 out; statistics, affine and SiLU in f32 with a single
    cast at the end, as ``_xla_group_norm``."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 8, 8, 128)).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    xla = kg._xla_group_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                             jnp.asarray(b), 32, 1e-6, True)
    out = tg.group_norm_silu_kernel(nhwc_to_nchw(x).to(torch.bfloat16),
                                    torch.from_numpy(w), torch.from_numpy(b),
                                    32, 1e-6, True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(np.moveaxis(out.float().numpy(), 1, -1),
                               np.asarray(xla, np.float32), atol=2e-2)


def test_group_norm_cpu_path_counts_no_launch():
    before = sum(tg.group_norm_silu_kernel.launches.values())
    tg.group_norm_silu(torch.zeros(1, 128, 4, 4), torch.ones(128),
                       torch.zeros(128), use_kernel=True)
    assert sum(tg.group_norm_silu_kernel.launches.values()) == before


# --- the backward: lse, K5/K6 plain version, the autograd Functions ---------

@pytest.mark.parametrize("d", [40, 80])
def test_attention_lse_matches_pallas_interpret(d, monkeypatch):
    """K1's lse output: the natural-log logsumexp of the scaled scores."""
    monkeypatch.setattr(ka, "_INTERPRET", True)
    rng = np.random.default_rng(10 + d)
    q, k, v = qkv(rng, 1, 2, 300, 512, d)
    scale = 1 / math.sqrt(d)
    _, ref = ka._flash_attention_t(*(jnp.asarray(a) for a in (q, k, v)),
                                   scale, block_q=256, block_k=256,
                                   return_lse=True)
    ref = np.asarray(ref)[:, 0, :300].reshape(1, 2, 300)
    out, lse = ta.attention_ref(*as_torch((q, k, v)), scale, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), ref, atol=1e-5, rtol=1e-5)
    out2, lse2 = ta.flash_attention(*as_torch((q, k, v)), scale,
                                    return_lse=True)
    assert torch.equal(lse2, lse) and torch.equal(out2, out)
    assert lse.dtype == torch.float32 and lse.shape == (1, 2, 300)


@pytest.mark.parametrize("d,nq,nk", [(40, 512, 512), (80, 256, 384)])
def test_attention_bwd_ref_matches_pallas_and_xla_vjp(d, nq, nk,
                                                      monkeypatch):
    monkeypatch.setattr(ka, "_INTERPRET", True)
    rng = np.random.default_rng(d + nk)
    q, k, v = qkv(rng, 1, 2, nq, nk, d)
    g = rng.standard_normal((1, 2, nq, d)).astype(np.float32)
    scale = 1 / math.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: ka._xla_attention(a, b, c, scale),
                     jq, jk, jv)
    xla = vjp(jg)
    o, lse = ka._flash_attention_t(jq, jk, jv, scale, block_q=128,
                                   block_k=128, return_lse=True)
    pallas = ka._flash_backward_t(jq, jk, jv, o, lse, jg, scale,
                                  block_q=128, block_k=128)
    tq, tk, tv, tg_ = as_torch((q, k, v, g))
    to, tlse = ta.attention_ref(tq, tk, tv, scale, return_lse=True)
    port = ta.attention_bwd_ref(tq, tk, tv, to, tlse, tg_, scale)
    before = (sum(ta.flash_attention_bwd_dq.launches.values()),
              sum(ta.flash_attention_bwd_dkv.launches.values()))
    wrapped = ta.flash_attention_backward(tq, tk, tv, to, tlse, tg_, scale)
    for ours, w, x, p in zip(port, wrapped, xla, pallas):
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), np.asarray(x), atol=5e-3,
                                   rtol=1e-3)
        np.testing.assert_allclose(ours.numpy(), np.asarray(p), atol=5e-3,
                                   rtol=1e-3)
        # the CPU takes the plain version and launches nothing
        assert torch.equal(w, ours)
    assert (sum(ta.flash_attention_bwd_dq.launches.values()),
            sum(ta.flash_attention_bwd_dkv.launches.values())) == before


@pytest.mark.parametrize("b,h,n,d", [(1, 2, 256, 40), (1, 2, 256, 80),
                                     (1, 1, 256, 512)],
                         ids=["d40", "d80", "d512"])
def test_flash_attention_function_grads_match_jax(b, h, n, d, monkeypatch):
    """``FlashAttention`` (the kernels' route, plain on the CPU) against
    ``jax.grad`` through ``_flash_op``: the lse-saving backward at d=40/80,
    the recompute through ``attention_ref`` at the VAE's d=512."""
    monkeypatch.setattr(ka, "_INTERPRET", True)
    monkeypatch.setattr(ka, "_FLASH_BWD", True)
    monkeypatch.setattr(ka, "_FLASH_TRANSPOSED", True)
    rng = np.random.default_rng(d)
    q, k, v = qkv(rng, b, h, n, n, d)
    scale = 1 / math.sqrt(d)

    def loss(qq, kk, vv):
        return jnp.sum(ka._flash_op(qq, kk, vv, scale) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in as_torch((q, k, v)))
    out = ta.multihead_attention(tq, tk, tv, scale, use_kernel=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    (out ** 2).sum().backward()
    for t, r in zip((tq, tk, tv), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=5e-3,
                                   rtol=1e-3)


def test_flash_attention_without_grad_skips_the_function():
    q = torch.zeros(1, 1, 512, 40)
    assert ta.multihead_attention(q, q, q, use_kernel=True).grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert ta.multihead_attention(q, q, q, use_kernel=True).grad_fn is None


@pytest.mark.parametrize("silu,frozen", [(True, False), (False, False),
                                         (True, True)],
                         ids=["silu", "no_silu", "frozen_affine"])
def test_group_norm_function_grads_match_jax(silu, frozen, monkeypatch):
    """``GroupNormSiLU`` against ``jax.grad`` through ``_fused_op`` (the
    Pallas forward in interpret mode, the XLA VJP backward)."""
    monkeypatch.setattr(kg, "_INTERPRET", True)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 128)).astype(np.float32) * 2 + 0.5
    w = 1 + 0.2 * rng.standard_normal(128).astype(np.float32)
    b = 0.2 * rng.standard_normal(128).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def loss(xx, ww, bb):
        return jnp.sum(kg._fused_op(xx, ww, bb, 32, 1e-5, silu) * g)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (x, w, b)))
    tx = nhwc_to_nchw(x).requires_grad_()
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    if not frozen:
        tw.requires_grad_(), tb.requires_grad_()
    y = tg.group_norm_silu(tx, tw, tb, 32, 1e-5, silu, use_kernel=True)
    assert type(y.grad_fn).__name__ == "GroupNormSiLUBackward"
    (y * nhwc_to_nchw(g)).sum().backward()
    ours = [np.moveaxis(tx.grad.numpy(), 1, -1), tw.grad, tb.grad]
    for o, r in zip(ours if not frozen else ours[:1], ref):
        r = np.asarray(r)
        np.testing.assert_allclose(np.asarray(o), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())
    if frozen:
        assert tw.grad is None and tb.grad is None


def test_bwd_head_dims_match_the_source():
    """The backward's Python head dims are the CUDA source's switches, with
    the forward's key tile (both wrappers ask for nk % 64 == 0)."""
    src = (_build.CSRC / "flash_attn_bwd.cu").read_text()
    for fn in ("fgdm_flash_attn_bwd_dq(", "fgdm_flash_attn_bwd_dkv("):
        body = src[src.index("int " + fn):]
        body = body[:body.index("default:")]
        dims = tuple(int(d) for d in re.findall(r"case (\d+): return", body))
        assert dims == ta.BWD_HEAD_DIMS == (40, 80)
    assert set(ta.BWD_HEAD_DIMS) <= set(ta.KERNEL_HEAD_DIMS)


def test_backward_wrappers_refuse_other_devices():
    q = torch.empty(1, 1, 512, 40, device="meta")
    r = torch.empty(1, 1, 512, device="meta")
    for fn in (ta.flash_attention_bwd_dq, ta.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, q, q, q, r, r, 0.1)


def test_library_key_covers_the_shared_header(monkeypatch, tmp_path):
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("flash_attn_bwd")
    (tmp_path / "hopper.cuh").write_text(
        (tmp_path / "hopper.cuh").read_text() + "\n// edited\n")
    assert _build.library_path("flash_attn_bwd") != before


# --- the d = 512 forward's KV split and combine pass -----------------------

def _split_inputs():
    """[1, 1, 1024, 512] q/k/v in which row 0's scores against the first 32
    keys (the first slice at every split count) stand ~100 above its scores
    against all other keys, so that the other slices' weights for that row
    underflow to 0 in the combine pass."""
    rng = np.random.default_rng(512)
    q, k, v = qkv(rng, 1, 1, 1024, 1024, 512)
    u = q[0, 0, 0] / np.linalg.norm(q[0, 0, 0])
    k[0, 0, :32] += 100.0 * u
    return q, k, v


_SPLIT_SCALE = 512 ** -0.5
_split_cache = {}


def _split_refs(monkeypatch):
    if not _split_cache:
        monkeypatch.setattr(ka, "_INTERPRET", True)
        q, k, v = _split_inputs()
        _split_cache["pallas"] = np.asarray(ka._flash_attention_kv(
            *(jnp.asarray(a) for a in (q, k, v)), _SPLIT_SCALE, block_q=256,
            block_k=256))
        _split_cache["plain"] = ta.attention_ref(
            *as_torch((q, k, v)), _SPLIT_SCALE, return_lse=True)
    return _split_cache["pallas"], _split_cache["plain"]


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_split_kv_matches_plain_and_pallas(splits, monkeypatch):
    pallas, (ref, ref_lse) = _split_refs(monkeypatch)
    q, k, v = as_torch(_split_inputs())
    part_o, part_m, part_l = ta.attention_split_ref(q, k, v, _SPLIT_SCALE,
                                                    splits)
    assert part_o.shape == (splits, 1, 1, 1024, 512)
    assert part_m.shape == part_l.shape == (splits, 1, 1, 1024)
    if splits > 1:
        # row 0's maximum in every later slice lies far below the first's
        gap = (part_m[0, 0, 0, 0] - part_m[1:, 0, 0, 0].max()).item()
        assert gap > 100, gap
    out, lse = ta.flash_combine(part_o, part_m, part_l, torch.float32)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-4,
                               rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), pallas, atol=2e-3)
    assert np.isfinite(out.numpy()).all()


def test_split_kv_bf16_rounds_p_once():
    """In bf16 the split version rounds P before P.V as ``attention_ref``
    does; the combined output stays within one bf16 rounding of it."""
    rng = np.random.default_rng(3)
    q, k, v = as_torch(qkv(rng, 2, 1, 64, 256, 512), torch.bfloat16)
    ref = ta.attention_ref(q, k, v, _SPLIT_SCALE)
    out, _ = ta.combine_ref(*ta.attention_split_ref(q, k, v, _SPLIT_SCALE,
                                                    4), torch.bfloat16)
    assert out.dtype == torch.bfloat16
    tol = 1e-2 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


# (B*H, N) of the chain's and the training step's VAE mid-block attention,
# the split count and the blocks (64-row tiles x splits x B*H) it gives
@pytest.mark.parametrize("bh,n,want,blocks", [
    (1, 1024, 8, 128), (1, 4096, 2, 128), (8, 1024, 1, 128)])
def test_kv_splits_fill_the_card(bh, n, want, blocks):
    """One wave of blocks over the 132 SMs.  With 64-row tiles the three
    shapes have 16, 64 and 128 row tiles, so no split count gives between
    129 and 132 blocks: 128 (97 % of the SMs) in one wave beats 144-256 in
    two, and [8, 1, 1024, 512] takes one split."""
    s = ta.kv_splits(bh, n, n)
    assert s == want
    assert bh * (n // ta._D512_BM) * s == blocks >= 0.95 * ta.SMS


@pytest.mark.parametrize("bh", [1, 2, 3, 8, 64])
@pytest.mark.parametrize("nq,nk", [(512, 512), (1024, 1024), (4096, 4096),
                                    (1000, 1536), (64, 32)])
def test_kv_splits_leave_no_split_empty(bh, nq, nk):
    s = ta.kv_splits(bh, nq, nk)
    tiles = nk // ta._D512_BN
    per = -(-tiles // s)
    assert 1 <= s <= min(tiles, 16)
    assert (s - 1) * per < tiles <= s * per
    # several waves of row tiles are never cut further
    if bh * -(-nq // ta._D512_BM) >= 4 * ta.SMS:
        assert s == 1


def test_d512_cpu_route_ignores_the_split_and_counts_nothing():
    rng = np.random.default_rng(4)
    q, k, v = as_torch(qkv(rng, 1, 1, 64, 128, 512))
    before = (sum(ta.flash_attention.launches.values()),
              sum(ta.flash_combine.launches.values()))
    ref = ta.attention_ref(q, k, v, _SPLIT_SCALE)
    for splits in (None, 2):
        out = ta.flash_attention(q, k, v, _SPLIT_SCALE, splits=splits)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert before == (sum(ta.flash_attention.launches.values()),
                      sum(ta.flash_combine.launches.values()))
    part = torch.empty(2, 1, 1, 4, 512, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ta.flash_combine(part, part[..., 0], part[..., 0])
