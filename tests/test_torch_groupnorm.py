"""K4's host side on the CPU: ``gn_plan`` and the kernel's statistics.

The CUDA kernel (``fgdm_tpu_torch/kernels/csrc/groupnorm_silu.cu``) runs
only on the card, where ``chip_smoke.py`` holds it against
``group_norm_silu_ref``.  Here:

* ``gn_plan`` at the paths' shapes, the 512^2 VAE planes in bf16 and f32,
  and spans that are not whole 16-byte vectors: the blocks' slices tile
  each (batch, group) span exactly, shared memory stays within one block's
  share, the cluster size is one the kernel takes, k is the smallest that
  the rule allows, and a group streams exactly where it exceeds what a
  cluster of the largest size holds;
* a numpy emulation of the kernel's statistics with the plan's numbers (per
  block: sums of x - K and (x - K)^2 over its slice, K the slice's first
  element, the triple (n, mean, M2); the k triples combined in rank order
  by Chan's formula; all in f32) at every cluster size and with streaming,
  held against the f64 mean and variance and against the mean and variance
  ``_xla_group_norm`` computes (``groupnorm.py:208-211``), and the output it
  gives against ``_xla_group_norm``'s, on data whose mean is 33 std from 0
  (where the unshifted E[x^2] - mean^2 of the TPU kernel loses digits);
* the plan's constants are the source's ``constexpr``s.
* the wrapper counts each launch under ``(shape, eps, dtype name)``
  (stand-in CUDA tensors, the launch replaced).

Tolerances: the emulated mean within 1e-5 * (|mean| + std) of f64, the
variance within 2e-5 relative (f32 sums of up to 2M terms, offset data);
the output within 1e-5 * max|ref| of ``_xla_group_norm`` (float32, sums in
another order).
"""

import collections
import math
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.kernels.groupnorm as kg  # noqa: E402
from fgdm_tpu_torch.kernels import _build  # noqa: E402
from fgdm_tpu_torch.kernels import groupnorm as tg  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32

# Shapes of the chain (UNet, ControlNet and VAE ResBlocks, the 512^2
# decode's level 0 among them), of the training step and of the served
# batch, and spans that are no whole number of 16-byte vectors.
PLAN_SHAPES = [(2, 320, 64, 64), (2, 2560, 8, 8), (2, 1280, 4, 4),
               (1, 512, 64, 64), (1, 128, 512, 512), (1, 256, 512, 512),
               (3, 128, 5, 7), (4, 256, 512, 512), (8, 320, 32, 32),
               (8, 128, 256, 256), (2, 160, 17, 23)]


def room(shape, dtype, num_groups=32, per_sm=tg._PER_SM):
    """Elements of a slice that fit one block's share of an SM."""
    cpg = shape[1] // num_groups
    esize = tg._ESIZE[dtype]
    budget = min(tg._SMEM_BLOCK, tg._SMEM_SM // per_sm - tg._SMEM_RESERVED)
    return (budget - tg._HEADER - tg._table_bytes(cpg)) // 16 * 16 // esize


@pytest.mark.parametrize("dtype", [BF16, F32, torch.float16],
                         ids=["bf16", "f32", "f16"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_gn_plan_tiles_each_group(shape, dtype):
    plan = tg.gn_plan(shape, dtype)
    esize, vec = tg._ESIZE[dtype], 16 // tg._ESIZE[dtype]
    span = shape[1] // 32 * math.prod(shape[2:])
    assert plan.span == span
    assert plan.k in (1, 2, 4, 8, 16) and plan.blocks == shape[0] * 32 * plan.k
    # the slices cover [0, span) once, none empty
    bounds = [(r * plan.slice, min((r + 1) * plan.slice, span))
              for r in range(plan.k)]
    assert bounds[0][0] == 0 and bounds[-1][1] == span
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    # shared memory: the header, the channel table, the resident part
    assert plan.smem == (tg._HEADER + tg._table_bytes(shape[1] // 32)
                         + plan.resident * esize)
    assert plan.smem <= tg._SMEM_BLOCK
    # plan.per_sm such blocks share one SM's shared memory
    assert plan.per_sm * (plan.smem + tg._SMEM_RESERVED) <= tg._SMEM_SM
    assert 0 < plan.resident <= plan.slice
    assert plan.slice % vec == 0 and plan.resident % vec == 0
    assert plan.aligned == (span * esize % 16 == 0)
    assert plan.threads % 128 == 0 and 128 <= plan.threads <= 512
    # streaming exactly where the group exceeds a cluster of 16
    fits = room(shape, dtype)
    assert plan.streams == (span > 16 * fits) == (plan.slice > fits)
    assert plan.streams == (plan.resident < plan.slice)
    # no smaller cluster would do: it does not fit, or it leaves the card
    # short of a wave with slices above the split limit
    for k in (1, 2, 4, 8):
        if k >= plan.k:
            break
        sl = -(-(-(-span // k)) // vec) * vec
        assert (sl > fits or (shape[0] * 32 * k < tg._MIN_BLOCKS
                              and sl * esize > tg._MIN_SLICE))


@pytest.mark.parametrize("shape", [(1, 128, 512, 512), (1, 256, 512, 512),
                                   (4, 256, 512, 512)], ids=str)
def test_gn_plan_without_clusters_of_16(shape):
    """Where a cluster of 16 does not schedule, the card's plan takes 8 and
    streams more of each slice."""
    full, eight = tg.gn_plan(shape, BF16), tg.gn_plan(shape, BF16, 32, 8)
    assert full.k == 16 and eight.k == 8
    assert eight.streams and eight.slice == 2 * full.slice
    assert eight.resident == full.resident


def test_gn_plan_orientation():
    """The sizes the design was laid out for (bf16)."""
    ks = {s: tg.gn_plan(s, BF16).k for s in PLAN_SHAPES}
    assert ks[(2, 2560, 8, 8)] == 2 and tg.gn_plan((2, 2560, 8, 8),
                                                   BF16).blocks == 128
    assert ks[(2, 320, 64, 64)] == 2 and ks[(1, 512, 64, 64)] == 4
    assert ks[(1, 128, 512, 512)] == 16 and ks[(8, 128, 256, 256)] == 8
    assert ks[(3, 128, 5, 7)] == 1 and not tg.gn_plan((3, 128, 5, 7),
                                                      BF16).aligned


@pytest.mark.parametrize("shape,groups,dtype", [
    ((2, 130, 4, 4), 32, BF16),     # C % G != 0
    ((2, 128), 32, BF16),           # no spatial dims
    ((2, 128, 4, 4), 32, torch.int32),
])
def test_gn_plan_refuses(shape, groups, dtype):
    with pytest.raises(ValueError, match="gn_plan"):
        tg.gn_plan(shape, dtype, groups)


# --- the kernel's statistics, emulated --------------------------------------

def emulate_stats(spans, plan):
    """The kernel's f32 statistics of each row of ``spans`` [groups, span]:
    per block the sums of x - K and (x - K)^2 over its whole slice (resident
    and streamed), K its first element, and its triple; the triples combined
    in rank order by Chan's formula.  Returns (mean, var) per group."""
    f32 = np.float32
    means, vars_ = [], []
    for row in spans:
        mean, m2, cnt = f32(0), f32(0), f32(0)
        for r in range(plan.k):
            part = row[r * plan.slice:(r + 1) * plan.slice]
            n = f32(len(part))
            shift = part[0]
            d = part - shift
            s1, s2 = d.sum(dtype=f32), (d * d).sum(dtype=f32)
            mb = shift + s1 / n
            m2b = max(s2 - s1 * (s1 / n), f32(0))
            tot = cnt + n
            fb = n / tot
            delta = mb - mean
            mean = mean + delta * fb
            m2 = m2 + m2b + delta * delta * cnt * fb
            cnt = tot
        means.append(mean)
        vars_.append(m2 / f32(row.size))
    return np.array(means, f32), np.array(vars_, f32)


# (shape, groups, dtype, max_k, groups emulated): one case for each cluster
# size, streaming at 16 and at 8, an unaligned span, an f32 plane
EMU_CASES = [
    ((3, 128, 5, 7), 32, BF16, 16, None),
    ((2, 320, 64, 64), 32, BF16, 16, None),
    ((1, 512, 64, 64), 32, BF16, 16, 8),
    ((8, 128, 256, 256), 32, BF16, 16, 2),
    ((1, 128, 64, 64), 8, BF16, 16, None),
    ((1, 128, 512, 512), 32, BF16, 16, 2),
    ((1, 128, 512, 512), 32, BF16, 8, 2),
    ((1, 256, 512, 512), 32, F32, 16, 1),
]


@pytest.mark.parametrize("shape,groups,dtype,max_k,n_emulated", EMU_CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_rank_order_combine_matches_xla_stats(shape, groups, dtype, max_k,
                                              n_emulated):
    plan = tg.gn_plan(shape, dtype, groups, max_k)
    b, c = shape[:2]
    n_emulated = n_emulated or b * groups
    if (shape, groups) == ((1, 128, 64, 64), 8):
        assert plan.k == 16
    rng = np.random.default_rng(7)
    cpg = c // groups
    hw = math.prod(shape[2:])
    # whole batch rows of the groups emulated, offset so that |mean| >> std
    nb = -(-n_emulated // groups)
    x = (rng.standard_normal((nb, c, hw)) * 3 + 100).astype(np.float32)
    spans = x.reshape(nb * groups, cpg * hw)[:n_emulated]
    mean, var = emulate_stats(spans, plan)

    ref64 = spans.astype(np.float64)
    m64, v64 = ref64.mean(axis=1), ref64.var(axis=1)
    np.testing.assert_array_less(np.abs(mean - m64),
                                 1e-5 * (np.abs(m64) + np.sqrt(v64)))
    np.testing.assert_allclose(var, v64, rtol=2e-5)

    # _xla_group_norm's statistics (its lines 208-211, NHWC)
    xn = jnp.asarray(np.moveaxis(x, 1, -1))
    xg = xn.reshape(nb, -1, groups, cpg)
    jmean = np.asarray(jnp.mean(xg, axis=(1, 3))).reshape(-1)[:n_emulated]
    jvar = np.asarray(jnp.var(xg, axis=(1, 3))).reshape(-1)[:n_emulated]
    np.testing.assert_allclose(mean, jmean, rtol=0,
                               atol=float(1e-5 * (np.abs(m64).max()
                                                  + np.sqrt(v64).max())))
    np.testing.assert_allclose(var, jvar, rtol=2e-5)

    if n_emulated != b * groups or x.size > 1 << 22:
        return
    # the output from the emulated statistics, as the kernel forms it:
    # mul = rstd * w_c, add = b_c - mean * mul, silu(x * mul + add)
    w = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    rstd = (1 / np.sqrt(var + np.float32(1e-5))).astype(np.float32)
    mul = rstd.reshape(b, groups, 1) * w.reshape(1, groups, cpg)
    add = bias.reshape(1, groups, cpg) - mean.reshape(b, groups, 1) * mul
    y = x.reshape(b, groups, cpg, hw) * mul[..., None] + add[..., None]
    y = (y / (1 + np.exp(-y))).reshape(x.shape)
    ref = np.asarray(kg._xla_group_norm(xn, jnp.asarray(w), jnp.asarray(bias),
                                        groups, 1e-5, True))
    ref = np.moveaxis(ref, -1, 1).reshape(x.shape)
    np.testing.assert_allclose(y, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_plan_constants_match_the_source():
    """The constants ``gn_plan`` assumes are ``csrc/groupnorm_silu.cu``'s."""
    src = (_build.CSRC / "groupnorm_silu.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("SMEM_BLOCK") == tg._SMEM_BLOCK
    assert const("HEADER") == tg._HEADER
    assert const("MAX_THREADS") == tg._MAX_THREADS
    assert const("MAX_CLUSTER") == tg._CLUSTERS[-1]
    assert tg._CLUSTERS == (1, 2, 4, 8, 16)
    assert ("k == 1 || k == 2 || k == 4 || k == 8 || k == MAX_CLUSTER"
            in src)
    assert "return (8 * cpg + 15) / 16 * 16;" in src
    assert all(tg._table_bytes(c) == (8 * c + 15) // 16 * 16
               for c in range(1, 200))
    # the dtype codes of the C entry
    assert "dtype == 0 ? 4 : 2" in src
    for code, name in ((0, "float"), (1, "bf16"), (2, "__half")):
        assert f"case {code}: return max_clusters<{name}>" in src
    assert tg._DTYPE_CODE == {torch.float32: 0, torch.bfloat16: 1,
                              torch.float16: 2}
    # a block may take an SM's 228 KiB less the 1 KiB held for it
    assert tg._SMEM_BLOCK == tg._SMEM_SM - tg._SMEM_RESERVED == 227 * 1024
    # the header's barriers cover the largest resident slice
    chunks = -(-(tg._SMEM_BLOCK - tg._HEADER) // const("CHUNK"))
    assert chunks <= const("MAX_CHUNKS")


class _Fake:
    """A contiguous tensor stand-in on the card (no card here): the wrapper
    reads its device, dtype and shape."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda", 0)

    def is_contiguous(self):
        return True


@pytest.mark.parametrize("dtype", [BF16, F32, torch.float16])
def test_launch_key_carries_the_dtype(dtype, monkeypatch):
    """On a CUDA tensor the wrapper launches once at the card's plan and
    counts the launch under ``(shape, eps, dtype name)``: a float32 path's
    launches are told apart from bf16 ones at the same shape."""
    launched = []
    monkeypatch.setattr(tg, "card_plan", lambda shape, dt, groups: "plan")
    monkeypatch.setattr(tg, "_launch", lambda *a: launched.append(a[-1]))
    monkeypatch.setattr(tg.group_norm_silu_kernel, "launches",
                        collections.Counter())
    x = _Fake((2, 320, 8, 8), dtype)
    w, b = _Fake((320,), F32), _Fake((320,), F32)
    tg.group_norm_silu_kernel(x, w, b, 32, 1e-6, True)
    tg.group_norm_silu_kernel(x, w, b, 32, 1e-6, False)
    name = str(dtype).removeprefix("torch.")
    assert launched == ["plan", "plan"]
    assert dict(tg.group_norm_silu_kernel.launches) == {
        ((2, 320, 8, 8), 1e-6, name): 2}
