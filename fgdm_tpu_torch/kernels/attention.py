"""Multi-head attention: plain versions, hand-written CUDA flash kernels,
their autograd Function, gate.

Counterpart of ``fgdm_tpu/kernels/attention.py``.  ``multihead_attention``
takes q ``[B, H, Nq, D]`` and k/v ``[B, H, Nk, D]`` and returns
``[B, H, Nq, D]`` in q's dtype.  It routes to the flash kernels by the JAX
package's gate (``attention.py:660-673``: Nq >= 512, Nk >= 512,
Nk % 512 == 0; ``flash_gate``) on CUDA tensors, and to ``attention_ref``
otherwise (cross-attention over 77 keys, the N < 512 self-attentions, the
CPU).  The kernels take bf16 or float32 (q, k and v of one dtype) and the
head dims in ``KERNEL_HEAD_DIMS``; anything else through the gate raises
(float16, say).  The launch counts are keyed by the dtype's name as well.

The JAX package's switches are read at import, under its names and
defaults, into module attributes: ``FGDM_DISABLE_FLASH`` (``_DISABLE_FLASH``,
the gate refuses every shape), ``FGDM_FLASH_MIN_N`` (``_MIN_N``, the
gate's least Nq and Nk), ``FGDM_FLASH_BWD`` (``_FLASH_BWD``) and
``FGDM_FLASH_TRANSPOSED`` / ``FGDM_FLASH_TRANSPOSE_MAX_D``
(``_FLASH_TRANSPOSED``, ``_TRANSPOSE_MAX_D``; ``_use_flash_bwd``).  On the
TPU the last two pick the transposed forward kernel, the one that writes
lse; here the forward serves both layouts, so together with ``_FLASH_BWD``
they decide only whether ``FlashAttention``'s backward is the flash
backward or the recompute through ``attention_ref``.  The TPU's tile knobs
have no counterpart: ``FGDM_FLASH_BLOCK_Q``, ``FGDM_FLASH_BLOCK_K``,
``FGDM_FLASH_T_BLOCK_Q`` and ``FGDM_FLASH_KV_BUDGET`` (``flash_fwd_plan``,
``flash_bwd_plan`` and ``kv_splits`` pick the tiles here).

Forward: ``csrc/flash_attn_fwd.cu`` (``wgmma``, TMA) stands in for the TPU
kernel ``_flash_kernel_t`` at the UNet's head dims 40 and 80, with the tile
(keys per tile, ring stages, consumer warpgroups) that ``flash_fwd_plan``
picks and V handed over transposed (``_flash_k1``);
``csrc/flash_attn_fwd_d512.cu`` (``wgmma``, TMA) for ``_flash_kernel`` and
``_flash_kernel_kv`` at the VAE's single 512-wide head; in float32
``csrc/flash_attn_fwd_f32.cu`` (FFMA: no tensor core keeps float32's
products) for all three at d = 40, 80 and 512, at the tile ``f32_tile``
gives (``flash_f32_plan``).  The TPU's split into
resident and streamed K/V existed for VMEM residency and has no counterpart
here; instead the d = 512 kernel splits the keys across blocks when B*H is
too small to fill the card (``kv_splits``) and a second kernel combines the
partial results (``flash_combine``, into bf16 or float32).  The forwards
optionally write the logsumexp of the scaled scores, the residual of the
backward.

Backward: the dQ kernel (K5) and the dK/dV kernel (K6) replace
``_flash_bwd_dq_kernel_t`` and ``_flash_bwd_dkv_kernel_t`` at the head dims
in ``BWD_HEAD_DIMS``: in bf16 ``csrc/flash_attn_bwd.cu`` (``wgmma``, TMA) at
the tiles ``flash_bwd_plan`` picks (``_flash_k5``, ``_flash_k6``), in
float32 ``csrc/flash_attn_bwd_f32.cu`` (FFMA) at the tiles
``flash_bwd_f32_plan`` gives (float32 training); both read K, Q and dO in
place, with no transposed copy.  ``FlashAttention`` (the
counterpart of the ``custom_vjp`` ``_flash_op``, ``attention.py:634-657``)
saves the forward's lse and launches both backward kernels where
``_FLASH_BWD and _use_flash_bwd(d)`` holds, as ``_flash_op_fwd`` does; else
its backward recomputes through ``attention_ref`` under autograd, as the
JAX VJP's XLA branch does.  See the sources for the kernels' design.

``attention_with_scores`` (``attention.py:74-115``) adds the head-averaged
pre-softmax scores that attention-map capture reads to the output of
``multihead_attention``; the score contraction is a torch einsum, as it is
an XLA einsum outside any Pallas kernel in the JAX package.
"""

from __future__ import annotations

import collections
import ctypes
import math
import os
from typing import Optional

import torch

from fgdm_tpu_torch.kernels import _build

__all__ = ["attention_ref", "attention_bwd_ref", "attention_split_ref",
           "combine_ref", "kv_splits", "K1Plan", "k1_tile", "flash_fwd_plan",
           "F32Plan", "f32_tile", "flash_f32_plan",
           "BwdPlan", "bwd_tile", "flash_bwd_plan",
           "BwdF32Plan", "bwd_f32_tile", "flash_bwd_f32_plan",
           "flash_combine", "flash_attention",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_backward", "FlashAttention", "flash_gate",
           "use_flash", "multihead_attention", "attention_with_scores",
           "dtype_name",
           "KERNEL_HEAD_DIMS",
           "BWD_HEAD_DIMS"]

# Head dims the CUDA sources instantiate: the chain's self-attention heads
# at N >= 512 (SD-1.x UNet levels 0 and 1, the VAE's single 512-wide head);
# the backward only the UNet's, the ones training differentiates.
KERNEL_HEAD_DIMS = (40, 80, 512)
BWD_HEAD_DIMS = (40, 80)
# The JAX package's switches (attention.py:29,32,43,50,493), same defaults.
_DISABLE_FLASH = os.environ.get("FGDM_DISABLE_FLASH", "0") == "1"
_MIN_N = int(os.environ.get("FGDM_FLASH_MIN_N", "512"))
_FLASH_BWD = os.environ.get("FGDM_FLASH_BWD", "1") == "1"
_FLASH_TRANSPOSED = os.environ.get("FGDM_FLASH_TRANSPOSED", "1") == "1"
_TRANSPOSE_MAX_D = int(os.environ.get("FGDM_FLASH_TRANSPOSE_MAX_D", "96"))
SMS = 132           # streaming multiprocessors of an H100
_D512_BM, _D512_BN = 64, 32   # the d = 512 kernel's query rows and keys a tile
_LOG2E = 1.4426950408889634
# The d <= 96 kernel (flash_attn_fwd.cu): query rows per consumer
# warpgroup, the keys per tile and the consumer warpgroups it instantiates,
# its deepest K/V ring, and the dynamic shared memory a block may use.
_K1_WG_ROWS, _K1_BNS, _K1_WGS, _K1_MAX_STAGES = 64, (64, 128), (1, 2), 4
_SMEM_LIMIT = 232448
# The backward (flash_attn_bwd.cu): rows per consumer warpgroup, the
# streamed tiles each kernel instantiates (keys for dQ, queries for dK/dV),
# its consumer warpgroups and deepest ring.
_BWD_WG_ROWS, _BWD_WGS, _BWD_MAX_STAGES = 64, (1, 2), 4
_BWD_TILES = {"dq": (64, 128), "dkv": (64,)}
# The float32 forward (flash_attn_fwd_f32.cu): (query rows, keys) a block at
# each head dim it instantiates.
_F32_TILES = {40: (64, 64), 80: (64, 64), 512: (16, 32)}
# The float32 backward (flash_attn_bwd_f32.cu): (query rows, keys) a tile at
# each head dim it instantiates; K5's block owns the query rows and streams
# the keys, K6's owns the keys and streams the query rows.
_BWD_F32_TILES = {40: (64, 64), 80: (64, 64)}


def attention_ref(q, k, v, scale, return_lse: bool = False):
    """Plain version (``_xla_attention``): f32 scores and softmax, the
    probabilities cast to v's dtype for the P.V product.  With
    ``return_lse`` also the f32 logsumexp of the scaled scores
    ``[B, H, Nq]``."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(sim, dim=-1)
    out = torch.matmul(attn.to(v.dtype), v)
    if return_lse:
        return out, torch.logsumexp(sim, dim=-1)
    return out


def attention_bwd_ref(q, k, v, o, lse, do, scale):
    """Plain version of the flash backward (``attention.py:290-294``), in
    f32 from the forward's output and lse: ``(dq, dk, dv)`` in q's dtype."""
    delta = (do.float() * o.float()).sum(dim=-1)
    return _bwd_ref(q, k, v, do, lse, delta, scale)


def _bwd_ref(q, k, v, do, lse, delta, scale):
    """``attention_bwd_ref`` from delta = rowsum(dO * O) ``[B, H, Nq]``."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  - lse.float()[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta.float()[..., None])
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def kv_splits(bh: int, nq: int, nk: int, sms: int = SMS) -> int:
    """Into how many slices the d = 512 kernel cuts the keys of one row
    tile, so that the blocks (row tiles x slices x B*H, one to an SM) fill
    the card.  Least estimated time over 1..16 non-empty slices: waves of
    blocks over the SMs times the key tiles a block walks, plus three
    tile-times for what each block pays once (the Q load, the partial's
    write and its re-read by the combine pass)."""
    base = bh * -(-nq // _D512_BM)
    tiles = nk // _D512_BN
    best = None
    for s in range(1, min(tiles, 16) + 1):
        per = -(-tiles // s)
        if -(-tiles // per) != s:
            continue   # the last slices would be empty
        cost = -(-base * s // sms) * (per + 3)
        if best is None or cost < best[0]:
            best = (cost, s)
    return best[1]


K1Plan = collections.namedtuple("K1Plan", "bn stages wgs grid smem")
K1Plan.__doc__ = """The d <= 96 forward's tile: ``bn`` keys per streamed
tile, a ring of ``stages`` K/V tiles, ``wgs`` consumer warpgroups of 64
query rows each; ``grid`` (row tiles, B*H) and the block's shared memory in
bytes."""


def k1_tile(bh: int, nq: int, nk: int, d: int, bn: int, stages: int,
            wgs: int) -> K1Plan:
    """The plan of one forced tile choice; raises ValueError on a choice the
    kernel does not take (the checks of ``flash_attn_fwd.cu``'s launch)."""
    panels = -(-d // 64)
    smem = (2048 + wgs * panels * _K1_WG_ROWS * 128
            + stages * (panels * bn * 128 + bn // 64 * d * 128))
    if (bn not in _K1_BNS or wgs not in _K1_WGS or nk % bn
            or not 2 <= stages <= _K1_MAX_STAGES or smem > _SMEM_LIMIT):
        raise ValueError(f"flash_attention: no tile bn={bn} stages={stages} "
                         f"wgs={wgs} at d={d}, nk={nk} ({smem} B of shared "
                         "memory)")
    return K1Plan(bn, stages, wgs, (-(-nq // (wgs * _K1_WG_ROWS)), bh), smem)


def flash_fwd_plan(bh: int, nq: int, nk: int, d: int,
                   sms: int = SMS) -> K1Plan:
    """The tile of the d <= 96 forward for ``[bh, nq, d]`` queries against
    ``nk`` keys: 128 keys a tile where they divide nk (else 64), a 2-stage
    ring, and two consumer warpgroups (128 query rows a block, the
    warpgroups' softmax and products in turn) unless that leaves fewer
    blocks than SMs (minus 4 %: B*H = 16 at N = 1024 gives 128), then
    one."""
    bn = _K1_BNS[-1] if nk % _K1_BNS[-1] == 0 else _K1_BNS[0]
    wgs = 2 if bh * -(-nq // (2 * _K1_WG_ROWS)) >= 0.96 * sms else 1
    return k1_tile(bh, nq, nk, d, bn, 2, wgs)


F32Plan = collections.namedtuple("F32Plan", "bm bn splits grid smem")
F32Plan.__doc__ = """The float32 forward's tile: ``bm`` query rows and
``bn`` keys a block, the keys cut into ``splits`` slices (d = 512 only);
``grid`` (row tiles, splits, B*H) and the block's shared memory in bytes."""


def f32_tile(bh: int, nq: int, nk: int, d: int, splits: int = 1) -> F32Plan:
    """The float32 forward's plan with ``splits`` KV slices; raises
    ValueError on what the kernel does not take (the checks of
    ``flash_attn_fwd_f32.cu``'s launch): another head dim, Nk not a
    multiple of the key tile, a split below d = 512 or one that would leave
    a slice empty."""
    if d not in _F32_TILES:
        raise ValueError(f"flash_attention: no float32 tile at d={d} (have "
                         f"{tuple(_F32_TILES)})")
    bm, bn = _F32_TILES[d]
    smem = 4 * ((bm + bn) * (d + 4) + bn * d + bm * (bn + 4) + 3 * bm)
    tiles = nk // bn
    if (nk % bn or splits < 1 or (splits > 1 and d != 512)
            or splits > tiles or -(-tiles // -(-tiles // splits)) != splits
            or smem > _SMEM_LIMIT):
        raise ValueError(f"flash_attention: no float32 tile for {splits} "
                         f"split(s) at d={d}, nk={nk} (keys a tile {bn}, "
                         f"{smem} B of shared memory)")
    return F32Plan(bm, bn, splits, (-(-nq // bm), splits, bh), smem)


def flash_f32_plan(bh: int, nq: int, nk: int, d: int,
                   splits: Optional[int] = None) -> F32Plan:
    """The float32 forward's plan for ``[bh, nq, d]`` queries against
    ``nk`` keys: at d = 512 the keys are cut into ``kv_splits`` slices, as
    in bf16 (``splits=`` forces a count), else one."""
    if splits is None:
        splits = kv_splits(bh, nq, nk) if d == 512 else 1
    return f32_tile(bh, nq, nk, d, splits)


def _use_flash_bwd(d: int) -> bool:
    """JAX's ``_use_transposed`` (``attention.py:496-497``): whether
    ``FlashAttention`` at head dim ``d`` keeps lse for the flash backward
    (together with ``_FLASH_BWD``)."""
    return _FLASH_TRANSPOSED and d <= _TRANSPOSE_MAX_D


BwdPlan = collections.namedtuple("BwdPlan", "kernel bt stages wgs grid smem")
BwdPlan.__doc__ = """A backward kernel's tile: ``kernel`` "dq" (K5) or
"dkv" (K6), ``bt`` keys (K5) or queries (K6) per streamed tile, a ring of
``stages`` tiles, ``wgs`` consumer warpgroups of 64 rows each (query rows
for K5, key rows for K6); ``grid`` (row tiles, B*H) and the block's shared
memory in bytes."""


def bwd_tile(kernel: str, bh: int, nq: int, nk: int, d: int, bt: int,
             stages: int, wgs: int) -> BwdPlan:
    """The plan of one forced tile choice of K5 (``kernel="dq"``) or K6
    (``"dkv"``); raises ValueError on a choice the kernel does not take
    (the checks of ``flash_attn_bwd.cu``'s launches)."""
    if kernel not in _BWD_TILES:
        raise ValueError(f"flash_attention_bwd: no kernel {kernel!r}")
    panels = -(-d // 64)
    stage = 2 * panels * bt * 128   # K and V, or Q and dO
    if kernel == "dkv":             # and the tile's lse and delta
        stage += 8 * bt
    smem = 2048 + 2 * wgs * panels * _BWD_WG_ROWS * 128 + stages * stage
    rows = nq if kernel == "dq" else nk
    if (bt not in _BWD_TILES[kernel] or wgs not in _BWD_WGS
            or (kernel == "dq" and nk % bt)
            or not 2 <= stages <= _BWD_MAX_STAGES or smem > _SMEM_LIMIT):
        raise ValueError(f"flash_attention_bwd_{kernel}: no tile bt={bt} "
                         f"stages={stages} wgs={wgs} at d={d}, nk={nk} "
                         f"({smem} B of shared memory)")
    return BwdPlan(kernel, bt, stages, wgs,
                   (-(-rows // (wgs * _BWD_WG_ROWS)), bh), smem)


def flash_bwd_plan(bh: int, nq: int, nk: int, d: int,
                   sms: int = SMS) -> tuple:
    """The tiles ``(dq, dkv)`` of K5 and K6 for ``[bh, nq, d]`` queries
    against ``nk`` keys (``chip_smoke.py --sweep``): the deepest ring that
    fits; two consumer warpgroups unless that leaves fewer blocks than SMs
    (minus 4 %), as ``flash_fwd_plan``; K5 streams 128 keys a tile where
    they divide Nk at d <= 64, else 64.  At d = 80 the accumulators of a
    64 x 128 tile (d padded to whole swizzle atoms) leave no room for two
    warpgroups in K6, or for 128-key tiles in K5: ptxas would spill and
    serialize the wgmmas."""
    plans = []
    for kernel, rows in (("dq", nq), ("dkv", nk)):
        wgs = 2 if bh * -(-rows // (2 * _BWD_WG_ROWS)) >= 0.96 * sms else 1
        if kernel == "dkv" and d > 64:
            wgs = 1
        bt = _BWD_TILES[kernel][-1]
        if kernel == "dq" and (d > 64 or nk % bt):
            bt = _BWD_TILES[kernel][0]
        for stages in range(_BWD_MAX_STAGES, 1, -1):
            try:
                plans.append(bwd_tile(kernel, bh, nq, nk, d, bt, stages,
                                      wgs))
                break
            except ValueError:
                continue
        else:
            raise ValueError(f"flash_attention_bwd_{kernel}: no tile at "
                             f"d={d}, nq={nq}, nk={nk}")
    return tuple(plans)


BwdF32Plan = collections.namedtuple("BwdF32Plan",
                                    "kernel rows bt grid smem")
BwdF32Plan.__doc__ = """A float32 backward kernel's tile: ``kernel`` "dq"
(K5) or "dkv" (K6), ``rows`` query rows (K5) or key rows (K6) a block,
``bt`` keys (K5) or queries (K6) a streamed tile; ``grid`` (row tiles,
B*H) and the block's shared memory in bytes."""


def bwd_f32_tile(kernel: str, bh: int, nq: int, nk: int,
                 d: int) -> BwdF32Plan:
    """The float32 tile of K5 (``kernel="dq"``) or K6 (``"dkv"``) for
    ``[bh, nq, d]`` queries against ``nk`` keys; raises ValueError on what
    the kernels do not take (the checks of ``flash_attn_bwd_f32.cu``'s
    launches): another kernel or head dim, or Nk not a multiple of the key
    tile."""
    if kernel not in _BWD_TILES or d not in _BWD_F32_TILES:
        raise ValueError(f"flash_attention_bwd: no float32 tile for kernel "
                         f"{kernel!r} at d={d} (have "
                         f"{tuple(_BWD_F32_TILES)})")
    bq, bk = _BWD_F32_TILES[d]
    if nk % bk:
        raise ValueError(f"flash_attention_bwd_{kernel}: no float32 tile at "
                         f"d={d}, nk={nk} (keys a tile {bk})")
    if kernel == "dq":
        smem = 4 * (2 * bq * (d + 4) + 4 * bk * (d + 4) + bq * (bk + 4)
                    + 2 * bq)
        return BwdF32Plan(kernel, bq, bk, (-(-nq // bq), bh), smem)
    smem = 4 * (2 * bk * (d + 4) + 4 * bq * (d + 4) + 2 * bk * (bq + 4)
                + 4 * bq)
    return BwdF32Plan(kernel, bk, bq, (nk // bk, bh), smem)


def flash_bwd_f32_plan(bh: int, nq: int, nk: int, d: int) -> tuple:
    """The float32 tiles ``(dq, dkv)`` of K5 and K6 for ``[bh, nq, d]``
    queries against ``nk`` keys: one tile a head dim (64 query rows and 64
    keys), so at the training step's [8, 8, 1024, 40] each kernel has 1,024
    blocks.  Raises where ``bwd_f32_tile`` does; never falls back."""
    return (bwd_f32_tile("dq", bh, nq, nk, d),
            bwd_f32_tile("dkv", bh, nq, nk, d))


def attention_split_ref(q, k, v, scale, splits: int):
    """Plain version of the split-KV forward: the keys in ``splits`` slices
    of whole 32-key tiles (the kernel's slices); per slice the unnormalised
    output ``[S, B, H, Nq, D]`` f32 (P rounded to v's dtype before P.V),
    the row maxima of the scores in base 2 (scaled by ``scale * log2 e``)
    and the row sums of ``exp2`` ``[S, B, H, Nq]``."""
    tiles = k.shape[2] // _D512_BN
    per = -(-tiles // splits) * _D512_BN
    t = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * (scale * _LOG2E)
    outs, ms, ls = [], [], []
    for s in range(splits):
        ts = t[..., s * per:(s + 1) * per]
        m = ts.max(dim=-1).values
        p = torch.exp2(ts - m[..., None])
        outs.append(torch.matmul(p.to(v.dtype),
                                 v[:, :, s * per:(s + 1) * per]).float())
        ms.append(m)
        ls.append(p.sum(dim=-1))
    return torch.stack(outs), torch.stack(ms), torch.stack(ls)


def combine_ref(part_o, part_m, part_l, dtype):
    """Plain version of the combine pass: rescale each slice by
    ``exp2(m_i - m)``, sum, divide once, round to ``dtype``.  Returns the
    output ``[B, H, Nq, D]`` and the natural-log lse ``[B, H, Nq]``."""
    m = part_m.max(dim=0).values
    w = torch.exp2(part_m - m)
    l = (w * part_l).sum(dim=0)
    out = (w[..., None] * part_o).sum(dim=0) / l[..., None]
    return out.to(dtype), (m + torch.log2(l)) / _LOG2E


def _typed(lib: ctypes.CDLL, name: str, n_ptr: int, n_int: int):
    """Declare ``name(ptr * n_ptr, int * n_int, float, stream) -> int``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, name)
    fn.argtypes = [vp] * n_ptr + [ci] * n_int + [ctypes.c_float, vp]
    fn.restype = ci


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn_fwd")
    if not getattr(lib, "_fgdm_typed", False):
        _typed(lib, "fgdm_flash_attn_fwd", 5, 7)
        lib.fgdm_flash_attn_block_n.argtypes = [ctypes.c_int]
        lib.fgdm_flash_attn_block_n.restype = ctypes.c_int
        lib.fgdm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fgdm_cuda_error_string.restype = ctypes.c_char_p
        lib._fgdm_typed = True
    return lib


def _d512_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn_fwd_d512")
    if not getattr(lib, "_fgdm_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fgdm_flash_attn_fwd_d512.argtypes = (
            [vp] * 8 + [ci] * 4 + [ctypes.c_float, vp])
        lib.fgdm_flash_attn_fwd_d512.restype = ci
        lib.fgdm_flash_combine.argtypes = [vp] * 5 + [ci] * 3 + [vp]
        lib.fgdm_flash_combine.restype = ci
        lib.fgdm_cuda_error_string.argtypes = [ci]
        lib.fgdm_cuda_error_string.restype = ctypes.c_char_p
        lib._fgdm_typed = True
    return lib


def _f32_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn_fwd_f32")
    if not getattr(lib, "_fgdm_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fgdm_flash_attn_fwd_f32.argtypes = (
            [vp] * 8 + [ci] * 6 + [ctypes.c_float, vp])
        lib.fgdm_flash_attn_fwd_f32.restype = ci
        lib.fgdm_flash_attn_f32_block_n.argtypes = [ci]
        lib.fgdm_flash_attn_f32_block_n.restype = ci
        lib.fgdm_cuda_error_string.argtypes = [ci]
        lib.fgdm_cuda_error_string.restype = ctypes.c_char_p
        lib._fgdm_typed = True
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn_bwd")
    if not getattr(lib, "_fgdm_typed", False):
        _typed(lib, "fgdm_flash_attn_bwd_dq", 7, 7)
        _typed(lib, "fgdm_flash_attn_bwd_dkv", 8, 7)
        lib.fgdm_flash_attn_bwd_block_n.argtypes = [ctypes.c_int]
        lib.fgdm_flash_attn_bwd_block_n.restype = ctypes.c_int
        lib.fgdm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fgdm_cuda_error_string.restype = ctypes.c_char_p
        lib._fgdm_typed = True
    return lib


def _bwd_f32_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn_bwd_f32")
    if not getattr(lib, "_fgdm_typed", False):
        _typed(lib, "fgdm_flash_attn_bwd_f32_dq", 7, 5)
        _typed(lib, "fgdm_flash_attn_bwd_f32_dkv", 8, 5)
        lib.fgdm_flash_attn_bwd_f32_block_n.argtypes = [ctypes.c_int]
        lib.fgdm_flash_attn_bwd_f32_block_n.restype = ctypes.c_int
        lib.fgdm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fgdm_cuda_error_string.restype = ctypes.c_char_p
        lib._fgdm_typed = True
    return lib


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the dtype in a launch key."""
    return str(dtype).removeprefix("torch.")


def _check(fn: str, q, k, named, dtypes=(torch.bfloat16, torch.float32)):
    """Device, dtype, layout and shape checks shared by the wrappers: every
    ``[B, H, N, D]`` tensor in ``named`` has q's dtype, one of ``dtypes``,
    and is contiguous and 16-byte aligned on q's device, with q's (B, H, D)
    and q's or k's length.  Returns ``(b, h, nq, nk, d)``."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    if q.dtype not in dtypes:
        raise ValueError(f"{fn}: q must be "
                         f"{' or '.join(map(dtype_name, dtypes))}, got "
                         f"{q.dtype}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    for name, tsr in named.items():
        if tsr.device != q.device or tsr.dtype != q.dtype:
            raise ValueError(f"{fn}: {name} must be {dtype_name(q.dtype)} "
                             f"(q's) on {q.device}, got {tsr.dtype} on "
                             f"{tsr.device}")
        if not tsr.is_contiguous() or tsr.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous and 16-byte "
                             "aligned")
        if tsr.shape not in ((b, h, nq, d), (b, h, nk, d)):
            raise ValueError(f"{fn}: {name} has shape {tuple(tsr.shape)}; "
                             f"q is {tuple(q.shape)}, k {tuple(k.shape)}")
    if k.shape != (b, h, nk, d):
        raise ValueError(f"{fn}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    return b, h, nq, nk, d


def _check_rows(fn: str, q, named):
    """The f32 ``[B, H, Nq]`` row statistics (lse, delta) of q's rows."""
    for name, tsr in named.items():
        if (tsr.device != q.device or tsr.dtype != torch.float32
                or tsr.shape != q.shape[:3] or not tsr.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be contiguous f32 "
                             f"{tuple(q.shape[:3])} on {q.device}")


def _block_n(fn: str, block_n: int, d: int, nk: int, have) -> None:
    if block_n == 0:
        raise ValueError(f"{fn}: head dim {d} not instantiated (have {have})")
    if nk % block_n:
        raise ValueError(f"{fn}: nk={nk} must be a multiple of {block_n} at "
                         f"d={d}")


def _raise_on(lib, fn: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           + lib.fgdm_cuda_error_string(rc).decode())


def flash_combine(part_o, part_m, part_l, dtype=torch.bfloat16):
    """The combine pass of the split-KV forward over the partials of
    ``attention_split_ref``'s layout, into ``dtype`` (bf16 or float32).  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel or
    raises.  Returns ``(out, lse)``.  Counts launches in
    ``flash_combine.launches`` keyed by ``(b, h, nq, splits, dtype name)``."""
    if part_o.device.type == "cpu":
        return combine_ref(part_o, part_m, part_l, dtype)
    fn = "flash_combine"
    if part_o.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {part_o.device}")
    splits, b, h, nq, d = part_o.shape
    for name, tsr, shape in (("part_o", part_o, (splits, b, h, nq, d)),
                             ("part_m", part_m, (splits, b, h, nq)),
                             ("part_l", part_l, (splits, b, h, nq))):
        if (tsr.device != part_o.device or tsr.dtype != torch.float32
                or tuple(tsr.shape) != shape or not tsr.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be contiguous f32 {shape} "
                             f"on {part_o.device}")
    if d != 512 or dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{fn}: the kernel combines d=512 into bf16 or "
                         f"float32, got d={d}, {dtype}")
    out = torch.empty((b, h, nq, d), device=part_o.device, dtype=dtype)
    lse = torch.empty((b, h, nq), device=part_o.device, dtype=torch.float32)
    lib = _d512_lib()
    stream = torch.cuda.current_stream(part_o.device).cuda_stream
    with torch.cuda.device(part_o.device):
        rc = lib.fgdm_flash_combine(
            part_o.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b * h * nq, splits,
            int(dtype == torch.float32), stream)
    _raise_on(lib, fn, rc)
    flash_combine.launches[(b, h, nq, splits, dtype_name(dtype))] += 1
    return out, lse


flash_combine.launches = collections.Counter()


def _flash_d512(q, k, v, scale, return_lse, splits, b, h, nq, nk):
    """The d = 512 route of ``flash_attention``: one launch that writes the
    output when the keys are not split, else the partials and the combine
    pass."""
    fn = "flash_attention"
    _block_n(fn, _D512_BN, 512, nk, KERNEL_HEAD_DIMS)
    if splits is None:
        splits = kv_splits(b * h, nq, nk)
    tiles = nk // _D512_BN
    if not 1 <= splits <= tiles or -(-tiles // -(-tiles // splits)) != splits:
        raise ValueError(f"{fn}: {splits} splits of {tiles} key tiles would "
                         "leave a split empty")
    dev = q.device
    out = lse = part_o = part_m = part_l = None
    if splits == 1:
        out = torch.empty_like(q)
        if return_lse:
            lse = torch.empty((b, h, nq), device=dev, dtype=torch.float32)
    else:
        part_o = torch.empty((splits, b, h, nq, 512), device=dev,
                             dtype=torch.float32)
        part_m = torch.empty((splits, b, h, nq), device=dev,
                             dtype=torch.float32)
        part_l = torch.empty_like(part_m)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _d512_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.fgdm_flash_attn_fwd_d512(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(out), ptr(lse),
            ptr(part_o), ptr(part_m), ptr(part_l), b * h, nq, nk, splits,
            float(scale), stream)
    _raise_on(lib, fn, rc)
    if splits > 1:
        out, lse = flash_combine(part_o, part_m, part_l, q.dtype)
    return out, lse


def _flash_f32(q, k, v, scale, return_lse, plan: F32Plan):
    """The float32 route of ``flash_attention`` at the tile ``plan`` on
    checked inputs: one launch that writes the output when the keys are not
    split, else the partials and the combine pass."""
    b, h, nq, d = q.shape
    lib = _f32_lib()
    _block_n("flash_attention", lib.fgdm_flash_attn_f32_block_n(d), d,
             k.shape[2], tuple(_F32_TILES))
    dev = q.device
    out = lse = part_o = part_m = part_l = None
    if plan.splits == 1:
        out = torch.empty_like(q)
        if return_lse:
            lse = torch.empty((b, h, nq), device=dev, dtype=torch.float32)
    else:
        part_o = torch.empty((plan.splits, b, h, nq, d), device=dev,
                             dtype=torch.float32)
        part_m = torch.empty((plan.splits, b, h, nq), device=dev,
                             dtype=torch.float32)
        part_l = torch.empty_like(part_m)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.fgdm_flash_attn_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(out), ptr(lse),
            ptr(part_o), ptr(part_m), ptr(part_l), b * h, nq, k.shape[2], d,
            plan.splits, plan.smem, float(scale), stream)
    _raise_on(lib, "flash_attention", rc)
    if plan.splits > 1:
        out, lse = flash_combine(part_o, part_m, part_l, torch.float32)
    return out, lse


def _flash_k1(q, k, v, scale, return_lse, plan: K1Plan):
    """The d = 40/80 route of ``flash_attention`` at the tile ``plan`` on
    checked inputs: V goes to the kernel transposed, ``[B, H, D, Nk]``, so
    that P.V's B operand is K-major (see ``flash_attn_fwd.cu``).  Returns
    ``(out, lse or None)``."""
    b, h, nq, d = q.shape
    vt = v.transpose(2, 3).contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, nq), device=q.device, dtype=torch.float32)
           if return_lse else None)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.fgdm_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), vt.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b * h, nq, k.shape[2],
            d, plan.bn, plan.stages, plan.wgs, float(scale), stream)
    _raise_on(lib, "flash_attention", rc)
    return out, lse


def flash_attention(q, k, v, scale, return_lse: bool = False,
                    splits: Optional[int] = None):
    """Flash-attention forward (K1-K3) in bf16 or float32.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    With ``return_lse`` also returns the f32 logsumexp ``[B, H, Nq]`` of the
    scaled scores.  At d = 512 the keys are cut into ``kv_splits`` slices
    (``splits=`` forces a count) and ``flash_combine`` merges them; at
    d = 40/80 ``flash_fwd_plan`` picks the bf16 tile, ``flash_f32_plan``
    the float32 one.

    Counts launches in ``flash_attention.launches`` keyed by
    ``(b, h, nq, nk, d, return_lse, dtype name)``.
    """
    if q.device.type == "cpu":
        if return_lse:
            out, lse = attention_ref(q, k, v, scale, return_lse=True)
            return out.to(q.dtype), lse
        return attention_ref(q, k, v, scale).to(q.dtype)
    b, h, nq, nk, d = _check("flash_attention", q, k,
                             {"q": q, "k": k, "v": v})
    if splits not in (None, 1) and d != 512:
        raise ValueError(f"flash_attention: no KV split at d={d}")
    if q.dtype == torch.float32:
        out, lse = _flash_f32(q, k, v, scale, return_lse,
                              flash_f32_plan(b * h, nq, nk, d, splits))
    elif d == 512:
        out, lse = _flash_d512(q, k, v, scale, return_lse, splits, b, h, nq,
                               nk)
    else:
        lib = _lib()
        _block_n("flash_attention", lib.fgdm_flash_attn_block_n(d), d, nk,
                 KERNEL_HEAD_DIMS)
        out, lse = _flash_k1(q, k, v, scale, return_lse,
                             flash_fwd_plan(b * h, nq, nk, d))
    flash_attention.launches[(b, h, nq, nk, d, bool(return_lse),
                              dtype_name(q.dtype))] += 1
    return (out, lse) if return_lse else out


flash_attention.launches = collections.Counter()


def _bwd_args(fn, q, k, v, do, lse, delta):
    """The backward wrappers' checks: q/k/v/dO of one dtype, bf16 or
    float32 (the forward's ``_check``), and the f32 row statistics.
    Returns the dtype's library and ``(b * h, nq, nk, d)``."""
    b, h, nq, nk, d = _check(fn, q, k, {"q": q, "k": k, "v": v, "do": do})
    if do.shape != q.shape:
        raise ValueError(f"{fn}: do {tuple(do.shape)} vs q {tuple(q.shape)}")
    _check_rows(fn, q, {"lse": lse, "delta": delta})
    if q.dtype == torch.float32:
        lib = _bwd_f32_lib()
        block_n = lib.fgdm_flash_attn_bwd_f32_block_n(d)
    else:
        lib = _bwd_lib()
        block_n = lib.fgdm_flash_attn_bwd_block_n(d)
    _block_n(fn, block_n, d, nk, BWD_HEAD_DIMS)
    return lib, (b * h, nq, nk, d)


def _flash_k5(q, k, v, do, lse, delta, scale, plan: BwdPlan):
    """K5 at the tile ``plan`` on checked inputs."""
    b, h, nq, d = q.shape
    dq = torch.empty_like(q)
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.fgdm_flash_attn_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * h, nq,
            k.shape[2], d, plan.bt, plan.stages, plan.wgs, float(scale),
            stream)
    _raise_on(lib, "flash_attention_bwd_dq", rc)
    return dq


def _flash_k6(q, k, v, do, lse, delta, scale, plan: BwdPlan):
    """K6 at the tile ``plan`` on checked inputs."""
    b, h, nq, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.fgdm_flash_attn_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, nq, k.shape[2], d, plan.bt, plan.stages, plan.wgs,
            float(scale), stream)
    _raise_on(lib, "flash_attention_bwd_dkv", rc)
    return dk, dv


def _flash_k5_f32(q, k, v, do, lse, delta, scale, plan: BwdF32Plan):
    """K5 in float32 at the tile ``plan`` on checked inputs."""
    b, h, nq, d = q.shape
    dq = torch.empty_like(q)
    lib = _bwd_f32_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.fgdm_flash_attn_bwd_f32_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * h, nq,
            k.shape[2], d, plan.smem, float(scale), stream)
    _raise_on(lib, "flash_attention_bwd_dq", rc)
    return dq


def _flash_k6_f32(q, k, v, do, lse, delta, scale, plan: BwdF32Plan):
    """K6 in float32 at the tile ``plan`` on checked inputs."""
    b, h, nq, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _bwd_f32_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.fgdm_flash_attn_bwd_f32_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, nq, k.shape[2], d, plan.smem, float(scale), stream)
    _raise_on(lib, "flash_attention_bwd_dkv", rc)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale):
    """dQ of flash attention (K5) in bf16 or float32 from the forward's lse
    and ``delta = rowsum(dO * O)``, both f32 ``[B, H, Nq]``.  A CPU tensor
    takes the plain version; a CUDA tensor launches the dtype's kernel or
    raises.  Counts launches in ``flash_attention_bwd_dq.launches`` keyed by
    ``(b, h, nq, nk, d, dtype name)``."""
    if q.device.type == "cpu":
        return _bwd_ref(q, k, v, do, lse, delta, scale)[0]
    _, (bh, nq, nk, d) = _bwd_args("flash_attention_bwd_dq", q, k, v, do,
                                   lse, delta)
    if q.dtype == torch.float32:
        dq = _flash_k5_f32(q, k, v, do, lse, delta, scale,
                           flash_bwd_f32_plan(bh, nq, nk, d)[0])
    else:
        dq = _flash_k5(q, k, v, do, lse, delta, scale,
                       flash_bwd_plan(bh, nq, nk, d)[0])
    flash_attention_bwd_dq.launches[(*q.shape[:2], nq, nk, d,
                                     dtype_name(q.dtype))] += 1
    return dq


flash_attention_bwd_dq.launches = collections.Counter()


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale):
    """``(dK, dV)`` of flash attention (K6) in bf16 or float32; the
    arguments of ``flash_attention_bwd_dq``.  A CPU tensor takes the plain
    version; a CUDA tensor launches the dtype's kernel or raises.  Counts
    launches in ``flash_attention_bwd_dkv.launches`` keyed by
    ``(b, h, nq, nk, d, dtype name)``."""
    if q.device.type == "cpu":
        return _bwd_ref(q, k, v, do, lse, delta, scale)[1:]
    _, (bh, nq, nk, d) = _bwd_args("flash_attention_bwd_dkv", q, k, v, do,
                                   lse, delta)
    if q.dtype == torch.float32:
        dk, dv = _flash_k6_f32(q, k, v, do, lse, delta, scale,
                               flash_bwd_f32_plan(bh, nq, nk, d)[1])
    else:
        dk, dv = _flash_k6(q, k, v, do, lse, delta, scale,
                           flash_bwd_plan(bh, nq, nk, d)[1])
    flash_attention_bwd_dkv.launches[(*q.shape[:2], nq, nk, d,
                                      dtype_name(q.dtype))] += 1
    return dk, dv


flash_attention_bwd_dkv.launches = collections.Counter()


def flash_attention_backward(q, k, v, o, lse, do, scale):
    """``(dq, dk, dv)`` of flash attention from the forward's output and
    lse (``_flash_backward_t``).  A CPU tensor takes the plain version; a
    CUDA tensor launches K5 and K6 or raises.  delta = rowsum(dO * O) is one
    torch reduction, as in the JAX package (``attention.py:390-393``)."""
    if q.device.type == "cuda" and do.data_ptr() % 16:
        do = do.clone()
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (``_flash_op``).

    Where ``_FLASH_BWD and _use_flash_bwd(d)`` holds (by default d <= 96:
    the UNet's 40 and 80) the forward keeps the kernel's lse and the
    backward runs ``flash_attention_backward``, as ``_flash_op_fwd`` does;
    else (the VAE's 512, or a switch off) the backward recomputes
    ``attention_ref`` under autograd.  On the CPU both directions are the
    plain versions.  The backward kernels take bf16 and float32 (K5/K6 and
    their float32 instances), as the forward does; another dtype raises in
    the forward already."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        if _FLASH_BWD and _use_flash_bwd(q.shape[-1]):
            out, lse = flash_attention(q, k, v, scale, return_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = flash_attention(q, k, v, scale)
            ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, do):
        do = do.contiguous()
        # read once: under activation checkpointing each read unpacks
        saved = ctx.saved_tensors
        if len(saved) == 5:
            q, k, v, out, lse = saved
            return (*flash_attention_backward(q, k, v, out, lse, do,
                                              ctx.scale), None)
        q, k, v = (t.detach().requires_grad_() for t in saved)
        with torch.enable_grad():
            out = attention_ref(q, k, v, ctx.scale).to(q.dtype)
        return (*torch.autograd.grad(out, (q, k, v), do), None)


def flash_gate(nq: int, nk: int) -> bool:
    """The shape and switch part of JAX's gate (``attention.py:665-673``):
    long self-attention (Nq, Nk >= ``_MIN_N``, Nk % 512 == 0) unless
    ``_DISABLE_FLASH``."""
    return (not _DISABLE_FLASH and nq >= _MIN_N and nk >= _MIN_N
            and nk % 512 == 0)


def use_flash(q, k) -> bool:
    """The gate of ``attention.py:660-673`` on this card: ``flash_gate`` for
    CUDA tensors, the device taking the place of JAX's backend test.  Like
    JAX's gate it tests no dtype: bf16 and float32 take the kernels, and a
    dtype or head dim the kernels do not take raises in ``flash_attention``
    rather than quietly taking the plain version."""
    return q.device.type == "cuda" and flash_gate(q.shape[2], k.shape[2])


def multihead_attention(q, k, v, scale: Optional[float] = None,
                        use_kernel: Optional[bool] = None):
    """Scaled dot-product attention, q/k/v ``[B, H, N, D]``.

    ``use_kernel=None`` applies the gate; True/False force the kernels or
    the plain version (the counterpart of JAX's ``use_flash=``).  Through
    the kernels, inputs that need a gradient go through ``FlashAttention``;
    the others (inference, frozen towers) launch the forward alone."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if use_kernel is None:
        use_kernel = use_flash(q, k)
    if not use_kernel:
        return attention_ref(q, k, v, float(scale)).to(q.dtype)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, float(scale))
    return flash_attention(q, k, v, float(scale))


def attention_with_scores(q, k, v, scale: float, pool_kq: int = 1):
    """``(out [B, H, Nq, D], scores [B, Nq/p, Nk/p] float32)``: the output
    of ``multihead_attention`` (K1 through the gate) and the head-averaged
    pre-softmax scores mean_h(Q_h K_h^T) * scale.

    ``scale / H`` is folded into the f32 q before the product, and k is
    upcast (never q downcast), as type promotion does in the JAX einsum.
    ``pool_kq`` > 1 average-pools flat windows of ``pool_kq`` consecutive
    tokens on both token axes, on q and k before the product: pooling a
    bilinear form equals pooling its factors, so the map comes out already
    pooled (``attention.py:104-111``)."""
    h = q.shape[1]
    out = multihead_attention(q, k, v, scale)
    qs = q.float() * (float(scale) / h)
    ks = k.float()
    if pool_kq > 1:
        b, _, nq, d = qs.shape
        nk = ks.shape[2]
        if nq % pool_kq or nk % pool_kq:
            raise ValueError(f"attention_with_scores: Nq={nq}, Nk={nk} not "
                             f"divisible by pool_kq={pool_kq}")
        qs = qs.reshape(b, h, nq // pool_kq, pool_kq, d).mean(dim=3)
        ks = ks.reshape(b, h, nk // pool_kq, pool_kq, d).mean(dim=3)
    return out, torch.einsum("bhid,bhjd->bij", qs, ks)
