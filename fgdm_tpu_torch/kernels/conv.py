"""Direct 3x3 convolution (stride 1, SAME, bias): plain version, the
hand-written CUDA kernel (K7), its autograd Function, gates.

Counterpart of ``fgdm_tpu/kernels/conv.py``.  Layouts are the port's: x
``[N, C, H, W]``, w ``[Co, C, 3, 3]`` (OIHW, any float dtype, cast to x's
dtype), b ``[Co]`` kept in float32; the output is ``[N, Co, H, W]`` in x's
dtype.  The f32 bias is added to the f32 sum before the single cast, as the
JAX kernel does (``conv.py:120-121``); the ``F.conv2d`` path of ``Conv2d``
adds a bias already cast to bf16.

``csrc/conv3x3.cu`` stands in for the TPU kernel ``_kernel``
(``conv.py:100``) behind both of its callers, ``_conv3x3_fwd`` (whole
planes) and ``_conv3x3_slab_fwd`` (height/width slabs with a one-row halo),
in bf16 with two CUDA kernels: a transposing pre-pass (``nchw_to_nhwc``)
and an implicit GEMM on ``wgmma`` that loads a halo tile of the activations
once per channel chunk for all nine taps (``conv3x3_kernel``).  In float32
``csrc/conv3x3_f32.cu`` does the same on the CUDA cores (FFMA: no tensor
core keeps float32's products), with an f32 pre-pass, at one of several
tiles and with the channel reduction split over a thread-block cluster
where the tiles alone leave SMs idle.  The host side lives here:
``conv3x3_plan`` picks the tile (and in float32 the split) per shape and
dtype,
``packed_weight`` keeps the kernel's K-major weight (bf16 or f32, the
activations' dtype) and f32 bias per weight tensor until the weight
changes, ``conv3x3_taps_ref`` is the kernels' algorithm in plain torch.  See
the sources for the kernels' design.  The launch counts are keyed by the
dtype's name as well.

Gates (``conv3x3_ok``, ``conv3x3_vae_ok``) keep the JAX package's shape
rules and its kill switch ``FGDM_DISABLE_PALLAS_CONV`` (``_DISABLE``, read
at import as ``conv.py:32`` reads it: both gates refuse every shape), and
drop its backend test and its VMEM fit model
(``_scoped_vmem``/``_pick_blocks``/``_pick_slabs``), a TPU residency limit.
They take the compute dtype, as JAX's do, and, like JAX's, test none: bf16
and float32 convs take K7 (a dtype K7 lacks, float16, raises in
``conv3x3_kernel``).  Without the fit the port sends a superset of JAX's
convs to its kernel.  Of the served
chain's convs (UNets at batch 8 with CFG), six shapes take K7 here and the
XLA conv on the TPU, all in the UNets' up blocks:
``[8, 960, 32, 32] -> 320`` (factor 1), and in factor 2
``[8, 2560, 16, 16] -> 1280``, ``[8, 1920, 32, 32] -> 640``,
``[8, 640, 64, 64] -> 640`` (the upsample conv), ``[8, 960, 64, 64] -> 320``
and ``[8, 640, 64, 64] -> 320`` (``tests/test_torch_conv.py`` enumerates
the chain's shapes and checks this list).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os
import weakref
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from fgdm_tpu_torch.kernels import _build, graphs
from fgdm_tpu_torch.kernels.attention import dtype_name

__all__ = ["conv3x3_ref", "conv3x3_taps_ref", "conv3x3_kernel", "Conv3x3",
           "conv3x3", "conv3x3_ok", "conv3x3_vae_ok", "conv3x3_plan",
           "ConvPlan", "f32_conv_tile", "f32_resident", "pack_weight",
           "packed_weight", "nchw_to_nhwc", "nchw_to_nhwc_ref",
           "KERNEL_DTYPES"]

SMS = 132                  # streaming multiprocessors of an H100
SMEM_MAX = 232448          # dynamic shared memory one block may have
# The JAX package's kill switch for the conv kernel (conv.py:32).
_DISABLE = os.environ.get("FGDM_DISABLE_PALLAS_CONV", "0") == "1"
_BN, _BK = 128, 64         # the kernel's output-channel tile and channel chunk
_W_TILE = _BN * _BK * 2    # one (chunk, tap) of weights in shared memory
# The float32 kernel (conv3x3_f32.cu): floats a halo pixel, an output
# channel's chunk of weights and the pad of a staged partial's rows take in
# shared memory; its (pixel slots, output channels, blocks an SM) tiles and
# its slice counts (a portable cluster).
_F32_HPS, _F32_WS, _F32_RPAD = 12, 9 * 8 + 4, 16
_F32_TILES = ((128, 128, 1), (128, 64, 2), (64, 64, 2))
_F32_SPLITS = (1, 2, 4, 8)
# ``_f32_cost``'s weights, fitted to ``chip_smoke.py --sweep``'s times of
# every tile and split at the float32 paths' 35 shapes (NVIDIA H100 80GB
# HBM3, 700 W; the plans they pick are within 5 % of each shape's fastest,
# 0.2 % on geometric mean): ms a computed FMA slot of a block while its SM
# holds its most blocks and while it holds one, and the blocks an SM holds;
# ms a round of blocks pays once (its first chunk's latency; the split
# partials' exchange did not show).  Then the blocks resident at once by
# (blocks an SM, slices): whole clusters fit a GPC, so clusters of 4 and 8
# leave SMs idle (``cudaOccupancyMaxActiveClusters``, which
# ``chip_smoke.py --sweep`` prints).
_F32_COST = {(128, 128, 1): (6.4e-9, 6.4e-9, 1),
             (128, 64, 2): (6.8e-9, 7.0e-9, 2),
             (64, 64, 2): (7.4e-9, 8.5e-9, 2)}
_F32_ROUND_MS = 0.005
_F32_RESIDENT = {(1, 1): 132, (1, 2): 132, (1, 4): 120, (1, 8): 120,
                 (2, 1): 264, (2, 2): 264, (2, 4): 248, (2, 8): 240}
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def conv3x3_ref(x, w, b):
    """Plain version (``_xla_conv3x3``): x and w (cast to x's dtype) in f32,
    an f32 conv plus the f32 bias, cast once to x's dtype."""
    out = F.conv2d(x.float(), w.to(x.dtype).float(), b.float(), 1, 1)
    return out.to(x.dtype)


def nchw_to_nhwc_ref(x):
    """Plain version of the pre-pass: ``[N, C, H, W]`` to a contiguous
    ``[N, H, W, C]``."""
    return x.permute(0, 2, 3, 1).contiguous()


def pack_weight(w, b, dtype=torch.bfloat16):
    """The kernel's operands from a conv's parameters: w ``[Co, C, 3, 3]``
    as the K-major matrix ``[Co, 9, C]`` (k = (ky*3 + kx)*C + c) in
    ``dtype`` (the activations') and b as a contiguous f32 copy, in one op
    each."""
    co, c = w.shape[:2]
    # copy=True: in the weight's own dtype ``.to`` returns the permuted view
    wk = w.detach().permute(0, 2, 3, 1).to(
        dtype, memory_format=torch.contiguous_format, copy=True)
    bias = b.detach().to(torch.float32, copy=True).contiguous()
    return wk.view(co, 9, c), bias


def _state(t):
    return (t.data_ptr(), t._version, t.dtype, t.device, tuple(t.shape),
            t.stride())


# weight tensor -> (state, weak reference to the bias, wk, bias); an entry
# goes when its weight dies
_PACKS = WeakTensorKeyDictionary()


def packed_weight(w, b, dtype=torch.bfloat16):
    """``pack_weight(w, b, dtype)``, kept per weight tensor.  A pack is
    reused while the tensors it was made from are alive and unchanged and
    the dtype is the same: same storage, layout and ``_version`` (an
    optimizer step, ``load_state_dict`` or any other in-place write bumps
    it; a write through ``.data`` has a version
    counter of its own and is not seen, so the port never writes parameters
    that way).  The entry is keyed weakly by the weight itself, so a deleted
    module's pack is freed with it, and a changed weight's entry is
    overwritten, which frees its old pack.  A tensor made under
    ``torch.inference_mode`` has no version counter to read and is packed
    anew at every call (the port makes its parameters outside it).  Counts
    the packs it makes in ``packed_weight.packs``.  A CUDA graph captured
    around the call keeps the pack it reads (``graphs.keep``)."""
    keep = not (w.is_inference() or b.is_inference())
    if keep:
        state = (_state(w), _state(b), dtype)
        e = _PACKS.get(w)
        if e is not None and e[0] == state and e[1]() is b:
            graphs.keep(e[2], e[3])
            return e[2], e[3]
    wk, bias = pack_weight(w, b, dtype)
    packed_weight.packs += 1
    if keep:
        _PACKS[w] = (state, weakref.ref(b), wk, bias)
    return wk, bias


packed_weight.packs = 0


def conv3x3_taps_ref(xt, wk, bias):
    """The kernel's algorithm in plain torch: xt ``[N, H, W, C]`` (the
    pre-pass's output), wk ``[Co, 9, C]`` and bias ``[Co]`` f32 (a pack).
    Nine shifted ``[pixels, C] x [C, Co]`` products over a zero halo, summed
    in f32, the f32 bias added before the one rounding to xt's dtype.
    Returns ``[N, Co, H, W]``."""
    n, h, w, _ = xt.shape
    xp = F.pad(xt.float(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((n, h, w, wk.shape[0]), dtype=torch.float32,
                      device=xt.device)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        acc += xp[:, ky:ky + h, kx:kx + w] @ wk[:, tap].float().t()
    out = (acc + bias.float()).to(xt.dtype)
    return out.permute(0, 3, 1, 2).contiguous()


class ConvPlan(NamedTuple):
    """How one conv shape is cut into blocks: ``bm`` pixel slots a block
    (64 or 128: in bf16 one or two consumer warpgroups of one 64-row
    ``wgmma`` tile each), of which the ``th x tw`` rectangle of output
    pixels uses ``th * tw``; ``grid`` = (images x tile rows x tile columns
    x slices, ``bn``-wide output-channel tiles); ``wst`` weight stages
    (float32: 2 stages of halo and weights); ``smem`` bytes of dynamic
    shared memory.  Float32 only: ``bn`` output channels a block (bf16:
    128), ``minb`` blocks an SM the kernel is compiled for, and the
    ``C / 8`` channel chunks cut into ``splits`` slices of ``per`` (one
    thread-block cluster of ``splits`` blocks a pixel x channel tile)."""
    bm: int
    th: int
    tw: int
    tiles_y: int
    tiles_x: int
    grid: tuple
    wst: int
    smem: int
    bn: int = 128
    minb: int = 1
    splits: int = 1
    per: int = 0


def _smem_bytes(bm: int, th: int, tw: int, wst: int) -> int:
    """``smem_bytes`` of ``csrc/conv3x3.cu``: 1 KiB of alignment slack, the
    barriers, the weight ring, and the two halo stages (rounded to the
    swizzle atom) or the epilogue's ``[128][bm + 8]`` tile, whichever is
    larger (they share memory)."""
    halo = 2 * (-(-(th + 2) * (tw + 2) * _BK * 2 // 1024) * 1024)
    return 1024 + 1024 + wst * _W_TILE + max(halo, _BN * (bm + 8) * 2)


# Relative time of a pixel slot by tile size: a 64-slot block streams the
# same weight tiles from L2 as a 128-slot block for half the work (measured
# 1.35-1.6x per slot at the 64^2 and 512^2 planes, NVIDIA H100 80GB HBM3,
# 700 W, ``chip_smoke.py --sweep``).
_SLOT_COST = {64: 1.5, 128: 1.0}


def _tile(n: int, c: int, co: int, h: int, w: int, bm: int) -> ConvPlan:
    """The plan with ``bm`` pixel slots a block: whole rows where w <= 64,
    else 64-pixel row segments; as many rows as fit the slots."""
    tw = min(w, 64)
    th = max(1, min(bm // tw, h))
    wst = 4 if bm == 64 else 6
    tiles_y, tiles_x = -(-h // th), -(-w // tw)
    return ConvPlan(bm, th, tw, tiles_y, tiles_x,
                    (n * tiles_y * tiles_x, -(-co // _BN)), wst,
                    _smem_bytes(bm, th, tw, wst))


def _f32_smem_bytes(th: int, tw: int, bm: int, bn: int,
                    splits: int) -> int:
    """``smem_bytes`` of ``csrc/conv3x3_f32.cu``: two stages of the halo
    tile and the chunk's weights, or a split tile's staged partial
    ``[bn][bm + 16]``, whichever is larger (they share memory)."""
    stages = 2 * 4 * ((th + 2) * (tw + 2) * _F32_HPS + bn * _F32_WS)
    return max(stages, 4 * bn * (bm + _F32_RPAD) if splits > 1 else 0)


def f32_conv_tile(n: int, c: int, co: int, h: int, w: int, bm: int = 128,
                  bn: int = 128, minb: int = 1, splits: int = 1) -> ConvPlan:
    """The float32 kernel's plan at one forced choice: ``bm`` pixel slots
    (whole rows where w <= 64, else 64-pixel row segments, as many rows as
    fit) x ``bn`` output channels a block, compiled for ``minb`` blocks an
    SM, the ``c / 8`` chunks in ``splits`` slices.  Raises ValueError on a
    choice the kernel does not take (the checks of ``conv3x3_f32.cu``'s
    launch): another tile, a split count other than 1, 2, 4 or 8, one that
    would leave a slice empty, or too much shared memory."""
    chunks = c // 8
    per = -(-chunks // splits) if splits >= 1 else 0
    tw = min(w, 64)
    th = max(1, min(bm // tw, h))
    tiles_y, tiles_x = -(-h // th), -(-w // tw)
    smem = _f32_smem_bytes(th, tw, bm, bn, splits)
    if ((bm, bn, minb) not in _F32_TILES or c % 8 or splits not in _F32_SPLITS
            or -(-chunks // per) != splits or smem > SMEM_MAX):
        raise ValueError(f"conv3x3_plan: no float32 tile {bm}x{bn} "
                         f"(minb {minb}) in {splits} slice(s) for "
                         f"{(n, c, co, h, w)} ({smem} B of shared memory)")
    return ConvPlan(bm, th, tw, tiles_y, tiles_x,
                    (n * tiles_y * tiles_x * splits, -(-co // bn)), 2, smem,
                    bn, minb, splits, per)


def _f32_cost(plan: ConvPlan) -> float:
    """The float32 planner's estimate of ``plan``'s ms: the blocks that fit
    the card at once run in rounds; a round costs its blocks' FMA slots
    (computed, idle slots included) at the tile's rate plus a fixed cost;
    where every SM gets at most one block, that block runs alone at its
    own rate."""
    a_full, a_alone, per_sm = _F32_COST[plan.bm, plan.bn, plan.minb]
    blocks = plan.grid[0] * plan.grid[1]
    slots = plan.bm * plan.bn * 72 * plan.per
    at_once = _F32_RESIDENT[per_sm, plan.splits]
    if blocks * per_sm <= at_once:
        return slots * a_alone + _F32_ROUND_MS
    return -(-blocks // at_once) * (per_sm * slots * a_full + _F32_ROUND_MS)


def _f32_plan(n: int, c: int, co: int, h: int, w: int) -> ConvPlan:
    """The float32 plan of least ``_f32_cost`` over every tile and split
    count the kernel takes for the shape."""
    best = None
    for bm, bn, minb in _F32_TILES:
        for splits in _F32_SPLITS:
            try:
                plan = f32_conv_tile(n, c, co, h, w, bm, bn, minb, splits)
            except ValueError:
                continue
            if bm > 64 and plan.th * plan.tw <= bm // 2:
                continue   # the rectangle would leave half the slots idle
            cost = _f32_cost(plan)
            if best is None or cost < best[0]:
                best = (cost, plan)
    if best is None:
        raise ValueError(f"conv3x3_plan: no float32 tile for "
                         f"{(n, c, co, h, w)}")
    return best[1]


@functools.lru_cache(maxsize=None)
def conv3x3_plan(n: int, c: int, co: int, h: int, w: int,
                 dtype: torch.dtype = torch.bfloat16) -> ConvPlan:
    """The tile for x ``[n, c, h, w]`` -> ``co`` channels in ``dtype``.  In
    bf16, among 128 and 64 pixel slots a block it takes the least estimated
    time, the blocks an SM gets times the slots a block computes, among the
    sizes that give every SM a block if any does; in float32 the tile, the
    blocks an SM and the split of the reduction of least ``_f32_cost``
    (``_f32_plan``).  Raises ValueError on a dtype or shape no kernel
    takes."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"conv3x3_plan: no kernel for {dtype}")
    if dtype == torch.float32:
        return _f32_plan(n, c, co, h, w)
    best = None
    for bm in (128, 64):
        plan = _tile(n, c, co, h, w, bm)
        if bm > 64 and plan.th * plan.tw <= bm // 2:
            continue   # the rectangle would leave half the slots idle
        blocks = plan.grid[0] * plan.grid[1]
        cost = (blocks < SMS, -(-blocks // SMS) * bm * _SLOT_COST[bm])
        if best is None or cost < best[0]:
            best = (cost, plan)
    plan = best[1]
    if plan.smem > SMEM_MAX or plan.th * plan.tw > plan.bm:
        raise ValueError(f"conv3x3_plan: no tile for {(n, c, co, h, w)}: "
                         f"{plan}")
    return plan


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3")
    if not getattr(lib, "_fgdm_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fgdm_conv3x3.argtypes = [vp] * 4 + [ci] * 10 + [vp]
        lib.fgdm_conv3x3.restype = ci
        lib.fgdm_nchw_to_nhwc.argtypes = [vp] * 2 + [ci] * 3 + [vp]
        lib.fgdm_nchw_to_nhwc.restype = ci
        lib.fgdm_cuda_error_string.argtypes = [ci]
        lib.fgdm_cuda_error_string.restype = ctypes.c_char_p
        lib._fgdm_typed = True
    return lib


def _f32_lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3_f32")
    if not getattr(lib, "_fgdm_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fgdm_conv3x3_f32.argtypes = [vp] * 4 + [ci] * 13 + [vp]
        lib.fgdm_conv3x3_f32.restype = ci
        lib.fgdm_conv3x3_f32_resident.argtypes = [ci] * 5 + [
            ctypes.POINTER(ci)]
        lib.fgdm_conv3x3_f32_resident.restype = ci
        lib.fgdm_nchw_to_nhwc_f32.argtypes = [vp] * 2 + [ci] * 3 + [vp]
        lib.fgdm_nchw_to_nhwc_f32.restype = ci
        lib.fgdm_cuda_error_string.argtypes = [ci]
        lib.fgdm_cuda_error_string.restype = ctypes.c_char_p
        lib._fgdm_typed = True
    return lib


def f32_resident(plan: ConvPlan) -> int:
    """The blocks of a float32 plan's kernel the current CUDA device holds
    at once in clusters of ``plan.splits`` (``cudaOccupancyMaxActiveClusters``
    times the cluster size): what ``_F32_RESIDENT`` records.  Raises on
    error."""
    lib = _f32_lib()
    out = ctypes.c_int(0)
    rc = lib.fgdm_conv3x3_f32_resident(plan.bm, plan.bn, plan.minb,
                                       plan.splits, plan.smem,
                                       ctypes.byref(out))
    _raise_on(lib, "conv3x3_f32_resident", rc)
    return out.value


def _check_x(fn: str, x) -> None:
    if (x.dtype not in KERNEL_DTYPES or x.dim() != 4
            or not x.is_contiguous()):
        raise ValueError(f"{fn}: x must be a contiguous 4-d bf16 or float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if x.shape[1] % 8:
        raise ValueError(f"{fn}: C={x.shape[1]} must be a multiple of 8")


def _raise_on(lib, fn: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           + lib.fgdm_cuda_error_string(rc).decode())


def nchw_to_nhwc(x):
    """The conv's pre-pass: x ``[N, C, H, W]`` bf16 or float32 to a
    contiguous ``[N, H, W, C]`` by a hand-written tiled transpose.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises.  Counts launches in ``nchw_to_nhwc.launches`` keyed by
    ``(N, C, H, W, dtype name)``."""
    if x.device.type == "cpu":
        return nchw_to_nhwc_ref(x)
    _check_x("nchw_to_nhwc", x)
    n, c, h, wd = x.shape
    xt = torch.empty((n, h, wd, c), device=x.device, dtype=x.dtype)
    f32 = x.dtype == torch.float32
    lib = _f32_lib() if f32 else _lib()
    fn = lib.fgdm_nchw_to_nhwc_f32 if f32 else lib.fgdm_nchw_to_nhwc
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), xt.data_ptr(), n, c, h * wd, stream)
    _raise_on(lib, "nchw_to_nhwc", rc)
    graphs.count(nchw_to_nhwc, (n, c, h, wd, dtype_name(x.dtype)))
    return xt


nchw_to_nhwc.launches = collections.Counter()


def _launch(xt, wk, bias, co: int, plan: ConvPlan):
    """The conv kernel of xt's dtype (``wgmma`` in bf16, FFMA in float32)
    on xt ``[N, H, W, C]`` and a weight pack with the tile ``plan``;
    returns ``[N, co, H, W]`` or raises."""
    n, h, wd, c = xt.shape
    out = torch.empty((n, co, h, wd), device=xt.device, dtype=xt.dtype)
    stream = torch.cuda.current_stream(xt.device).cuda_stream
    ptrs = (xt.data_ptr(), wk.data_ptr(), bias.data_ptr(), out.data_ptr())
    with torch.cuda.device(xt.device):
        if xt.dtype == torch.float32:
            lib = _f32_lib()
            rc = lib.fgdm_conv3x3_f32(*ptrs, n, c, co, h, wd, plan.bm,
                                      plan.bn, plan.minb, plan.th, plan.tw,
                                      plan.splits, plan.per, plan.smem,
                                      stream)
        else:
            lib = _lib()
            rc = lib.fgdm_conv3x3(*ptrs, n, c, co, h, wd, plan.bm, plan.th,
                                  plan.tw, plan.wst, plan.smem, stream)
    _raise_on(lib, "conv3x3_kernel", rc)
    return out


def conv3x3_kernel(x, w, b):
    """The 3x3 conv through K7 in x's dtype (bf16 or float32): the pre-pass
    into ``[N, H, W, C]`` scratch, then the conv kernel on the weight's pack
    (``packed_weight``: made once per weight and dtype, not per call) with
    the tile of ``conv3x3_plan``.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernels or raises.

    Counts launches in ``conv3x3_kernel.launches`` keyed by
    ``(N, C, Co, H, W, dtype name)``."""
    if x.device.type == "cpu":
        return conv3x3_ref(x, w, b)
    fn = "conv3x3_kernel"
    _check_x(fn, x)
    n, c, h, wd = x.shape
    co = w.shape[0]
    if tuple(w.shape) != (co, c, 3, 3) or tuple(b.shape) != (co,):
        raise ValueError(f"{fn}: w {tuple(w.shape)} and b {tuple(b.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"{fn}: w and b must be on {x.device}")
    plan = conv3x3_plan(n, c, co, h, wd, x.dtype)
    wk, bias = packed_weight(w, b, x.dtype)
    out = _launch(nchw_to_nhwc(x), wk, bias, co, plan)
    graphs.count(conv3x3_kernel, (n, c, co, h, wd, dtype_name(x.dtype)))
    return out


conv3x3_kernel.launches = collections.Counter()


class Conv3x3(torch.autograd.Function):
    """Differentiable 3x3 conv (the ``custom_vjp`` ``conv3x3``,
    ``conv.py:288-329``).  The forward is ``conv3x3_kernel``; the backward
    is ``_conv3x3_vjp_bwd`` in plain torch, as the JAX package computes it
    outside Pallas: dx and dw from f32 conv gradients against the weight
    cast to x's dtype (dx in x's dtype, dw rounded to x's dtype, then to
    w's), db an f32 sum; each only where its input needs it."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return conv3x3_kernel(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        gf = g.float()
        dx = dw = db = None
        if need_x:
            dx = torch.nn.grad.conv2d_input(
                x.shape, w.to(x.dtype).float(), gf, 1, 1).to(x.dtype)
        if need_w:
            dw = torch.nn.grad.conv2d_weight(x.float(), w.shape, gf, 1, 1)
            dw = dw.to(x.dtype).to(w.dtype)
        if need_b:
            db = gf.sum(dim=(0, 2, 3))
        return dx, dw, db


def conv3x3(x, w, b):
    """3x3 stride-1 SAME conv with bias.  A CPU tensor takes
    ``conv3x3_ref``; a CUDA tensor launches K7 or raises, through
    ``Conv3x3`` when an input needs a gradient."""
    if x.device.type == "cpu":
        return conv3x3_ref(x, w, b)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return Conv3x3.apply(x, w, b)
    return conv3x3_kernel(x, w, b)


def _is3x3(x_shape, w_shape) -> bool:
    return (len(x_shape) == 4 and len(w_shape) == 4
            and tuple(w_shape[2:]) == (3, 3) and w_shape[1] == x_shape[1])


def conv3x3_ok(x_shape, w_shape, dtype) -> bool:
    """Whole-plane gate (``conv.py:131-154`` without the backend test and
    the VMEM fit, the only use of ``dtype`` there): x ``[N, C, H, W]``, w
    ``[Co, C, 3, 3]``; C, Co >= 128, both multiples of 8, 16 <= H <= 64;
    none with ``_DISABLE``."""
    if _DISABLE or not _is3x3(x_shape, w_shape):
        return False
    co, c, h = w_shape[0], x_shape[1], x_shape[2]
    return c >= 128 and co >= 128 and c % 8 == 0 and co % 8 == 0 \
        and 16 <= h <= 64


def conv3x3_vae_ok(x_shape, w_shape, dtype) -> bool:
    """VAE-family gate (``conv.py:244-276`` without the backend test and
    the slab fit, the only use of ``dtype`` there): C = Co = 128 and
    H >= 512 (the decoder's level-0 ResBlocks); none with ``_DISABLE``."""
    if _DISABLE or not _is3x3(x_shape, w_shape):
        return False
    return x_shape[1] == 128 and w_shape[0] == 128 and x_shape[2] >= 512
