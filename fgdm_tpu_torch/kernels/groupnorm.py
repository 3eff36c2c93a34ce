"""Fused GroupNorm(+SiLU): plain version, the hand-written CUDA kernel (K4),
its launch plan, its autograd Function, gate.

Counterpart of ``fgdm_tpu/kernels/groupnorm.py``, in NCHW.
``group_norm_silu`` routes by the JAX package's gate (``groupnorm.py:260-270``:
C % G == 0 and C >= 128) on CUDA tensors, and to ``group_norm_silu_ref``
otherwise.  Through the kernel, inputs that need a gradient go through
``GroupNormSiLU`` (the counterpart of the ``custom_vjp`` ``_fused_op``,
``groupnorm.py:226-246``): its forward launches the kernel, its backward is
the VJP of ``group_norm_silu_ref``, as the JAX package's is the VJP of
``_xla_group_norm``; the TPU has no backward kernel for it either.

``csrc/groupnorm_silu.cu`` replaces ``fgdm_tpu/kernels/groupnorm.py:68
_kernel``.  In NCHW each (batch, group) is one contiguous span of
``C/G * H * W`` elements, so the TPU's one-hot matmul for the group
reduction is not needed.  One launch a call: a thread-block cluster of k
blocks per (batch, group), each block loading its slice of the span into
shared memory once; the blocks exchange their partial statistics through
distributed shared memory where the TPU carried them in VMEM scratch over
its sequential grid.  ``gn_plan`` sizes the launch per shape (see the source
for the kernel's design).

The TPU kernel's tile knobs have no counterpart here: ``FGDM_GN_ROW_CHUNK``,
``FGDM_GN_CHUNK_ELEMS`` and ``FGDM_GN_NATIVE_4D`` size or lay out its VMEM
blocks (``groupnorm.py:42,51,56``); ``gn_plan`` sizes the clusters.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from fgdm_tpu_torch.kernels import _build, graphs

__all__ = ["group_norm_silu_ref", "group_norm_silu_kernel", "GroupNormSiLU",
           "use_fused_gn", "group_norm_silu", "gn_plan", "gn_tile", "GNPlan",
           "card_plan"]

# The source's constants (``csrc/groupnorm_silu.cu``; a test reads them):
_SMEM_BLOCK = 232448   # dynamic shared memory one block may take
_HEADER = 1024         # barriers, the block's triple, reduction scratch
_MAX_THREADS = 512
_CLUSTERS = (1, 2, 4, 8, 16)   # 16 is a non-portable cluster size
# An H100 SM's shared memory, of which each resident block costs the
# system 1 KiB more than it asks for.
_SMEM_SM = 233472
_SMEM_RESERVED = 1024
# The plan's own: blocks that share an SM (so that one block's loads
# overlap another's sums and stores; ``chip_smoke.py --sweep`` times 1 to
# 4), about one wave of blocks (B*G is a multiple of 32 on every path, so
# no power-of-two k gives 129-132), and no split of a group into slices of
# fewer bytes than this.
_PER_SM = 2
_MIN_BLOCKS = 128
_MIN_SLICE = 4096
_ESIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def group_norm_silu_ref(x, weight, bias, num_groups: int = 32,
                        eps: float = 1e-5, apply_silu: bool = True):
    """Plain version (``_xla_group_norm``): statistics, affine and SiLU in
    f32, one cast back to x's dtype.  x is ``[B, C, *spatial]``."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, num_groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, correction=0, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    bshape = (1, c) + (1,) * (x.dim() - 2)
    y = (xf.reshape(x.shape) * weight.float().reshape(bshape)
         + bias.float().reshape(bshape))
    if apply_silu:
        y = F.silu(y)
    return y.to(x.dtype)


class GNPlan(NamedTuple):
    """How one shape is launched: a cluster of ``k`` blocks of ``threads``
    per (batch, group); block ``r`` owns elements ``[r*slice, (r+1)*slice)``
    of its group's ``span`` (the last block fewer) and keeps the first
    ``resident`` of them in ``smem`` bytes of shared memory, at most its
    share of an SM shared by ``per_sm`` blocks; ``streams``: some block
    reads the rest of its slice from device memory twice; ``aligned``: the
    span is a whole number of 16-byte vectors, so the kernel takes bulk
    copies and 16-byte accesses (x's address permitting); ``blocks`` =
    batch * groups * k."""
    k: int
    per_sm: int
    threads: int
    span: int
    slice: int
    resident: int
    smem: int
    streams: bool
    aligned: bool
    blocks: int


def _table_bytes(cpg: int) -> int:
    """``table_bytes`` of the source: the f32 (mul, add) of each channel of
    a group, rounded to 16 bytes."""
    return -(-8 * cpg // 16) * 16


def gn_tile(shape, dtype, num_groups: int, k: int,
            per_sm: int = _PER_SM) -> GNPlan:
    """The launch for x of ``shape`` ``[B, C, *spatial]`` and ``dtype`` at
    cluster size ``k``: slices of the span cut into whole 16-byte vectors,
    as much of each resident as fits one block's share of an SM shared by
    ``per_sm`` blocks (less the header and the channel table), about eight
    vectors a thread (128 to ``_MAX_THREADS`` threads)."""
    if len(shape) < 3 or shape[1] % num_groups:
        raise ValueError(f"gn_plan: shape {tuple(shape)} with {num_groups} "
                         "groups")
    if dtype not in _ESIZE:
        raise ValueError(f"gn_plan: dtype {dtype}")
    if k not in _CLUSTERS or per_sm < 1:
        raise ValueError(f"gn_plan: cluster size {k}, {per_sm} a SM")
    esize = _ESIZE[dtype]
    vec = 16 // esize
    cpg = shape[1] // num_groups
    span = cpg * math.prod(shape[2:])
    budget = min(_SMEM_BLOCK, _SMEM_SM // per_sm - _SMEM_RESERVED)
    room = (budget - _HEADER - _table_bytes(cpg)) // 16 * 16 // esize
    if room < vec or span >= 2 ** 31:
        raise ValueError(f"gn_plan: no launch for {tuple(shape)} {dtype}")
    sl = -(-(-(-span // k)) // vec) * vec
    resident = min(sl, room)
    threads = min(_MAX_THREADS, max(128, -(-sl // (vec * 8 * 128)) * 128))
    return GNPlan(k, per_sm, threads, span, sl, resident,
                  _HEADER + _table_bytes(cpg) + resident * esize, sl > room,
                  span * esize % 16 == 0, shape[0] * num_groups * k)


@functools.lru_cache(maxsize=None)
def gn_plan(shape, dtype, num_groups: int = 32, max_k: int = 16) -> GNPlan:
    """The launch ``group_norm_silu_kernel`` takes: the smallest cluster
    size k in ``_CLUSTERS`` (up to ``max_k``) whose slices fit resident and
    that gives about one wave of blocks (B*G*k >= ``_MIN_BLOCKS``), or
    whose slices are already down to ``_MIN_SLICE`` bytes; else ``max_k``,
    streaming the part of each slice that does not fit."""
    esize = _ESIZE.get(dtype, 1)
    ks = [k for k in _CLUSTERS if k <= max_k]
    for k in ks:
        plan = gn_tile(shape, dtype, num_groups, k)
        if not plan.streams and (plan.blocks >= _MIN_BLOCKS
                                 or plan.slice * esize <= _MIN_SLICE):
            return plan
    return gn_tile(shape, dtype, num_groups, ks[-1])


def _lib() -> ctypes.CDLL:
    lib = _build.load("groupnorm_silu")
    if not getattr(lib, "_fgdm_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fgdm_group_norm_silu.argtypes = (
            [vp] * 4 + [ci] * 13 + [ctypes.c_float, vp])
        lib.fgdm_group_norm_silu.restype = ci
        lib.fgdm_gn_max_active_clusters.argtypes = (
            [ci] * 4 + [ctypes.POINTER(ci)])
        lib.fgdm_gn_max_active_clusters.restype = ci
        lib.fgdm_cuda_error_string.argtypes = [ci]
        lib.fgdm_cuda_error_string.restype = ctypes.c_char_p
        lib._fgdm_typed = True
    return lib


def _raise_on(lib, fn: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           + lib.fgdm_cuda_error_string(rc).decode())


def max_active_clusters(dtype, plan: GNPlan) -> int:
    """How many of ``plan``'s clusters the current card holds at once
    (``cudaOccupancyMaxActiveClusters``); 0: they do not schedule."""
    lib = _lib()
    out = ctypes.c_int(0)
    _raise_on(lib, "max_active_clusters", lib.fgdm_gn_max_active_clusters(
        _DTYPE_CODE[dtype], plan.k, plan.threads, plan.smem,
        ctypes.byref(out)))
    return out.value


@functools.lru_cache(maxsize=None)
def card_plan(shape, dtype, num_groups: int = 32) -> GNPlan:
    """``gn_plan`` as the current card runs it: clusters of 8 (streaming
    more) where one of 16 does not schedule; raises if the plan's clusters
    do not schedule at all.  The replan is for cards with less shared
    memory or fewer SMs a cluster than the H100, where it is never taken:
    clusters of 16 schedule at every shape of its paths (``chip_smoke.py
    --sweep`` prints how many fit at once)."""
    plan = gn_plan(shape, dtype, num_groups)
    if plan.k == _CLUSTERS[-1] and max_active_clusters(dtype, plan) < 1:
        plan = gn_plan(shape, dtype, num_groups, max_k=_CLUSTERS[-2])
    if max_active_clusters(dtype, plan) < 1:
        raise RuntimeError(f"group_norm_silu: clusters of {plan.k} blocks "
                           f"with {plan.smem} bytes do not schedule here")
    return plan


def _launch(x, weight, bias, num_groups, eps, apply_silu, plan: GNPlan):
    """The kernel on checked operands with ``plan``; returns y or raises.

    It runs once per GroupNorm of every path, thousands of times a chain,
    so it reads the raw stream handle (``torch.cuda.current_stream`` builds
    a Stream object) and enters x's device only when another one is current
    (``torch.cuda.device`` costs microseconds even when it changes nothing;
    ``chip_smoke.py`` prints both)."""
    y = torch.empty_like(x)
    lib = _lib()
    dev = x.device.index
    cpg = x.shape[1] // num_groups
    args = (x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            _DTYPE_CODE[x.dtype], bool(apply_silu), x.shape[0] * num_groups,
            num_groups, cpg, plan.span // cpg, plan.span, plan.slice,
            plan.resident, plan.k, plan.threads, plan.smem,
            plan.aligned and x.data_ptr() % 16 == 0, float(eps),
            torch._C._cuda_getCurrentRawStream(dev))
    if dev == torch.cuda.current_device():
        rc = lib.fgdm_group_norm_silu(*args)
    else:   # the C entry launches on the current device
        with torch.cuda.device(dev):
            rc = lib.fgdm_group_norm_silu(*args)
    _raise_on(lib, "group_norm_silu", rc)
    return y


def group_norm_silu_kernel(x, weight, bias, num_groups: int = 32,
                           eps: float = 1e-5, apply_silu: bool = True):
    """Fused GroupNorm+affine(+SiLU).  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel (one launch, counted in
    ``group_norm_silu_kernel.launches`` keyed by ``(shape, eps, dtype
    name)``) or raises.  x is contiguous ``[B, C, *spatial]`` in bf16, f16 or f32;
    weight and bias f32 ``[C]``."""
    if x.device.type == "cpu":
        return group_norm_silu_ref(x, weight, bias, num_groups, eps,
                                   apply_silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu: unsupported device {x.device}")
    shape = tuple(x.shape)
    if len(shape) < 3 or shape[1] % num_groups:
        raise ValueError(f"group_norm_silu: shape {shape} with "
                         f"{num_groups} groups")
    if not x.is_contiguous():
        raise ValueError("group_norm_silu: x must be contiguous NCHW")
    if x.dtype not in _ESIZE:
        raise ValueError(f"group_norm_silu: dtype {x.dtype}")
    for name, p in (("weight", weight), ("bias", bias)):
        if (p.shape != shape[1:2] or p.device != x.device
                or p.dtype != torch.float32 or not p.is_contiguous()):
            raise ValueError(f"group_norm_silu: {name} must be f32 [C] "
                             f"contiguous on {x.device}")
    y = _launch(x, weight, bias, num_groups, eps, apply_silu,
                card_plan(shape, x.dtype, num_groups))
    graphs.count(group_norm_silu_kernel,
                 (shape, float(eps), str(x.dtype).removeprefix("torch.")))
    return y


group_norm_silu_kernel.launches = collections.Counter()


class GroupNormSiLU(torch.autograd.Function):
    """Differentiable fused GroupNorm+affine(+SiLU) (``_fused_op``): the
    kernel forward, the plain version's VJP backward (recomputed from the
    saved input, for the inputs that need a gradient)."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, apply_silu):
        ctx.save_for_backward(x, weight, bias)
        ctx.cfg = (num_groups, eps, apply_silu)
        return group_norm_silu_kernel(x, weight, bias, num_groups, eps,
                                      apply_silu)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[:3]
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            y = group_norm_silu_ref(*inputs, *ctx.cfg)
        grads = iter(torch.autograd.grad(
            y, [t for t in inputs if t.requires_grad], grad))
        return (*(next(grads) if n else None for n in need), None, None, None)


def use_fused_gn(x, num_groups: int = 32) -> bool:
    """The gate of ``groupnorm.py:260-270`` on this card: CUDA tensors with
    C % G == 0 and C >= 128."""
    c = x.shape[1]
    return x.device.type == "cuda" and c % num_groups == 0 and c >= 128


def group_norm_silu(x, weight, bias, num_groups: int = 32, eps: float = 1e-5,
                    apply_silu: bool = True,
                    use_kernel: Optional[bool] = None):
    """GroupNorm -> affine -> (SiLU) over ``[B, C, *spatial]``.

    ``use_kernel=None`` applies the gate; True/False force the kernel or the
    plain version (the counterpart of JAX's ``use_fused=``).  Through the
    kernel, inputs that need a gradient go through ``GroupNormSiLU``."""
    if use_kernel is None:
        use_kernel = use_fused_gn(x, num_groups)
    if not use_kernel:
        return group_norm_silu_ref(x, weight, bias, num_groups, eps,
                                   apply_silu)
    args = (x.contiguous(), weight.float(), bias.float(), num_groups,
            float(eps), bool(apply_silu))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:3]):
        return GroupNormSiLU.apply(*args)
    return group_norm_silu_kernel(*args)
