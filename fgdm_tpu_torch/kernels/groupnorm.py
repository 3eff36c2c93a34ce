"""Fused GroupNorm(+SiLU): plain version, hand-written Triton kernel, its
autograd Function, gate.

Counterpart of ``fgdm_tpu/kernels/groupnorm.py``, in NCHW.
``group_norm_silu`` routes by the JAX package's gate (``groupnorm.py:260-270``:
C % G == 0 and C >= 128) on CUDA tensors, and to ``group_norm_silu_ref``
otherwise.  Through the kernel, inputs that need a gradient go through
``GroupNormSiLU`` (the counterpart of the ``custom_vjp`` ``_fused_op``,
``groupnorm.py:226-246``): its forward launches the kernel, its backward is
the VJP of ``group_norm_silu_ref``, as the JAX package's is the VJP of
``_xla_group_norm``; the TPU has no backward kernel for it either.

The kernel replaces ``fgdm_tpu/kernels/groupnorm.py:68 _kernel``.  In NCHW
each (batch, group) is one contiguous span of ``C/G * H * W`` elements, so
the TPU's one-hot matmul for the group reduction is not needed.  Two Triton
programs, both on the grid (B*G, SPLIT):

* ``_gn_partial_sums``: each program sums x and x^2 over one slice of its
  group in f32 and writes the pair.  Splitting the span keeps the card busy
  when groups are huge (1M elements per group in the 512^2 VAE planes) and
  few.
* ``_gn_apply``: each program folds its group's SPLIT partials into mean and
  rstd (var = E[x^2] - mean^2, as the TPU kernel), then normalises, applies
  the per-channel affine and SiLU in f32, and writes its slice with one cast.

What bounds it on the card: memory.  It reads the activation twice and
writes it once, against one read and one write at the bound; no tensor
cores.  The second read often hits the 50 MB L2.

The TPU kernel's tile knobs have no counterpart here: ``FGDM_GN_ROW_CHUNK``,
``FGDM_GN_CHUNK_ELEMS`` and ``FGDM_GN_NATIVE_4D`` size or lay out its VMEM
blocks (``groupnorm.py:42,51,56``); ``launch_geometry`` sizes the Triton
programs.

The programs are plain functions here and become Triton kernels in
``_programs()`` at the first launch: this module imports without Triton,
which exists only where the card is.  Their bodies name ``tl``, the module
global that ``_programs()`` binds to ``triton.language``.
"""

from __future__ import annotations

import collections
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["group_norm_silu_ref", "group_norm_silu_kernel", "GroupNormSiLU",
           "use_fused_gn", "group_norm_silu"]

_BLOCK = 1024
_MAX_SPLIT = 64
_SPLIT_ELEMS = 16384  # elements per program before a group is split

tl = None  # triton.language, bound by _programs() at the first launch


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


def _gn_partial_sums(x_ptr, part_ptr, group_numel, chunk,
                     SPLIT: "tl.constexpr", BLOCK: "tl.constexpr"):
    g = tl.program_id(0)
    s = tl.program_id(1)
    base = x_ptr + g.to(tl.int64) * group_numel
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK], dtype=tl.float32)
    start = s * chunk
    for off in range(start, start + chunk, BLOCK):
        idx = off + tl.arange(0, BLOCK)
        x = tl.load(base + idx, mask=idx < group_numel, other=0.0)
        x = x.to(tl.float32)
        acc += x
        acc2 += x * x
    out = part_ptr + (g * SPLIT + s) * 2
    tl.store(out, tl.sum(acc, axis=0))
    tl.store(out + 1, tl.sum(acc2, axis=0))


def _gn_apply(x_ptr, y_ptr, w_ptr, b_ptr, part_ptr, group_numel, hw, cpg,
              num_groups, chunk, inv_count, eps,
              SPLIT: "tl.constexpr", BLOCK: "tl.constexpr",
              APPLY_SILU: "tl.constexpr"):
    g = tl.program_id(0)
    s = tl.program_id(1)
    parts = part_ptr + g * SPLIT * 2 + tl.arange(0, SPLIT) * 2
    mean = tl.sum(tl.load(parts), axis=0) * inv_count
    ex2 = tl.sum(tl.load(parts + 1), axis=0) * inv_count
    var = tl.maximum(ex2 - mean * mean, 0.0)
    rstd = tl.rsqrt(var + eps)
    c0 = (g % num_groups) * cpg
    base = g.to(tl.int64) * group_numel
    start = s * chunk
    for off in range(start, start + chunk, BLOCK):
        idx = off + tl.arange(0, BLOCK)
        m = idx < group_numel
        ch = c0 + idx // hw
        w = tl.load(w_ptr + ch, mask=m, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + ch, mask=m, other=0.0).to(tl.float32)
        x = tl.load(x_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
        mul = rstd * w
        y = x * mul + (b - mean * mul)
        if APPLY_SILU:
            y = y * tl.sigmoid(y)
        tl.store(y_ptr + base + idx, y.to(y_ptr.dtype.element_ty), mask=m)


@functools.lru_cache(maxsize=None)
def _programs():
    """Import Triton and wrap the two programs (once)."""
    global tl
    import triton
    import triton.language

    tl = triton.language
    return triton.jit(_gn_partial_sums), triton.jit(_gn_apply)


def launch_geometry(shape, num_groups: int = 32):
    """``(group_numel, split, chunk)`` of a launch over ``shape``: each
    (batch, group) span of ``group_numel`` elements is cut into ``split``
    slices of ``chunk`` elements (a multiple of the block), the last one
    masked at the span's end."""
    group_numel = (shape[1] // num_groups) * math.prod(shape[2:])
    split = 1
    while split < _MAX_SPLIT and group_numel > split * _SPLIT_ELEMS:
        split *= 2
    chunk = -(-group_numel // split)
    return group_numel, split, -(-chunk // _BLOCK) * _BLOCK


def group_norm_silu_kernel(x, weight, bias, num_groups: int = 32,
                           eps: float = 1e-5, apply_silu: bool = True):
    """Fused GroupNorm+affine(+SiLU).  A CPU tensor takes the plain version;
    a CUDA tensor launches the Triton kernel or raises.

    One launch (counted in ``group_norm_silu_kernel.launches`` keyed by
    ``(shape, eps)``) runs the two Triton programs: partial sums, then
    normalise."""
    if x.device.type == "cpu":
        return group_norm_silu_ref(x, weight, bias, num_groups, eps,
                                   apply_silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu: unsupported device {x.device}")
    b, c = x.shape[:2]
    if x.dim() < 3 or c % num_groups:
        raise ValueError(f"group_norm_silu: shape {tuple(x.shape)} with "
                         f"{num_groups} groups")
    if not x.is_contiguous():
        raise ValueError("group_norm_silu: x must be contiguous NCHW")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"group_norm_silu: dtype {x.dtype}")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.shape != (c,) or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"group_norm_silu: {name} must be [C] contiguous "
                             f"on {x.device}")
    partial_sums, apply = _programs()
    hw = x[0, 0].numel()
    group_numel, split, chunk = launch_geometry(x.shape, num_groups)
    y = torch.empty_like(x)
    parts = torch.empty((b * num_groups, split, 2), device=x.device,
                        dtype=torch.float32)
    grid = (b * num_groups, split)
    with torch.cuda.device(x.device):
        partial_sums[grid](x, parts, group_numel, chunk, SPLIT=split,
                           BLOCK=_BLOCK, num_warps=4)
        apply[grid](x, y, weight, bias, parts, group_numel, hw,
                    c // num_groups, num_groups, chunk, 1.0 / group_numel,
                    float(eps), SPLIT=split, BLOCK=_BLOCK,
                    APPLY_SILU=bool(apply_silu), num_warps=4)
    group_norm_silu_kernel.launches[(tuple(x.shape), float(eps))] += 1
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
