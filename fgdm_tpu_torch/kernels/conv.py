"""Direct 3x3 convolution (stride 1, SAME, bias): plain version, the
hand-written CUDA kernel (K7), its autograd Function, gates.

Counterpart of ``fgdm_tpu/kernels/conv.py``.  Layouts are the port's: x
``[N, C, H, W]``, w ``[Co, C, 3, 3]`` (OIHW, any float dtype, cast to x's
dtype), b ``[Co]`` kept in float32; the output is ``[N, Co, H, W]`` in x's
dtype.  The f32 bias is added to the f32 sum before the single cast, as the
JAX kernel does (``conv.py:120-121``); the ``F.conv2d`` path of ``Conv2d``
adds a bias already cast to bf16.

``csrc/conv3x3.cu``: one CUDA kernel, an implicit GEMM straight over NCHW,
stands in for the TPU kernel ``_kernel`` (``conv.py:100``) behind both of
its callers, ``_conv3x3_fwd`` (whole planes) and ``_conv3x3_slab_fwd``
(height/width slabs with a one-row halo).  The padded copy and the slabs
existed for VMEM residency; the kernel zero-fills the halo by bounds checks.
See the source for its design.

Gates (``conv3x3_ok``, ``conv3x3_vae_ok``) keep the JAX package's shape
rules and drop its backend test and its VMEM fit model
(``_scoped_vmem``/``_pick_blocks``/``_pick_slabs``), a TPU residency limit.
They take the compute dtype, as JAX's do, and admit bfloat16 only: K7 reads
bf16 activations, so a float32 model keeps ``F.conv2d`` by the gate's
decision (JAX's Pallas kernel also runs float32).  At bf16 the port sends a
superset of JAX's convs to its kernel.  Of the served
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

import torch
import torch.nn.functional as F

from fgdm_tpu_torch.kernels import _build

__all__ = ["conv3x3_ref", "conv3x3_kernel", "Conv3x3", "conv3x3",
           "conv3x3_ok", "conv3x3_vae_ok"]


def conv3x3_ref(x, w, b):
    """Plain version (``_xla_conv3x3``): x and w (cast to x's dtype) in f32,
    an f32 conv plus the f32 bias, cast once to x's dtype."""
    out = F.conv2d(x.float(), w.to(x.dtype).float(), b.float(), 1, 1)
    return out.to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3")
    if not getattr(lib, "_fgdm_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fgdm_conv3x3.argtypes = [vp] * 4 + [ci] * 5 + [vp]
        lib.fgdm_conv3x3.restype = ci
        lib.fgdm_cuda_error_string.argtypes = [ci]
        lib.fgdm_cuda_error_string.restype = ctypes.c_char_p
        lib._fgdm_typed = True
    return lib


def conv3x3_kernel(x, w, b):
    """The 3x3 conv through K7.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises.  The weight is rearranged to
    the kernel's K-major ``[Co, 3, 3, C]`` bf16 copy in one op with its
    cast, once per call (training changes the weights).

    Counts launches in ``conv3x3_kernel.launches`` keyed by
    ``(N, C, Co, H, W)``."""
    if x.device.type == "cpu":
        return conv3x3_ref(x, w, b)
    fn = "conv3x3_kernel"
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{fn}: x must be a contiguous 4-d bf16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    n, c, h, wd = x.shape
    co = w.shape[0]
    if tuple(w.shape) != (co, c, 3, 3) or tuple(b.shape) != (co,):
        raise ValueError(f"{fn}: w {tuple(w.shape)} and b {tuple(b.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"{fn}: w and b must be on {x.device}")
    if c % 8:
        raise ValueError(f"{fn}: C={c} must be a multiple of 8")
    wk = w.detach().permute(0, 2, 3, 1).to(
        torch.bfloat16, memory_format=torch.contiguous_format)
    bias = b.detach().float().contiguous()
    out = torch.empty((n, co, h, wd), device=x.device, dtype=x.dtype)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.fgdm_conv3x3(x.data_ptr(), wk.data_ptr(), bias.data_ptr(),
                              out.data_ptr(), n, c, co, h, wd, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           + lib.fgdm_cuda_error_string(rc).decode())
    conv3x3_kernel.launches[(n, c, co, h, wd)] += 1
    return out


conv3x3_kernel.launches = collections.Counter()


class Conv3x3(torch.autograd.Function):
    """Differentiable 3x3 conv (the ``custom_vjp`` ``conv3x3``,
    ``conv.py:288-329``).  The forward is ``conv3x3_kernel``; the backward
    is ``_conv3x3_vjp_bwd`` in plain torch, as the JAX package computes it
    outside Pallas: dx and dw from f32 conv gradients against the weight
    cast to x's dtype (dx in x's dtype, dw rounded to x's dtype, then to
    w's), db an f32 sum."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return conv3x3_kernel(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gf = g.float()
        wf = w.to(x.dtype).float()
        dx = torch.nn.grad.conv2d_input(x.shape, wf, gf, 1, 1).to(x.dtype)
        dw = torch.nn.grad.conv2d_weight(x.float(), w.shape, gf, 1, 1)
        db = gf.sum(dim=(0, 2, 3))
        return dx, dw.to(x.dtype).to(w.dtype), db


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
    the VMEM fit): x ``[N, C, H, W]`` in bf16, w ``[Co, C, 3, 3]``; C,
    Co >= 128, both multiples of 8, 16 <= H <= 64."""
    if dtype != torch.bfloat16 or not _is3x3(x_shape, w_shape):
        return False
    co, c, h = w_shape[0], x_shape[1], x_shape[2]
    return c >= 128 and co >= 128 and c % 8 == 0 and co % 8 == 0 \
        and 16 <= h <= 64


def conv3x3_vae_ok(x_shape, w_shape, dtype) -> bool:
    """VAE-family gate (``conv.py:244-276`` without the backend test and
    the slab fit): x in bf16, C = Co = 128 and H >= 512 (the decoder's
    level-0 ResBlocks)."""
    if dtype != torch.bfloat16 or not _is3x3(x_shape, w_shape):
        return False
    return x_shape[1] == 128 and w_shape[0] == 128 and x_shape[2] >= 512
