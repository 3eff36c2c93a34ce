"""Multi-head attention: plain version, hand-written CUDA flash kernel, gate.

Counterpart of ``fgdm_tpu/kernels/attention.py``.  ``multihead_attention``
takes q ``[B, H, Nq, D]`` and k/v ``[B, H, Nk, D]`` and returns
``[B, H, Nq, D]`` in q's dtype.  It routes to the flash kernel
(``csrc/flash_attn_fwd.cu``) by the JAX package's gate
(``attention.py:660-673``: Nq >= 512, Nk >= 512, Nk % 512 == 0) on CUDA
tensors, and to ``attention_ref`` otherwise (cross-attention over 77 keys,
the N < 512 self-attentions, the CPU).  The kernel takes bf16 and the head
dims in ``KERNEL_HEAD_DIMS``; anything else through the gate raises.

One CUDA kernel stands in for the three TPU forward kernels
(``_flash_kernel_t``, ``_flash_kernel``, ``_flash_kernel_kv``): their split
existed for TPU lane padding and VMEM residency, which have no counterpart
on the GPU.  See the source for its design.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional

import torch

from fgdm_tpu_torch.kernels import _build

__all__ = ["attention_ref", "flash_attention", "use_flash",
           "multihead_attention", "KERNEL_HEAD_DIMS"]

# Head dims the CUDA source instantiates: the chain's self-attention heads
# at N >= 512 (SD-1.x UNet levels 0 and 1, the VAE's single 512-wide head).
KERNEL_HEAD_DIMS = (40, 80, 512)
_MIN_N = 512


def attention_ref(q, k, v, scale):
    """Plain version (``_xla_attention``): f32 scores and softmax, the
    probabilities cast to v's dtype for the P.V product."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(sim, dim=-1)
    return torch.matmul(attn.to(v.dtype), v)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn_fwd")
    if not getattr(lib, "_fgdm_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fgdm_flash_attn_fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                            ctypes.c_float, vp]
        lib.fgdm_flash_attn_fwd.restype = ci
        lib.fgdm_flash_attn_block_n.argtypes = [ci]
        lib.fgdm_flash_attn_block_n.restype = ci
        lib.fgdm_cuda_error_string.argtypes = [ci]
        lib.fgdm_cuda_error_string.restype = ctypes.c_char_p
        lib._fgdm_typed = True
    return lib


def flash_attention(q, k, v, scale):
    """Flash-attention forward.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises.

    Counts launches in ``flash_attention.launches`` keyed by ``(d, nq, nk)``.
    """
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    for name, tsr in (("q", q), ("k", k), ("v", v)):
        if tsr.device != q.device or tsr.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} must be bf16 on "
                             f"{q.device}, got {tsr.dtype} on {tsr.device}")
        if not tsr.is_contiguous() or tsr.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             "and 16-byte aligned")
    if k.shape != (b, h, nk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    lib = _lib()
    block_n = lib.fgdm_flash_attn_block_n(d)
    if block_n == 0:
        raise ValueError(f"flash_attention: head dim {d} not instantiated "
                         f"(have {KERNEL_HEAD_DIMS})")
    if nk % block_n:
        raise ValueError(f"flash_attention: nk={nk} must be a multiple of "
                         f"{block_n} at d={d}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.fgdm_flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), b * h, nq, nk, d,
                                     float(scale), stream)
    if rc != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.fgdm_cuda_error_string(rc).decode())
    flash_attention.launches[(d, nq, nk)] += 1
    return out


flash_attention.launches = collections.Counter()


def use_flash(q, k) -> bool:
    """The gate of ``attention.py:660-673`` on this card, by device and shape
    only: long self-attention (Nq, Nk >= 512, Nk % 512 == 0) of CUDA
    tensors.  A dtype or head dim the kernel does not take then raises in
    ``flash_attention`` rather than quietly taking the plain version."""
    nq, nk = q.shape[2], k.shape[2]
    return (q.device.type == "cuda"
            and nq >= _MIN_N and nk >= _MIN_N and nk % 512 == 0)


def multihead_attention(q, k, v, scale: Optional[float] = None,
                        use_kernel: Optional[bool] = None):
    """Scaled dot-product attention, q/k/v ``[B, H, N, D]``.

    ``use_kernel=None`` applies the gate; True/False force the kernel or the
    plain version (the counterpart of JAX's ``use_flash=``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if use_kernel is None:
        use_kernel = use_flash(q, k)
    if use_kernel:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               float(scale))
    return attention_ref(q, k, v, float(scale)).to(q.dtype)
