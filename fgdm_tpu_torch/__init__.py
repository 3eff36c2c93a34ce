"""fgdm_tpu_torch: the FG-DM port to PyTorch and CUDA on an NVIDIA H100.

Mirrors ``fgdm_tpu/`` module for module.  Plain tensor code is PyTorch; each
Pallas TPU kernel on the ported path is a kernel written by hand for Hopper
(``kernels/``), with a plain PyTorch version beside it.  Entry points build
on the CUDA device unless the caller passes ``device="cpu"``.
"""

import contextlib

import torch

__all__ = ["resolve_device", "full_f32"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: CUDA by default; the CPU only
    when asked for by name.  Raises when CUDA is wanted but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fgdm_tpu_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def full_f32():
    """TF32 off for matmuls and cuDNN convolutions inside the block, both
    settings restored after: the metric networks of ``cli/eval.py``
    compute in float32 whatever the process's global switches say."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
