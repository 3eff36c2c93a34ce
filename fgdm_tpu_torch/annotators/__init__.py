"""The frozen detector nets that make condition maps (counterpart of
``fgdm_tpu/annotators/``): ``hed`` (ControlNetHED) and ``pidinet`` (PiDiNet)
for sketches, ``midas`` (DPT-Hybrid) for depth and normals, ``uniformer``
(UniFormer-S + UPerHead) for ADE20K segmentation, ``openpose`` for poses,
``mlsd`` (MobileNetV2 MLSD) for line segments and ``canny`` (OpenCV's Canny
rebuilt in numpy, and the in-graph ``sobel_edges``) for edges.  MLSD and
Canny run without OpenCV: ``data/imgproc.py`` rebuilds its INTER_AREA
resize and 1-pixel line.

The modules are NCHW and carry the reference's torch key names, so a
released checkpoint loads with ``load_state_dict`` after the key
normalization of ``checkpoint/annotator_ingest.py``.  Their layers are
plain PyTorch ops, as the JAX package's are XLA ops; a ``Conv2d`` of
``nn/layers.py`` reaches the conv kernel only where JAX's ``Conv2d`` routes
its own (bf16 and a conv flag).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch.nn.layers import Dense

__all__ = ["SelfAttention", "Mlp", "seed_"]


class SelfAttention(nn.Module):
    """Multi-head self-attention on ``[B, N, dim]`` tokens (``attn.qkv``,
    ``attn.proj``): the scores and softmax in float32, the weights cast to
    v's dtype, as the JAX einsums (``midas.py:154-158``,
    ``uniformer.py:115-118``)."""

    def __init__(self, dim: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x):
        b, n, d = x.shape
        q, k, v = (t.reshape(b, n, self.heads, -1).transpose(1, 2)
                   for t in self.qkv(x).chunk(3, dim=-1))
        att = torch.softmax(q.float() @ k.float().transpose(-1, -2)
                            * q.shape[-1] ** -0.5, dim=-1)
        return self.proj((att.to(v.dtype) @ v).transpose(1, 2)
                         .reshape(b, n, d))


class Mlp(nn.Module):
    """``fc1`` -> GELU in float32 -> ``fc2`` on tokens; ``approximate`` is
    the GELU's form (``"none"``: erf, timm's ViT; ``"tanh"``: JAX's default,
    which its UniFormer uses)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 approximate: str = "none"):
        super().__init__()
        self.approximate = approximate
        self.fc1 = Dense(dim, 4 * dim, dtype=dtype)
        self.fc2 = Dense(4 * dim, dim, dtype=dtype)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(F.gelu(h.float(), approximate=self.approximate)
                        .to(h.dtype))


def seed_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every weight that has a random init from ``generator`` (the
    port's counterpart of a flax ``init`` from an rng)."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    if hasattr(module, "reset_parameters"):
        module.reset_parameters(generator)
    return module
