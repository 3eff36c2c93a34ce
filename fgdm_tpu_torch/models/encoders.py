"""Conditioning-stage encoder zoo.

Counterpart of ``fgdm_tpu/models/encoders.py``:

* ``ClassEmbedder``: ``[B]`` labels -> ``[B, 1, embed_dim]``.
* ``BERTEmbedder``: token and position tables, ``n_layer`` of
  ``models/clip.CLIPEncoderLayer`` with a zero mask, a final
  ``LayerNorm32``; float32 out.  It takes token ids (no tokenizer).
* ``SpatialRescaler``: ``n_stages`` resizes by ``multiplier``, then an
  optional bias-free 1x1 ``channel_mapper``.  The methods are JAX's:
  ``bilinear`` and ``area`` are ``jax.image.resize``'s "linear", ``bicubic``
  its "cubic" (a = -0.5), both antialiased where they shrink
  (``annotators.uniformer.resize_bilinear``,
  ``utils.clip_score.resize_bicubic``); ``nearest`` is ``nearest-exact``.
* ``FrozenClipImageEmbedder``: [-1, 1] images -> [0, 1], the bicubic resize
  to ``image_size``, CLIP normalisation, ``utils.clip_score
  .CLIPVisionEncoder`` (``visual.*``).
* ``TrainableCLIPEmbedder``: ``models/clip.CLIPTextEncoder`` itself;
  freezing is the optimizer's choice, as in JAX.

Tensors are NCHW.  The module trees carry JAX's names (``token_emb``,
``pos_emb``, ``layers.N``, ``norm``; ``embedding``; ``channel_mapper``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.annotators.uniformer import resize_bilinear
from fgdm_tpu_torch.models.clip import CLIPEncoderLayer, CLIPTextEncoder
from fgdm_tpu_torch.nn.layers import Conv2d, Embed, LayerNorm32
from fgdm_tpu_torch.utils.clip_score import (CLIP_MEAN, CLIP_STD,
                                             CLIPVisionEncoder,
                                             resize_bicubic)

__all__ = ["ClassEmbedder", "BERTEmbedder", "SpatialRescaler",
           "FrozenClipImageEmbedder", "TrainableCLIPEmbedder"]


class ClassEmbedder(nn.Module):
    def __init__(self, embed_dim: int = 512, n_classes: int = 1000,
                 device=None):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.embedding = Embed(n_classes, embed_dim)

    def forward(self, y):
        """``[B]`` int labels -> ``[B, 1, embed_dim]``."""
        return self.embedding(y)[:, None, :]


class BERTEmbedder(nn.Module):
    """``input_ids [B, n]`` (n <= max_seq_len) -> float32 ``[B, n,
    n_embed]``."""

    def __init__(self, n_embed: int = 1280, n_layer: int = 32,
                 vocab_size: int = 30522, max_seq_len: int = 77,
                 num_heads: int = 8, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        with torch.device(resolve_device(device)):
            self.token_emb = Embed(vocab_size, n_embed)
            self.pos_emb = nn.Parameter(torch.empty(max_seq_len, n_embed))
            self.layers = nn.ModuleList([
                CLIPEncoderLayer(n_embed, num_heads, dtype=dtype)
                for _ in range(n_layer)])
            self.norm = LayerNorm32(n_embed)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        nn.init.normal_(self.pos_emb, std=0.02, generator=generator)

    def forward(self, input_ids):
        n = input_ids.shape[1]
        x = (self.token_emb(input_ids).to(self.dtype)
             + self.pos_emb[None, :n].to(self.dtype))
        no_mask = torch.zeros((1, 1, n, n), device=x.device)
        for layer in self.layers:
            x = layer(x, no_mask)
        return self.norm(x).float()


def _resize(x, size, method: str):
    if method in ("bilinear", "area"):
        return resize_bilinear(x, size)
    if method == "bicubic":
        return resize_bicubic(x, size)
    return F.interpolate(x, size=tuple(size), mode="nearest-exact")


class SpatialRescaler(nn.Module):
    """Multiply-downsample a spatial conditioning map ``n_stages`` times,
    then an optional 1x1 remap to ``out_channels``."""

    def __init__(self, n_stages: int = 1, method: str = "bilinear",
                 multiplier: float = 0.5, in_channels: int = 3,
                 out_channels: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if method not in ("bilinear", "nearest", "bicubic", "area"):
            raise ValueError(f"unknown method {method!r}")
        self.n_stages, self.method, self.multiplier = (n_stages, method,
                                                       multiplier)
        self.channel_mapper = None
        if out_channels is not None:
            with torch.device(resolve_device(device)):
                self.channel_mapper = Conv2d(in_channels, out_channels, 1,
                                             padding=0, bias=False,
                                             dtype=dtype)

    def forward(self, x):
        for _ in range(self.n_stages):
            h, w = x.shape[-2:]
            x = _resize(x, (int(h * self.multiplier),
                            int(w * self.multiplier)), self.method)
        return x if self.channel_mapper is None else self.channel_mapper(x)


class FrozenClipImageEmbedder(nn.Module):
    """img ``[B, 3, H, W]`` in [-1, 1] -> CLIP image features ``[B,
    proj_dim]``; ``vision`` overrides the ViT-L/14 tower's widths."""

    def __init__(self, image_size: int = 224,
                 dtype: torch.dtype = torch.float32, device=None,
                 **vision):
        super().__init__()
        self.image_size = image_size
        self.visual = CLIPVisionEncoder(image_size=image_size, dtype=dtype,
                                        device=device, **vision)
        dev = resolve_device(device)
        self.register_buffer("mean", torch.from_numpy(CLIP_MEAN).to(dev)
                             .reshape(3, 1, 1), persistent=False)
        self.register_buffer("std", torch.from_numpy(CLIP_STD).to(dev)
                             .reshape(3, 1, 1), persistent=False)

    def forward(self, img):
        s = self.image_size
        x = resize_bicubic((img + 1.0) / 2.0, (s, s))
        return self.visual((x - self.mean) / self.std)


class TrainableCLIPEmbedder(CLIPTextEncoder):
    """``CLIPTextEncoder`` meant to receive gradients (reference
    ``modules.py:165-190``): freezing is an optimizer-partition decision,
    not a module property."""
