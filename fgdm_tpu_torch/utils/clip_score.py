"""CLIP similarity scoring (the eval CLI's CLIP score and CLIP-FID).

Counterpart of ``fgdm_tpu/utils/clip_score.py`` (the reference's
``utils/clip_utils.py:12-80``, clean-fid's ``CLIP_fx`` and
``get_clip_score``): images are resized to 224^2 (``jax.image.resize(...,
"bicubic")``: the Keys cubic with a = -0.5, antialiased where it shrinks,
each output's taps renormalised at the border, which is
``F.interpolate(mode="bicubic", antialias=True)`` shrinking and growing),
CLIP-normalized and encoded by the ViT-L/14 vision tower; the prompt goes
through the text tower, is pooled at its end-of-text token and projected;
the score is the cosine of the two.

``CLIPVisionEncoder`` is JAX's tower with torch names: a bias-free patch
conv, ``class_embedding``, ``position_embedding``, ``pre_layernorm``,
``models/clip.CLIPEncoderLayer`` blocks with no mask, ``post_layernorm`` on
the class token and a bias-free ``visual_projection``.  ``flax_paths``
names each parameter of it (and of ``models/clip.CLIPTextEncoder``) as
JAX's flax tree does, for the fuzzy checkpoint ingest of ``cli/eval.py``.
The towers are plain PyTorch ops in float32 (JAX's are XLA einsums); every
forward of ``CLIPScorer`` runs with TF32 off.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch import full_f32, resolve_device
from fgdm_tpu_torch.models.clip import CLIPEncoderLayer, CLIPTextEncoder
from fgdm_tpu_torch.nn.layers import Conv2d, Dense, Embed, LayerNorm32

__all__ = ["CLIP_MEAN", "CLIP_STD", "EOT", "CLIPVisionEncoder", "CLIPScorer",
           "resize_bicubic", "flax_paths"]

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
EOT = 49407   # the end-of-text token the text features are pooled at


class CLIPVisionEncoder(nn.Module):
    """ViT vision tower (defaults: ViT-L/14) with the pooled projection:
    ``[B, 3, S, S]`` CLIP-normalized -> ``[B, proj_dim]``."""

    def __init__(self, image_size: int = 224, patch_size: int = 14,
                 hidden: int = 1024, layers: int = 24, heads: int = 16,
                 proj_dim: int = 768, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.image_size, self.proj_dim = image_size, proj_dim
        grid = image_size // patch_size
        with torch.device(resolve_device(device)):
            self.patch_embed = Conv2d(3, hidden, patch_size,
                                      stride=patch_size, padding=0,
                                      bias=False, dtype=dtype)
            self.class_embedding = nn.Parameter(torch.empty(hidden))
            self.position_embedding = nn.Parameter(
                torch.empty(grid * grid + 1, hidden))
            self.pre_layernorm = LayerNorm32(hidden)
            self.layers = nn.ModuleList(
                CLIPEncoderLayer(hidden, heads, dtype=dtype)
                for _ in range(layers))
            self.post_layernorm = LayerNorm32(hidden)
            self.visual_projection = Dense(hidden, proj_dim, bias=False,
                                           dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        for p in (self.class_embedding, self.position_embedding):
            nn.init.normal_(p, std=0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.patch_embed(x)
        b, c = h.shape[:2]
        tokens = h.flatten(2).transpose(1, 2)
        t = torch.cat([self.class_embedding.to(tokens.dtype)
                       .expand(b, 1, c), tokens], dim=1)
        t = self.pre_layernorm(t + self.position_embedding.to(t.dtype))
        no_mask = torch.zeros((1, 1, t.shape[1], t.shape[1]),
                              device=t.device)
        for layer in self.layers:
            t = layer(t, no_mask)
        return self.visual_projection(self.post_layernorm(t[:, 0]))


def resize_bicubic(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., "bicubic")`` on NCHW float32."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bicubic",
                         align_corners=False, antialias=True)


class CLIPScorer:
    """``get_clip_score``: the cosine of the normalized image and text
    features.  ``text_proj`` is ``[embed, proj_dim]``; the three are used on
    the vision tower's device."""

    def __init__(self, vision: CLIPVisionEncoder, text: CLIPTextEncoder,
                 text_proj: torch.Tensor):
        self.vision = vision.requires_grad_(False).eval()
        self.text = text.requires_grad_(False).eval()
        self.device = next(vision.parameters()).device
        self.text_proj = torch.as_tensor(text_proj, dtype=torch.float32,
                                         device=self.device)
        self._mean = torch.from_numpy(CLIP_MEAN).to(self.device)[:, None,
                                                                  None]
        self._std = torch.from_numpy(CLIP_STD).to(self.device)[:, None, None]

    @torch.no_grad()
    def encode_image(self, img01) -> torch.Tensor:
        """``[B, H, W, 3]`` in [0, 1] -> normalized ``[B, proj_dim]``."""
        x = torch.as_tensor(np.asarray(img01, np.float32)).to(self.device)
        s = self.vision.image_size
        with full_f32():
            x = resize_bicubic(x.permute(0, 3, 1, 2), (s, s))
            f = self.vision((x - self._mean) / self._std)
        return f / f.norm(dim=-1, keepdim=True)

    @torch.no_grad()
    def encode_text(self, input_ids) -> torch.Tensor:
        """``[B, 77]`` token ids -> normalized ``[B, proj_dim]``."""
        ids = torch.as_tensor(input_ids).to(self.device)
        with full_f32():
            states = self.text(ids)
            eot = (ids == EOT).int().argmax(dim=-1)
            f = states[torch.arange(ids.shape[0], device=self.device),
                       eot] @ self.text_proj
        return f / f.norm(dim=-1, keepdim=True)

    def score(self, img01, input_ids) -> np.ndarray:
        """img01 ``[B, H, W, 3]`` in [0, 1], input_ids ``[B, 77]`` ->
        the per-sample cosine ``[B]`` (numpy)."""
        fi, ft = self.encode_image(img01), self.encode_text(input_ids)
        return (fi * ft).sum(dim=-1).cpu().numpy()


# the levels of the port's module names that JAX's flax trees lack
_PREFIXES = ("text_model.", "embeddings.", "encoder.")


def flax_paths(module: nn.Module) -> Dict[str, str]:
    """``{JAX flax path: port key}`` of a ``CLIPVisionEncoder`` or
    ``CLIPTextEncoder``: the path JAX's tower gives the same parameter
    (``layers_3/self_attn/q_proj/kernel``, ``pre_layernorm/scale``,
    ``token_embedding/embedding``, the bare ``position_embedding`` ...)."""
    kinds = {}
    for name, m in module.named_modules():
        if isinstance(m, LayerNorm32):
            kinds[name] = {"weight": "scale", "bias": "bias"}
        elif isinstance(m, (Conv2d, Dense)):
            kinds[name] = {"weight": "kernel", "bias": "bias"}
        elif isinstance(m, Embed):
            kinds[name] = {"weight": "embedding"}
    out = {}
    for key in module.state_dict():
        owner, _, leaf = key.rpartition(".")
        leaf = kinds.get(owner, {}).get(leaf, leaf)
        path = f"{owner}." if owner else ""
        for pre in _PREFIXES:
            path = path[len(pre):] if path.startswith(pre) else path
        path = re.sub(r"(^|\.)mlp\.", r"\1", path)
        path = re.sub(r"layers\.(\d+)\.", r"layers_\1.", path)
        path = path.replace(".", "/") + leaf
        if path == "position_embedding/embedding":   # a bare table in JAX
            path = "position_embedding"
        out[path] = key
    return out
