"""UniFormer-S + UPerHead ADE20K segmentation (150 classes), the annotator
of ``seg2image --detect``.

Counterpart of ``fgdm_tpu/annotators/uniformer.py:43-315`` (the
reference's ``controlnet/annotator/uniformer``, mmseg's
``upernet_global_small``): embed dims 64/128/320/512, layers 3/4/8/3, head
dim 64.  ``CBlock`` (stages 1-2): depthwise 3x3 position conv, BatchNorm ->
1x1 -> depthwise 5x5 -> 1x1, BatchNorm -> 1x1 MLP; ``SABlock`` (stages 3-4):
depthwise 3x3 position conv, then pre-norm self-attention and MLP on the
tokens; each stage opens with a strided ``PatchEmbed`` (4x4/4, then 2x2/2)
and its output is LayerNorm'd.  ``UPerHead``: a pyramid pool over the last
stage (pools 1/2/3/6), FPN laterals, 3x3 fusion and a 1x1 classifier,
width 512.  BatchNorms are frozen (inference statistics).

Every resize is ``jax.image.resize(..., "bilinear")``'s (``resize_bilinear``:
antialiased where it shrinks), and the MLPs' GELU is ``jax.nn.gelu``'s tanh
form, as in the JAX package, which the port keeps; the reference uses
``AdaptiveAvgPool2d`` in the pyramid and the erf GELU (ROADMAP Queue C).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.annotators import Mlp, SelfAttention
from fgdm_tpu_torch.nn.layers import Conv2d, LayerNorm32, _init_weight

__all__ = ["resize_bilinear", "FrozenBatchNorm", "DWConv", "CBlock",
           "SABlock", "PatchEmbed", "UniFormer", "ConvModule", "UPerHead",
           "adaptive_avg_pool", "UniFormerSeg", "UniformerDetector"]

# ImageNet normalization of the mmseg test pipeline (``uniformer.py:40-41``)
_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
_STD = np.array([58.395, 57.12, 57.375], np.float32)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` on NCHW: half-pixel centres,
    antialiased on an axis that shrinks (JAX's default), plain on one that
    grows."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False,
                         antialias=size[0] < h or size[1] < w)


def _gelu(h):
    return F.gelu(h.float(), approximate="tanh").to(h.dtype)


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm in float32: ``(x - running_mean) *
    rsqrt(running_var + eps) * weight + bias``; returns float32."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean[:, None, None])
                * inv[:, None, None] + self.bias[:, None, None])


class DWConv(nn.Module):
    """Depthwise k x k conv with a bias (``pos_embed``, CBlock ``attn``)."""

    def __init__(self, channels: int, kernel: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _init_weight(self.weight, False, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype),
                        padding=self.weight.shape[-1] // 2,
                        groups=self.weight.shape[0])


class _CMlp(nn.Module):
    def __init__(self, dim: int, dtype):
        super().__init__()
        self.fc1 = Conv2d(dim, 4 * dim, 1, padding=0, dtype=dtype)
        self.fc2 = Conv2d(4 * dim, dim, 1, padding=0, dtype=dtype)

    def forward(self, x):
        return self.fc2(_gelu(self.fc1(x)))


class CBlock(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pos_embed = DWConv(dim, 3, dtype)
        self.norm1 = FrozenBatchNorm(dim)
        self.conv1 = Conv2d(dim, dim, 1, padding=0, dtype=dtype)
        self.attn = DWConv(dim, 5, dtype)
        self.conv2 = Conv2d(dim, dim, 1, padding=0, dtype=dtype)
        self.norm2 = FrozenBatchNorm(dim)
        self.mlp = _CMlp(dim, dtype)

    def forward(self, x):
        x = x + self.pos_embed(x)
        x = x + self.conv2(self.attn(self.conv1(self.norm1(x).to(x.dtype))))
        return x + self.mlp(self.norm2(x).to(x.dtype))


class SABlock(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pos_embed = DWConv(dim, 3, dtype)
        self.norm1 = LayerNorm32(dim, eps=1e-6)
        self.attn = SelfAttention(dim, num_heads, dtype)
        self.norm2 = LayerNorm32(dim, eps=1e-6)
        self.mlp = Mlp(dim, dtype, approximate="tanh")

    def forward(self, x):
        x = x + self.pos_embed(x)
        b, c, hh, ww = x.shape
        t = x.flatten(2).transpose(1, 2)
        t = t + self.attn(self.norm1(t))
        t = t + self.mlp(self.norm2(t))
        return t.transpose(1, 2).reshape(b, c, hh, ww)


def _channel_norm(norm: nn.Module, x):
    """A LayerNorm over the channels of an NCHW map."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, embed_dim: int, patch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv2d(in_channels, embed_dim, patch, stride=patch,
                           padding=0, dtype=dtype)
        self.norm = LayerNorm32(embed_dim)

    def forward(self, x):
        return _channel_norm(self.norm, self.proj(x))


class UniFormer(nn.Module):
    """The backbone -> the four stages' LayerNorm'd outputs."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 layers: Sequence[int] = (3, 4, 8, 3), head_dim: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cin = 3
        for s, (dim, n) in enumerate(zip(embed_dims, layers)):
            setattr(self, f"patch_embed{s + 1}", PatchEmbed(
                cin, dim, 4 if s == 0 else 2, dtype))
            setattr(self, f"blocks{s + 1}", nn.ModuleList(
                CBlock(dim, dtype) if s < 2 else
                SABlock(dim, dim // head_dim, dtype) for _ in range(n)))
            setattr(self, f"norm{s + 1}", LayerNorm32(dim, eps=1e-6))
            cin = dim
        self.num_stages = len(layers)

    def forward(self, x):
        outs = []
        for s in range(1, self.num_stages + 1):
            x = getattr(self, f"patch_embed{s}")(x)
            for block in getattr(self, f"blocks{s}"):
                x = block(x)
            outs.append(_channel_norm(getattr(self, f"norm{s}"), x))
        return tuple(outs)


class ConvModule(nn.Module):
    """conv (no bias) -> frozen BatchNorm -> ReLU; returns float32."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel,
                           padding=kernel // 2, bias=False, dtype=dtype)
        self.bn = FrozenBatchNorm(out_channels)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """``_adaptive_avg_pool`` (``uniformer.py:228-235``): the mean over equal
    bins where the size divides, else a bilinear resize (antialiased when
    it shrinks), as JAX does: 16^2 -> 3 and -> 6 at 512^2 differ from
    ``F.adaptive_avg_pool2d``."""
    h, w = x.shape[-2:]
    if h % out_size == 0 and w % out_size == 0:
        return F.avg_pool2d(x, (h // out_size, w // out_size))
    return resize_bilinear(x, (out_size, out_size))


class UPerHead(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (64, 128, 320, 512),
                 channels: int = 512, num_classes: int = 150,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pool_scales = tuple(pool_scales)
        # Sequential(AdaptiveAvgPool2d, ConvModule): the pool holds nothing
        self.psp_modules = nn.ModuleList(nn.ModuleList([
            nn.Identity(), ConvModule(in_channels[-1], channels, 1, dtype)])
            for _ in pool_scales)
        self.bottleneck = ConvModule(
            in_channels[-1] + len(pool_scales) * channels, channels, 3, dtype)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, channels, 1, dtype) for c in in_channels[:-1])
        self.fpn_convs = nn.ModuleList(
            ConvModule(channels, channels, 3, dtype) for _ in in_channels[:-1])
        self.fpn_bottleneck = ConvModule(len(in_channels) * channels,
                                         channels, 3, dtype)
        self.conv_seg = Conv2d(channels, num_classes, 1, padding=0,
                               dtype=dtype)

    def forward(self, feats):
        f = list(feats)
        size = f[-1].shape[-2:]
        ppm = [f[-1].float()]
        for scale, (_, conv) in zip(self.pool_scales, self.psp_modules):
            ppm.append(resize_bilinear(conv(adaptive_avg_pool(f[-1], scale)),
                                       size))
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, f)]
        laterals.append(self.bottleneck(torch.cat(ppm, 1)))
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_bilinear(
                laterals[i], laterals[i - 1].shape[-2:])
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        outs.append(laterals[-1])
        outs = [resize_bilinear(o, outs[0].shape[-2:]) for o in outs]
        return self.conv_seg(self.fpn_bottleneck(torch.cat(outs, 1)))


class UniFormerSeg(nn.Module):
    """The segmentor: logits ``[B, classes, H, W]`` (float32) at the input's
    resolution."""

    def __init__(self, num_classes: int = 150,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_classes = num_classes
        with torch.device(resolve_device(device)):
            self.backbone = UniFormer(dtype=dtype)
            self.decode_head = UPerHead(num_classes=num_classes, dtype=dtype)

    def forward(self, x):
        logits = self.decode_head(self.backbone(x))
        return resize_bilinear(logits.float(), x.shape[-2:])


class UniformerDetector:
    """uint8 image ``[H, W, 3]`` or ``[B, H, W, 3]`` (numpy) -> the colourised
    ADE20K map of the same shape, the reference detector's contract
    (``uniformer/__init__.py:25-27``)."""

    def __init__(self, model: UniFormerSeg, input_size: int = 512):
        self.model = model
        self.input_size = input_size

    @torch.no_grad()
    def labels(self, img: np.ndarray) -> np.ndarray:
        """-> ADE labels ``[B, H, W]`` int32 (0..149): the image normalized,
        resized to ``input_size`` (bilinear, antialiased), argmax at the
        model's resolution, resized back nearest (JAX's ``"nearest"``:
        ``"nearest-exact"``)."""
        single = img.ndim == 3
        if single:
            img = img[None]
        h, w = img.shape[1:3]
        dev = next(self.model.parameters()).device
        x = torch.from_numpy((img.astype(np.float32) - _MEAN) / _STD)
        x = resize_bilinear(x.permute(0, 3, 1, 2).to(dev),
                            (self.input_size, self.input_size))
        seg = self.model(x).argmax(dim=1, keepdim=True).float()
        seg = F.interpolate(seg, size=(h, w), mode="nearest-exact")
        out = seg[:, 0].to(torch.int32).cpu().numpy()
        return out[0] if single else out

    def __call__(self, img: np.ndarray) -> np.ndarray:
        from fgdm_tpu_torch.data.colorize import ade_cmap, colorize

        return colorize(self.labels(img), ade_cmap()[1:])
