"""MiDaS DPT-Hybrid depth net, normals from its depth gradients, the depth
and normal factors' annotator.

Counterpart of ``fgdm_tpu/annotators/midas.py:34-391`` (the reference's
``controlnet/annotator/midas``): a BiT-R50 stem (weight-standardized convs
with TF-SAME padding, GroupNorm, stages 3/4/9) whose 1/4 and 1/8 features
are tapped, its 1/16 features patch-embedded into a ViT-B (12 layers, class
token, taps after blocks 8 and 11 read out with the "project" readout),
reassembled and fused RefineNet-style (width 256) into inverse depth.

The module tree is the reference's (``pretrained.model.*``,
``pretrained.act_postprocess{3,4}``, ``scratch.*``).  The position table
keeps the released checkpoint's grid (24^2 + 1 tokens) and is resized to
the input's token grid in every forward (bilinear, half-pixel centres, no
antialias), as the reference's ``_resize_pos_embed`` does; the JAX package
resizes it once at ingest, which gives the same numbers.  The deepest
fusion block takes one input, so it holds no ``resConfUnit1`` (JAX's
neither; the released file's copy of it is never read).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.annotators import Mlp, SelfAttention
from fgdm_tpu_torch.nn.layers import Conv2d, Dense, GroupNorm32, LayerNorm32

# the position table's grid: the released checkpoint's 577 tokens (384^2)
POS_GRID = 24

__all__ = ["StdConv", "BitBottleneck", "ResNetV2Stem", "ViTBlock",
           "ResidualConvUnit", "resize_align_corners", "FeatureFusion",
           "DPTHybrid", "depth_to_normal", "MidasDetector"]


def _same_pad(n: int, k: int, s: int):
    """TF-SAME padding of one axis: (before, after); the odd pixel goes
    after (a 7x7 stride-2 conv on an even input pads (2, 3))."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class StdConv(nn.Module):
    """Weight-standardized conv (eps 1e-8) with TF-SAME padding, timm's
    ``StdConv2dSame``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        # JAX: variance_scaling(2.0, "fan_out", "normal")
        fan_out = self.weight.shape[0] * self.weight[0, 0].numel()
        nn.init.normal_(self.weight, std=math.sqrt(2.0 / fan_out),
                        generator=generator)

    def forward(self, x):
        w = self.weight
        var, mean = torch.var_mean(w, dim=(1, 2, 3), correction=0,
                                   keepdim=True)
        w = (w - mean) / torch.sqrt(var + 1e-8)
        k = w.shape[-1]
        ph = _same_pad(x.shape[-2], k, self.stride)
        pw = _same_pad(x.shape[-1], k, self.stride)
        x = F.pad(x.to(self.dtype), (*pw, *ph))
        return F.conv2d(x, w.to(self.dtype), None, self.stride)


class _ConvNorm(nn.Module):
    """A shortcut's 1x1 ``StdConv`` and its GroupNorm (``downsample.conv``,
    ``downsample.norm``; no activation)."""

    def __init__(self, cin: int, cout: int, stride: int, dtype):
        super().__init__()
        self.conv = StdConv(cin, cout, 1, stride, dtype)
        self.norm = GroupNorm32(cout)

    def forward(self, x):
        return self.norm(self.conv(x))


class BitBottleneck(nn.Module):
    """Post-norm ResNetV2 bottleneck (timm ``Bottleneck``): 1x1 -> GN+ReLU ->
    3x3 (stride) -> GN+ReLU -> 1x1 -> GN, a ``downsample`` shortcut where
    the shape changes, ReLU after the sum."""

    def __init__(self, cin: int, mid: int, out: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.downsample = (_ConvNorm(cin, out, stride, dtype)
                           if cin != out or stride != 1 else None)
        self.conv1 = StdConv(cin, mid, 1, dtype=dtype)
        self.norm1 = GroupNorm32(mid)
        self.conv2 = StdConv(mid, mid, 3, stride, dtype)
        self.norm2 = GroupNorm32(mid)
        self.conv3 = StdConv(mid, out, 1, dtype=dtype)
        self.norm3 = GroupNorm32(out)

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.norm1(self.conv1(x)))
        h = F.relu(self.norm2(self.conv2(h)))
        return F.relu(self.norm3(self.conv3(h)) + shortcut)


class _Stem(nn.Module):
    def __init__(self, width: int, dtype):
        super().__init__()
        self.conv = StdConv(3, width, 7, 2, dtype)
        self.norm = GroupNorm32(width)


class _Stage(nn.Module):
    def __init__(self, cin: int, mid: int, out: int, depth: int, stride: int,
                 dtype):
        super().__init__()
        self.blocks = nn.ModuleList(
            BitBottleneck(cin if i == 0 else out, mid, out,
                          stride if i == 0 else 1, dtype)
            for i in range(depth))

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class ResNetV2Stem(nn.Module):
    """BiT-R50's first three stages (``stem`` conv 7x7/2 + GN + ReLU + a 3x3/2
    max pool with TF-SAME padding of -inf; stages of 3/4/9 bottlenecks) ->
    ``(f4, f8, f16)``: 256 channels at 1/4, 512 at 1/8, 1024 at 1/16."""

    def __init__(self, width: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem = _Stem(width, dtype)
        self.stages = nn.ModuleList([
            _Stage(width, width, 4 * width, 3, 1, dtype),
            _Stage(4 * width, 2 * width, 8 * width, 4, 2, dtype),
            _Stage(8 * width, 4 * width, 16 * width, 9, 2, dtype)])

    def forward(self, x):
        h = F.relu(self.stem.norm(self.stem.conv(x)))
        ph, pw = _same_pad(h.shape[-2], 3, 2), _same_pad(h.shape[-1], 3, 2)
        h = F.max_pool2d(F.pad(h, (*pw, *ph), value=float("-inf")), 3, 2)
        f4 = self.stages[0](h)
        f8 = self.stages[1](f4)
        return f4, f8, self.stages[2](f8)


class _HybridEmbed(nn.Module):
    def __init__(self, embed_dim: int, dtype):
        super().__init__()
        self.backbone = ResNetV2Stem(dtype=dtype)
        self.proj = Conv2d(1024, embed_dim, 1, padding=0, dtype=dtype)


class ViTBlock(nn.Module):
    """Pre-norm ViT block, LayerNorm eps 1e-6."""

    def __init__(self, dim: int = 768, heads: int = 12,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm32(dim, eps=1e-6)
        self.attn = SelfAttention(dim, heads, dtype)
        self.norm2 = LayerNorm32(dim, eps=1e-6)
        self.mlp = Mlp(dim, dtype)   # exact (erf) GELU, timm's nn.GELU()

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _VitHybrid(nn.Module):
    """``pretrained.model``: the patch embedding, class token, position
    table and ViT blocks (its final norm is never read)."""

    def __init__(self, embed_dim, num_layers, num_heads, dtype):
        super().__init__()
        self.patch_embed = _HybridEmbed(embed_dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(
            1, POS_GRID * POS_GRID + 1, embed_dim))
        self.blocks = nn.ModuleList(ViTBlock(embed_dim, num_heads, dtype)
                                    for _ in range(num_layers))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        nn.init.normal_(self.pos_embed, std=0.02, generator=generator)

    def resized_pos_embed(self, hh: int, ww: int) -> torch.Tensor:
        """The table at an ``hh x ww`` token grid (reference ``vit.py
        _resize_pos_embed``: ``F.interpolate`` bilinear)."""
        pe = self.pos_embed
        n = pe.shape[1] - 1
        if n == hh * ww:
            return pe
        g = math.isqrt(n)
        grid = pe[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(hh, ww), mode="bilinear",
                             align_corners=False)
        return torch.cat([pe[:, :1], grid.permute(0, 2, 3, 1).reshape(
            1, hh * ww, -1)], dim=1)


class _Readout(nn.Module):
    """The "project" readout: ``[tokens, cls]`` -> Linear(2d, d) -> GELU
    (``act_postprocess{n}.0.project.0``)."""

    def __init__(self, dim: int, dtype):
        super().__init__()
        self.project = nn.ModuleDict({"0": Dense(2 * dim, dim, dtype=dtype)})

    def forward(self, tok, hh, ww):
        feats = tok[:, 1:]
        y = self.project["0"](torch.cat(
            [feats, tok[:, :1].expand_as(feats)], dim=-1))
        y = F.gelu(y.float()).to(y.dtype)
        return y.transpose(1, 2).reshape(y.shape[0], -1, hh, ww)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, dtype=dtype)
        self.conv2 = Conv2d(features, features, 3, dtype=dtype)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


def resize_align_corners(x: torch.Tensor, out_h: int, out_w: int
                         ) -> torch.Tensor:
    """Bilinear resize with ``align_corners=True`` (the DPT fusion and head,
    ``blocks.py:295,332``, ``dpt_depth.py:94``)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


class FeatureFusion(nn.Module):
    """``x (+ resConfUnit1(skip))`` -> ``resConfUnit2`` -> 2x up
    (align_corners) -> 1x1 ``out_conv``."""

    def __init__(self, features: int = 256, with_skip: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resConfUnit1 = (ResidualConvUnit(features, dtype)
                             if with_skip else None)
        self.resConfUnit2 = ResidualConvUnit(features, dtype)
        self.out_conv = Conv2d(features, features, 1, padding=0, dtype=dtype)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = resize_align_corners(x, 2 * x.shape[-2], 2 * x.shape[-1])
        return self.out_conv(x)


class DPTHybrid(nn.Module):
    """DPT-Hybrid: ViT-B/16 (embed 768, 12 layers, 12 heads, taps after
    blocks ``hooks``) on the R50 stem, fusion width 256."""

    def __init__(self, embed_dim: int = 768, num_layers: int = 12,
                 num_heads: int = 12, hooks: Sequence[int] = (8, 11),
                 features: int = 256, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.hooks = tuple(hooks)
        d = embed_dim
        with torch.device(resolve_device(device)):
            self.pretrained = nn.Module()
            self.pretrained.model = _VitHybrid(d, num_layers, num_heads,
                                               dtype)
            self.pretrained.act_postprocess3 = nn.ModuleDict({
                "0": _Readout(d, dtype),
                "3": Conv2d(d, d, 1, padding=0, dtype=dtype)})
            self.pretrained.act_postprocess4 = nn.ModuleDict({
                "0": _Readout(d, dtype),
                "3": Conv2d(d, d, 1, padding=0, dtype=dtype),
                "4": Conv2d(d, d, 3, stride=2, padding=1, dtype=dtype)})
            s = self.scratch = nn.Module()
            for i, cin in enumerate((256, 512, d, d)):
                setattr(s, f"layer{i + 1}_rn", Conv2d(
                    cin, features, 3, bias=False, dtype=dtype))
            for i in range(1, 5):
                setattr(s, f"refinenet{i}", FeatureFusion(
                    features, with_skip=i < 4, dtype=dtype))
            s.output_conv = nn.ModuleDict({
                "0": Conv2d(features, features // 2, 3, dtype=dtype),
                "2": Conv2d(features // 2, 32, 3, dtype=dtype),
                "4": Conv2d(32, 1, 1, padding=0, dtype=dtype)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x ``[B, 3, H, W]`` (normalized image) -> inverse depth
        ``[B, H, W]`` in float32."""
        vit, p = self.pretrained.model, self.pretrained
        f4, f8, f16 = vit.patch_embed.backbone(x)
        b, hh, ww = f16.shape[0], f16.shape[-2], f16.shape[-1]
        tok = vit.patch_embed.proj(f16).flatten(2).transpose(1, 2)
        t = torch.cat([vit.cls_token.to(tok.dtype).expand(b, -1, -1), tok],
                      dim=1)
        t = t + vit.resized_pos_embed(hh, ww).to(t.dtype)
        taps = []
        for i, block in enumerate(vit.blocks):
            t = block(t)
            if i in self.hooks:
                taps.append(t)
        l3 = p.act_postprocess3["3"](p.act_postprocess3["0"](taps[0], hh,
                                                             ww))
        l4 = p.act_postprocess4["3"](p.act_postprocess4["0"](taps[1], hh,
                                                             ww))
        l4 = p.act_postprocess4["4"](l4)
        s = self.scratch
        r1, r2, r3, r4 = (getattr(s, f"layer{i + 1}_rn")(f)
                          for i, f in enumerate((f4, f8, l3, l4)))
        p4 = s.refinenet4(r4)
        p3 = s.refinenet3(p4, r3)
        p2 = s.refinenet2(p3, r2)
        p1 = s.refinenet1(p2, r1)
        h = s.output_conv["0"](p1)
        h = resize_align_corners(h, 2 * h.shape[-2], 2 * h.shape[-1])
        h = F.relu(s.output_conv["2"](h))
        h = F.relu(s.output_conv["4"](h))   # non-negative inverse depth
        return h[:, 0].float()


_SOBEL = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def depth_to_normal(depth: torch.Tensor, a: float = 2.0 * 3.14159265,
                    bg_th: float = 0.1) -> torch.Tensor:
    """Normals from depth gradients (``midas.py:331-352``; the reference's
    cv2.Sobel pipeline): zero-padded Sobel cross-correlations, the
    background (per-sample min-max depth below ``bg_th``) zeroed, then
    ``[gx, gy, a]`` normalized.  depth ``[B, H, W]`` -> ``[B, 3, H, W]``."""
    d = depth.float()[:, None]
    kx = torch.tensor(_SOBEL, device=d.device)
    k = torch.stack([kx, kx.T])[:, None]
    g = F.conv2d(d, k, padding=1)
    dmin = d.amin(dim=(2, 3), keepdim=True)
    dmax = d.amax(dim=(2, 3), keepdim=True)
    g = g * ((d - dmin) / (dmax - dmin + 1e-8) >= bg_th)
    n = torch.cat([g, torch.full_like(d, a)], dim=1)
    return n / torch.sqrt((n * n).sum(dim=1, keepdim=True))


class MidasDetector:
    """image ``[B, 3, H, W]`` in [-1, 1] -> ``(depth01 [B, H, W], normal
    [B, 3, H, W])``: the depth min-max normalized per image, the normals of
    ``depth_to_normal`` (the reference ``MidasDetector``)."""

    def __init__(self, model: DPTHybrid):
        self.model = model

    @torch.no_grad()
    def __call__(self, img: torch.Tensor, a: float = 2.0 * 3.14159265,
                 bg_th: float = 0.1):
        depth = self.model(img)
        dmin = depth.amin(dim=(1, 2), keepdim=True)
        dmax = depth.amax(dim=(1, 2), keepdim=True)
        return ((depth - dmin) / (dmax - dmin + 1e-8),
                depth_to_normal(depth, a=a, bg_th=bg_th))
