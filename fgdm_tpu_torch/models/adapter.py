"""FG-DM side adapter (T2I-Adapter style conv pyramid).

Counterpart of ``fgdm_tpu/models/adapter.py:29-93``: ``AdapterResnetBlock``
(optional 2x down, optional in-conv on channel changes, conv3x3 -> ReLU ->
conv(ksize), identity or learned skip) and ``Adapter`` (``conv_in`` then
``len(channels) * nums_rb`` blocks, one feature per scale) and
``TimeAdapter`` (``:165-197``: the same pyramid with the UNet's
timestep-conditioned ``ResBlock``s as its blocks, unfused GroupNorm as in
JAX), and the light adapter (``:96-162``): ``ResnetBlockLight``
(conv3x3 -> ReLU -> conv3x3, identity skip), ``Extractor`` (optional 2x2
average pool, 1x1 in, light blocks, 1x1 out), ``pixel_unshuffle`` and
``AdapterLight`` (an 8x space-to-depth input, then one extractor a level at
a quarter of its width).  ``pixel_unshuffle`` orders the channels
``(fy, fx, c)``, as JAX's NHWC reshape does (``adapter.py:134-139``), not
``(c, fy, fx)`` as ``F.pixel_unshuffle`` does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch.nn.blocks import ResBlock
from fgdm_tpu_torch.nn.layers import Conv2d, avg_pool_2x2
from fgdm_tpu_torch.parallel import context as cp

__all__ = ["AdapterResnetBlock", "Adapter", "TimeAdapter",
           "ResnetBlockLight", "Extractor", "pixel_unshuffle",
           "AdapterLight"]


class AdapterResnetBlock(nn.Module):
    def __init__(self, in_c: int, out_c: int, down: bool = False,
                 ksize: int = 3, sk: bool = False, use_conv: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ps = ksize // 2
        self.down = down
        self.down_opt = (Conv2d(in_c, in_c, 3, stride=2, padding=1,
                                dtype=dtype) if down and use_conv else None)
        self.in_conv = (Conv2d(in_c, out_c, ksize, padding=ps, dtype=dtype)
                        if in_c != out_c or not sk else None)
        self.block1 = Conv2d(out_c, out_c, 3, padding=1, dtype=dtype)
        self.block2 = Conv2d(out_c, out_c, ksize, padding=ps, dtype=dtype)
        self.skep = (None if sk else
                     Conv2d(out_c, out_c, ksize, padding=ps, dtype=dtype))

    def forward(self, x):
        if self.down:
            x = avg_pool_2x2(x) if self.down_opt is None else self.down_opt(x)
        if self.in_conv is not None:
            x = self.in_conv(x)
        h = self.block2(F.relu(self.block1(x)))
        return h + (x if self.skep is None else self.skep(x))


class Adapter(nn.Module):
    def __init__(self, channels: Sequence[int] = (320, 640, 1280, 1280),
                 nums_rb: int = 2, cin: int = 4, ksize: int = 1,
                 sk: bool = True, use_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nums_rb = nums_rb
        self.conv_in = Conv2d(cin, channels[0], 3, padding=1, dtype=dtype)
        blocks = []
        for i, ch in enumerate(channels):
            for j in range(nums_rb):
                trans = i != 0 and j == 0
                blocks.append(AdapterResnetBlock(
                    channels[i - 1] if trans else ch, ch, down=trans,
                    ksize=ksize, sk=sk, use_conv=use_conv, dtype=dtype))
        self.body = nn.ModuleList(blocks)

    def forward(self, x, emb: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ...]:
        """One feature per level; ``emb`` is ignored (``TimeAdapter``'s
        signature).  Inside a context-parallel UNet a level whose rows do
        not divide runs whole (``parallel.context.enter_down``)."""
        x = self.conv_in(x)
        feats = []
        for i, blk in enumerate(self.body):
            if blk.down:
                x = cp.enter_down(x, i // self.nums_rb)
            x = blk(x)
            if (i + 1) % self.nums_rb == 0:
                feats.append(x)
        return tuple(feats)


class TimeAdapter(nn.Module):
    """The adapter pyramid with timestep-conditioned blocks: ``conv_in``,
    then ``ResBlock(x, emb)``s, the first of each level after the first
    downsampling by 2x2 average pooling.  ``ksize`` and ``sk`` are accepted
    for ``Adapter``'s signature and unused, as in JAX."""

    def __init__(self, channels: Sequence[int] = (320, 640, 1280, 1280),
                 nums_rb: int = 2, cin: int = 4, ksize: int = 1,
                 sk: bool = True, emb_ch: int = 1280, use_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nums_rb = nums_rb
        self.conv_in = Conv2d(cin, channels[0], 3, padding=1, dtype=dtype)
        blocks = []
        for i, ch in enumerate(channels):
            for j in range(nums_rb):
                trans = i != 0 and j == 0
                blocks.append(ResBlock(
                    channels[i - 1] if trans else ch, emb_ch, ch,
                    use_conv=use_conv, down=trans, dtype=dtype))
        self.body = nn.ModuleList(blocks)

    def forward(self, x, emb) -> Tuple[torch.Tensor, ...]:
        x = self.conv_in(x)
        feats = []
        for i, blk in enumerate(self.body):
            if blk.down:
                x = cp.enter_down(x, i // self.nums_rb)
            x = blk(x, emb)
            if (i + 1) % self.nums_rb == 0:
                feats.append(x)
        return tuple(feats)


class ResnetBlockLight(nn.Module):
    """conv3x3 -> ReLU -> conv3x3 with an identity skip."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block1 = Conv2d(channels, channels, 3, dtype=dtype)
        self.block2 = Conv2d(channels, channels, 3, dtype=dtype)

    def forward(self, x):
        return self.block2(F.relu(self.block1(x))) + x


class Extractor(nn.Module):
    """Optional 2x2 average pool, 1x1 in, ``nums_rb`` light blocks, 1x1
    out."""

    def __init__(self, in_c: int, inter_c: int, out_c: int, nums_rb: int = 3,
                 down: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.down = down
        self.in_conv = Conv2d(in_c, inter_c, 1, padding=0, dtype=dtype)
        self.body = nn.ModuleList([ResnetBlockLight(inter_c, dtype=dtype)
                                   for _ in range(nums_rb)])
        self.out_conv = Conv2d(inter_c, out_c, 1, padding=0, dtype=dtype)

    def forward(self, x):
        if self.down:
            x = avg_pool_2x2(x)
        x = self.in_conv(x)
        for blk in self.body:
            x = blk(x)
        return self.out_conv(x)


def pixel_unshuffle(x: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B, C * f * f, H / f, W / f]``, channel
    ``(fy * f + fx) * C + c``: JAX's NHWC space-to-depth order."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // factor, factor, w // factor, factor)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(
        b, factor * factor * c, h // factor, w // factor)


class AdapterLight(nn.Module):
    """The pixel-unshuffle light adapter: one feature per level."""

    def __init__(self, channels: Sequence[int] = (320, 640, 1280, 1280),
                 nums_rb: int = 3, cin: int = 192,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ins = (cin,) + tuple(channels[:-1])
        self.body = nn.ModuleList([
            Extractor(ins[i], ch // 4, ch, nums_rb=nums_rb, down=i > 0,
                      dtype=dtype) for i, ch in enumerate(channels)])

    def forward(self, x, emb: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ...]:
        """x ``[B, 3, H, W]``; ``emb`` is ignored (``TimeAdapter``'s
        signature)."""
        x = pixel_unshuffle(x, 8)
        feats = []
        for ext in self.body:
            x = ext(x)
            feats.append(x)
        return tuple(feats)
