"""PiDiNet edge detector (pixel-difference convolutions), the sketch
factor's annotator.

Counterpart of ``fgdm_tpu/annotators/pidinet.py:38-230`` (the reference's
``ldm/models/model_edge.py``, carv4, dil 24, sa): an init PDC conv, 16 PDC
blocks in 4 stages (60/120/240/240 channels, a 2x2 VALID max pool and a 1x1
shortcut where a stage starts), per stage a ``CDCM`` (1x1, then four
dilated 3x3 convs at dilations 5/7/9/11, summed), a ``CSAM`` (1x1 -> 3x3 ->
sigmoid gate) and a 1x1 map; the four maps are resized to the input
(bilinear, half-pixel centres), fused by a 1x1 classifier (init 0.25),
squashed by a sigmoid and thresholded at 0.5 into a {-1, 1} 3-channel map.

Each pixel-difference conv is one plain conv of a transformed kernel
(``transform_pdc_kernel``, on OIHW weights): ``cd`` subtracts the kernel's
sum at the centre, ``ad`` the clockwise-rotated kernel, ``rd`` scatters
the 3x3 ring onto a 5x5 kernel as +w / -w pairs.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.nn.layers import Conv2d, _init_weight

__all__ = ["CARV4", "transform_pdc_kernel", "PDCConv", "PDCBlock", "CSAM",
           "CDCM", "MapReduce", "PiDiNet"]

CARV4 = ("cd", "ad", "rd", "cv") * 4

_AD_PERM = [3, 0, 1, 6, 4, 2, 7, 8, 5]
_RD_POS = [0, 2, 4, 10, 14, 20, 22, 24]
_RD_NEG = [6, 7, 8, 11, 13, 16, 17, 18]


def transform_pdc_kernel(w: torch.Tensor, pdc: str) -> torch.Tensor:
    """OIHW 3x3 kernel -> the plain conv kernel of the ``pdc`` type (5x5
    for ``rd``)."""
    if pdc == "cv":
        return w
    if pdc == "cd":
        center = torch.zeros_like(w)
        center[:, :, 1, 1] = w.sum(dim=(2, 3))
        return w - center
    flat = w.reshape(*w.shape[:2], 9)
    if pdc == "ad":
        return (flat - flat[:, :, _AD_PERM]).reshape(w.shape)
    if pdc == "rd":
        buf = w.new_zeros(*w.shape[:2], 25)
        buf[:, :, _RD_POS] = flat[:, :, 1:]
        buf[:, :, _RD_NEG] = -flat[:, :, 1:]
        return buf.reshape(*w.shape[:2], 5, 5)
    raise ValueError(pdc)


class PDCConv(nn.Module):
    """A (depthwise or dense) 3x3 conv whose kernel is PDC-transformed."""

    def __init__(self, in_channels: int, out_channels: int, pdc: str,
                 groups: int = 1, bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pdc, self.groups, self.dtype = pdc, groups, dtype
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _init_weight(self.weight, False, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        k = transform_pdc_kernel(self.weight, self.pdc).to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), k, b, padding=k.shape[-1] // 2,
                        groups=self.groups)


class PDCBlock(nn.Module):
    def __init__(self, pdc: str, in_channels: int, out_channels: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.conv1 = PDCConv(in_channels, in_channels, pdc,
                             groups=in_channels, dtype=dtype)
        self.conv2 = Conv2d(in_channels, out_channels, 1, padding=0,
                            bias=False, dtype=dtype)
        self.shortcut = (Conv2d(in_channels, out_channels, 1, padding=0,
                                dtype=dtype) if stride > 1 else None)

    def forward(self, x):
        if self.stride > 1:
            x = F.max_pool2d(x, 2, 2)
        y = self.conv2(F.relu(self.conv1(x)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return y + x


class CSAM(nn.Module):
    """Compact spatial attention (``model_edge.py:356-376``)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(channels, 4, 1, padding=0, dtype=dtype)
        self.conv2 = Conv2d(4, 1, 3, bias=False, dtype=dtype)

    def forward(self, x):
        y = self.conv2(self.conv1(F.relu(x)))
        return x * torch.sigmoid(y.float()).to(x.dtype)


class CDCM(nn.Module):
    """Compact dilation conv module (``model_edge.py:378-401``): the four
    dilated convs hold bare kernels (``conv2_{1..4}.weight``)."""

    DILATIONS = (5, 7, 9, 11)

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(in_channels, out_channels, 1, padding=0,
                            dtype=dtype)
        for i in range(len(self.DILATIONS)):
            setattr(self, f"conv2_{i + 1}", Conv2d(
                out_channels, out_channels, 3, bias=False, dtype=dtype))

    def forward(self, x):
        x = self.conv1(F.relu(x)).to(self.dtype)
        out = 0.0
        for i, d in enumerate(self.DILATIONS):
            w = getattr(self, f"conv2_{i + 1}").weight.to(self.dtype)
            out = out + F.conv2d(x, w, None, 1, d, d)
        return out


class MapReduce(nn.Module):
    """The per-stage 1x1 edge map (``conv_reduces.{i}.conv``)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, 1, 1, padding=0, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class PiDiNet(nn.Module):
    """The shipped sketch annotator: carv4, dil 24, sa (``table5_pidinet``).
    ``binarize=False`` returns the sigmoid map (in [-1, 1]) unthresholded."""

    def __init__(self, inplane: int = 60, dil: int = 24, sa: bool = True,
                 pdcs: Sequence[str] = CARV4, binarize: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.binarize = binarize
        with torch.device(resolve_device(device)):
            self.init_block = PDCConv(3, inplane, pdcs[0], dtype=dtype)
            idx, cin, stage_ch = 1, inplane, []
            for si, (mult, nblocks) in enumerate(((1, 3), (2, 4), (4, 4),
                                                  (4, 4))):
                cout = inplane * mult
                for bi in range(nblocks):
                    stride = 2 if si > 0 and bi == 0 else 1
                    setattr(self, f"block{si + 1}_{bi + 1}",
                            PDCBlock(pdcs[idx], cin, cout, stride, dtype))
                    idx, cin = idx + 1, cout
                stage_ch.append(cout)
            self.dilations = (nn.ModuleList(CDCM(c, dil, dtype)
                                            for c in stage_ch)
                              if dil else None)
            width = [dil if dil else c for c in stage_ch]
            self.attentions = (nn.ModuleList(CSAM(c, dtype) for c in width)
                               if sa else None)
            self.conv_reduces = nn.ModuleList(MapReduce(c, dtype)
                                              for c in width)
            self.classifier = Conv2d(4, 1, 1, padding=0)
            self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.classifier.weight.fill_(0.25)
            self.classifier.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x ``[B, 3, H, W]`` in [-1, 1] (fed unscaled, as the reference's
        training path does) -> edge map ``[B, 3, H, W]``."""
        size = x.shape[-2:]
        h = self.init_block(x)
        stages = []
        for si, nblocks in enumerate((3, 4, 4, 4)):
            for bi in range(nblocks):
                h = getattr(self, f"block{si + 1}_{bi + 1}")(h)
            stages.append(h)
        maps = []
        for i, y in enumerate(stages):
            if self.dilations is not None:
                y = self.dilations[i](y)
            if self.attentions is not None:
                y = self.attentions[i](y)
            maps.append(F.interpolate(self.conv_reduces[i](y), size=size,
                                      mode="bilinear", align_corners=False))
        out = torch.sigmoid(F.conv2d(torch.cat(maps, 1).float(),
                                     self.classifier.weight,
                                     self.classifier.bias))
        if self.binarize:
            out = (out > 0.5).float()
        return (out * 2.0 - 1.0).repeat(1, 3, 1, 1)
