"""HED edge detector (ControlNetHED), the sketch factor's ``use_hed``
annotator.

Counterpart of ``fgdm_tpu/annotators/hed.py:27-68`` (the reference's
``ldm/models/hed.py:17-80``): a learned per-channel input shift, five
VGG-style ``DoubleConvBlock``s (2/2/3/3/3 3x3 convs with ReLU, a 2x2 VALID
max pool before every block but the first), each with a 1x1 edge
projection; the five projections are resized to the input (bilinear,
half-pixel centres, never shrinking, so no antialias), averaged over the
five, squashed by a sigmoid and repeated to 3 channels in [-1, 1].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.nn.layers import Conv2d

__all__ = ["DoubleConvBlock", "ControlNetHED"]

_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class DoubleConvBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 layer_number: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv2d(in_channels if i == 0 else out_channels, out_channels, 3,
                   dtype=dtype) for i in range(layer_number))
        self.projection = Conv2d(out_channels, 1, 1, padding=0, dtype=dtype)

    def forward(self, x, down_sampling: bool = False):
        h = F.max_pool2d(x, 2, 2) if down_sampling else x
        for conv in self.convs:
            h = F.relu(conv(h))
        return h, self.projection(h)


class ControlNetHED(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.norm = nn.Parameter(torch.zeros(1, 3, 1, 1))
            cin = 3
            for i, (c, n) in enumerate(_BLOCKS):
                setattr(self, f"block{i + 1}", DoubleConvBlock(cin, c, n,
                                                               dtype))
                cin = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x ``[B, 3, H, W]`` in [-1, 1] -> edge map ``[B, 3, H, W]`` in
        [-1, 1]."""
        size = x.shape[-2:]
        h = (x + 1.0) * 127.5 - self.norm
        projs = []
        for i in range(len(_BLOCKS)):
            h, p = getattr(self, f"block{i + 1}")(h, down_sampling=i > 0)
            projs.append(F.interpolate(p, size=size, mode="bilinear",
                                       align_corners=False))
        edge = torch.sigmoid(torch.cat(projs, 1).float().mean(1))
        return (edge * 2.0 - 1.0)[:, None].repeat(1, 3, 1, 1)
