"""FG-DM side adapter (T2I-Adapter style conv pyramid).

Counterpart of ``fgdm_tpu/models/adapter.py:29-93``: ``AdapterResnetBlock``
(optional 2x down, optional in-conv on channel changes, conv3x3 -> ReLU ->
conv(ksize), identity or learned skip) and ``Adapter`` (``conv_in`` then
``len(channels) * nums_rb`` blocks, one feature per scale).  ``TimeAdapter``,
``AdapterLight`` and ``Extractor`` are not ported.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch.nn.layers import Conv2d, avg_pool_2x2

__all__ = ["AdapterResnetBlock", "Adapter"]


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

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = self.conv_in(x)
        feats = []
        for i, blk in enumerate(self.body):
            x = blk(x)
            if (i + 1) % self.nums_rb == 0:
                feats.append(x)
        return tuple(feats)
