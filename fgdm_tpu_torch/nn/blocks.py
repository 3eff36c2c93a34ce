"""UNet residual / resampling blocks (NCHW).

Counterpart of ``fgdm_tpu/nn/blocks.py``: ``ResBlock`` with both
``fused_norm`` branches (``blocks.py:80-108``), ``Upsample`` and
``Downsample``.  Module names and indices follow the reference's
``nn.Sequential`` layout, so state-dict keys match its checkpoints.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch.nn.layers import (Conv2d, Dense, FusedGroupNormSiLU,
                                      GroupNorm32, avg_pool_2x2,
                                      nearest_upsample_2x)

__all__ = ["silu", "Upsample", "Downsample", "ResBlock"]


def silu(x):
    return F.silu(x.float()).to(x.dtype)


class Upsample(nn.Module):
    def __init__(self, channels: int, use_conv: bool = True,
                 out_channels: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = (Conv2d(channels, out_channels or channels, 3,
                            dtype=dtype) if use_conv else None)

    def forward(self, x):
        x = nearest_upsample_2x(x)
        return x if self.conv is None else self.conv(x)


class Downsample(nn.Module):
    def __init__(self, channels: int, use_conv: bool = True,
                 out_channels: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = out_channels or channels
        if not use_conv and out != channels:
            raise ValueError("avg-pool Downsample keeps the channel count")
        self.op = (Conv2d(channels, out, 3, stride=2, padding=1, dtype=dtype)
                   if use_conv else None)

    def forward(self, x):
        return avg_pool_2x2(x) if self.op is None else self.op(x)


class ResBlock(nn.Module):
    """GroupNorm -> SiLU -> conv, timestep embedding (additive or FiLM),
    GroupNorm -> SiLU -> zero-init conv, learned or identity skip.

    ``fused_norm`` runs each GroupNorm+SiLU pair through the fused kernel;
    the parameters are the same either way."""

    def __init__(self, channels: int, emb_channels: int,
                 out_channels: Optional[int] = None, use_conv: bool = False,
                 use_scale_shift_norm: bool = False, up: bool = False,
                 down: bool = False, fused_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = out_channels or channels
        self.up, self.down = up, down
        self.fused_norm = fused_norm
        self.use_scale_shift_norm = use_scale_shift_norm
        norm = FusedGroupNormSiLU if fused_norm else GroupNorm32
        out_norm = GroupNorm32 if use_scale_shift_norm else norm
        # reference indices: in_layers = [norm, SiLU, conv],
        # emb_layers = [SiLU, Linear], out_layers = [norm, SiLU, Dropout,
        # conv]; the activations run in forward
        self.in_layers = nn.ModuleList([
            norm(channels), nn.Identity(), Conv2d(channels, out, 3, dtype=dtype)])
        self.emb_layers = nn.ModuleList([
            nn.Identity(),
            Dense(emb_channels, 2 * out if use_scale_shift_norm else out,
                  dtype=dtype)])
        self.out_layers = nn.ModuleList([
            out_norm(out), nn.Identity(), nn.Identity(),
            Conv2d(out, out, 3, zero_init=True, dtype=dtype)])
        if out == channels:
            self.skip_connection = nn.Identity()
        elif use_conv:
            self.skip_connection = Conv2d(channels, out, 3, dtype=dtype)
        else:
            self.skip_connection = Conv2d(channels, out, 1, padding=0,
                                          dtype=dtype)

    def forward(self, x, emb):
        h = self.in_layers[0](x)
        if not self.fused_norm:
            h = silu(h)
        if self.up:
            h, x = nearest_upsample_2x(h), nearest_upsample_2x(x)
        elif self.down:
            h, x = avg_pool_2x2(h), avg_pool_2x2(x)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers[1](silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = silu(self.out_layers[0](h) * (1 + scale) + shift)
        elif self.fused_norm:
            h = self.out_layers[0](h + emb_out)
        else:
            h = silu(self.out_layers[0](h + emb_out))
        return self.skip_connection(x) + self.out_layers[3](h)
