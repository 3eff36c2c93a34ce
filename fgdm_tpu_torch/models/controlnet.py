"""ControlNet branch: a trainable SD-encoder copy with zero-conv taps.

Counterpart of ``fgdm_tpu/models/controlnet.py:56-156``: the hint pyramid
(``input_hint_block``: eight 3x3 convs, three of stride 2, the last zero-init)
maps the RGB hint to latent resolution and is added once after the first
conv; every input block and the middle block emit a residual through a 1x1
zero conv (13 taps for SD-1.4).  ``hint_only`` returns the pyramid output,
which samplers compute once and pass back per step as ``hint_emb``.

``seq_axis`` (context parallelism, ``controlnet.py:111``): x, the hint (or
``hint_emb``) and the residuals hold this rank's rows; the hint pyramid's
stride-2 convs take the row above from the rank above, and the levels run
as the UNet's (``models/unet.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.models.unet import (build_encoder, down_levels,
                                        embed_timesteps, run_block,
                                        time_embed)
from fgdm_tpu_torch.nn.blocks import silu
from fgdm_tpu_torch.nn.layers import Conv2d
from fgdm_tpu_torch.parallel import context as cp

__all__ = ["ControlNet", "guess_mode_scales"]

# hint pyramid: (out channels, stride) of the seven SiLU-activated convs
_HINT_CHS = ((16, 1), (16, 1), (32, 2), (32, 1), (96, 2), (96, 1), (256, 2))


class ControlNet(nn.Module):
    def __init__(self, in_channels: int = 4, model_channels: int = 320,
                 hint_channels: int = 3, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_heads: int = 8, num_head_channels: int = -1,
                 transformer_depth: int = 1,
                 context_dim: Optional[int] = 768,
                 use_scale_shift_norm: bool = False,
                 conv_resample: bool = True, fused_norm_silu: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 seq_axis: Optional[str] = None, device=None):
        super().__init__()
        mc = model_channels
        self.model_channels, self.dtype = mc, dtype
        self.channel_mult = tuple(channel_mult)
        self.seq_axis = seq_axis
        with torch.device(resolve_device(device)):
            self.time_embed = time_embed(mc, dtype)
            hint, cin = [], hint_channels
            for cout, stride in _HINT_CHS:
                # reference indices: conv, SiLU, conv, SiLU, ...
                hint += [Conv2d(cin, cout, 3, stride=stride, padding=1,
                                dtype=dtype), nn.Identity()]
                cin = cout
            hint.append(Conv2d(cin, mc, 3, zero_init=True, dtype=dtype))
            self.input_hint_block = nn.ModuleList(hint)
            (self.input_blocks, self.middle_block, chans, _,
             _) = build_encoder(
                in_channels, mc, num_res_blocks, attention_resolutions,
                channel_mult, num_heads, num_head_channels, transformer_depth,
                context_dim, use_scale_shift_norm, conv_resample,
                fused_norm_silu, dtype, seq_axis=seq_axis)
            self._down_at = down_levels(self.input_blocks)
            self.zero_convs = nn.ModuleList([
                nn.ModuleList([Conv2d(c, c, 1, padding=0, zero_init=True,
                                      dtype=dtype)]) for c in chans])
            self.middle_block_out = nn.ModuleList([
                Conv2d(chans[-1], chans[-1], 1, padding=0, zero_init=True,
                       dtype=dtype)])

    def encode_hint(self, hint):
        with cp.sharded(self.seq_axis):
            return self._encode_hint(hint)

    def _encode_hint(self, hint):
        g = hint.to(self.dtype)
        for conv in self.input_hint_block[:-1:2]:
            g = silu(conv(g))
        return self.input_hint_block[-1](g)

    def forward(self, x, hint, timesteps, context, hint_emb=None,
                hint_only: bool = False):
        """The 13 zero-conv residuals; with ``hint_only`` just the hint
        pyramid embedding ``[B, mc, h, w]``."""
        rows = None if x is None else x.shape[2]
        with cp.sharded(self.seq_axis, rows, len(self.channel_mult)):
            return self._forward(x, hint, timesteps, context, hint_emb,
                                 hint_only)

    def _forward(self, x, hint, timesteps, context, hint_emb, hint_only):
        if hint_emb is None or hint_only:
            guided = self._encode_hint(hint)
            if hint_only:
                return guided
        else:
            guided = hint_emb.to(self.dtype)
        emb = embed_timesteps(self.time_embed, timesteps, self.model_channels)
        h = x.to(self.dtype)
        outs = []
        for i, (block, zc) in enumerate(zip(self.input_blocks,
                                            self.zero_convs)):
            if i in self._down_at:
                h = cp.enter_down(h, self._down_at[i])
            h = run_block(block, h, emb, context)
            if i == 0:
                h = h + guided
            outs.append(zc[0](h))
        h = run_block(self.middle_block, h, emb, context)
        outs.append(self.middle_block_out[0](h))
        return tuple(outs)


def guess_mode_scales(strength: float = 1.0, num: int = 13) -> Tuple[float, ...]:
    """Guess mode's geometric decay ``strength * 0.825 ** (12 - i)``."""
    return tuple(strength * (0.825 ** float(num - 1 - i)) for i in range(num))
