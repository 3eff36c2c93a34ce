"""Joint two-factor UNet: a condition -> image chain in one forward (NCHW).

Counterpart of ``fgdm_tpu/models/seq_two_unet.py:33-149``: the latent's
channels split in half, the image half first; ``unet2`` denoises the
condition half, and its x0 prediction (from this module's own linear
schedule, clamped to [-1, 1]) goes through the 1x1 ``channel_mapper`` into
``unet1``: concatenated onto its input, or, with ``image_adapter``, as the
prompt of ``unet1``'s FG-DM adapter.  The output stacks both factors' eps,
so a standard DDIM scan co-denoises them (``joint_denoise_fn``).

With ``cond_map`` the condition is known: ``unet2`` does not run, its eps
slot is zeros and ``cond_map`` takes the x0's place (the joint training
step feeds the clean condition latent this way).  ``use_control`` passes
ControlNet residuals to ``unet2``.  Both UNets are built without the fused
GroupNorm+SiLU, as JAX builds them; ``remat`` goes to both.  The casts are
JAX's: the x0 in float32, ``channel_mapper`` in the model's dtype, then
the dtype of the image half.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.core.schedules import DiffusionSchedule
from fgdm_tpu_torch.models.unet import UNetModel
from fgdm_tpu_torch.nn.layers import Conv2d

__all__ = ["SeqTwoUNet", "joint_denoise_fn"]


class SeqTwoUNet(nn.Module):
    """Two chained UNets over a channel-stacked two-factor latent."""

    def __init__(self, factor_channels: int = 4, mapped_channels: int = 4,
                 model_channels: int = 320, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_heads: int = 8, transformer_depth: int = 1,
                 context_dim: Optional[int] = 768,
                 use_map_channel_mapper: bool = True,
                 use_control: bool = False, image_adapter: bool = False,
                 remat: bool = False, dtype: torch.dtype = torch.bfloat16,
                 linear_start: float = 0.00085, linear_end: float = 0.0120,
                 timesteps: int = 1000, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.factor_channels = factor_channels
        self.use_control, self.image_adapter = use_control, image_adapter
        self.dtype = dtype
        common = dict(model_channels=model_channels,
                      num_res_blocks=num_res_blocks,
                      attention_resolutions=attention_resolutions,
                      channel_mult=channel_mult, num_heads=num_heads,
                      transformer_depth=transformer_depth,
                      context_dim=context_dim, remat=remat, dtype=dtype,
                      out_channels=factor_channels, device=dev)
        self.unet2 = UNetModel(in_channels=factor_channels, use_adapter=False,
                               **common)
        if image_adapter:
            self.unet1 = UNetModel(in_channels=factor_channels,
                                   use_adapter=True,
                                   adapter_channels=mapped_channels, **common)
        else:
            self.unet1 = UNetModel(
                in_channels=factor_channels + mapped_channels,
                use_adapter=False, **common)
        self.channel_mapper = None
        if use_map_channel_mapper:
            with torch.device(dev):
                self.channel_mapper = Conv2d(factor_channels, mapped_channels,
                                             1, padding=0, bias=False,
                                             dtype=dtype)
        self.schedule = DiffusionSchedule.create(
            timesteps=timesteps, beta_schedule="linear",
            linear_start=linear_start, linear_end=linear_end)

    def forward(self, x, timesteps, context=None, cond_map=None,
                control=None):
        """x ``[B, 2 * factor_channels, H, W]`` (image half first) ->
        ``[B, 2 * factor_channels, H, W]``: ``unet1``'s eps, then
        ``unet2``'s (zeros with ``cond_map``)."""
        h1, h2 = x.chunk(2, dim=1)
        if cond_map is not None:
            h2_recon = cond_map
            eps2 = torch.zeros_like(h2)
        else:
            kw = ({"control": control}
                  if self.use_control and control is not None else {})
            eps2 = self.unet2(h2, timesteps, context=context, **kw)
            h2_recon = self.schedule.predict_start_from_noise(
                h2.float(), timesteps, eps2).clamp(-1.0, 1.0)
        if self.channel_mapper is not None:
            h2_recon = self.channel_mapper(h2_recon.to(self.dtype))
        if self.image_adapter:
            eps1 = self.unet1(h1, timesteps, context=context,
                              pcond=h2_recon.to(h1.dtype))
        else:
            eps1 = self.unet1(torch.cat([h1, h2_recon.to(h1.dtype)], dim=1),
                              timesteps, context=context)
        return torch.cat([eps1, eps2.to(eps1.dtype)], dim=1)


def joint_denoise_fn(model: SeqTwoUNet):
    """``(x, t, cond) -> stacked eps`` for ``sampling/ddim.py ddim_sample``
    and its CFG: both factors co-denoise under one sampler."""

    def fn(x, t, cond):
        ctx = cond.get("c_crossattn") if cond else None
        return model(x, t, context=ctx)

    return fn
