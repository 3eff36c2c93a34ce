"""Latent diffusion pipeline: UNet + VAE decoder + noise schedule.

Counterpart of ``fgdm_tpu/diffusion/latent_diffusion.py:64-107``:
``decode_first_stage`` undoes the 0.18215 ``scale_factor``; ``apply_model``
is the ``crossattn`` route of the reference's conditioning router, with
``pcond`` as the adapter prompt and ``adapter_on=False`` for the frozen-SD
path; ``denoise_fn`` closes over it for the samplers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from fgdm_tpu_torch.core.schedules import DiffusionSchedule
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL
from fgdm_tpu_torch.models.unet import UNetModel

__all__ = ["LatentDiffusion"]

Cond = Dict[str, Any]


@dataclasses.dataclass
class LatentDiffusion:
    unet: UNetModel
    vae: AutoencoderKL
    schedule: DiffusionSchedule
    scale_factor: float = 0.18215

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z / self.scale_factor)

    def apply_model(self, x_noisy, t, cond: Optional[Cond],
                    adapter_on: bool = True):
        """eps for x_noisy ``[B, 4, h, w]`` at timesteps t ``[B]``; cond
        carries ``c_crossattn`` and optionally ``pcond``."""
        cond = cond or {}
        if cond.get("extra_pconds") is not None:
            raise NotImplementedError("multi-adapter composition is not "
                                      "ported yet")
        return self.unet(x_noisy, t, context=cond["c_crossattn"],
                         pcond=cond.get("pcond"), adapter_on=adapter_on)

    def denoise_fn(self, adapter_on: bool = True):
        """``(x, t, cond) -> eps`` for the samplers."""

        def fn(x, t, cond):
            return self.apply_model(x, t, cond, adapter_on=adapter_on)

        return fn
