"""Latent diffusion pipeline: UNet + VAE + CLIP + noise schedule.

Counterpart of ``fgdm_tpu/diffusion/latent_diffusion.py:50-121``:
``get_learned_conditioning`` runs CLIP on token ids;
``encode_first_stage`` / ``decode_first_stage`` apply and undo the 0.18215
``scale_factor``; ``apply_model`` is the ``crossattn`` route of the
reference's conditioning router, with ``pcond`` as the adapter prompt,
``extra_pconds`` as the extra adapters' prompts, ``adapter_on=False`` for
the frozen-SD path and ``capture`` for the attention maps; ``denoise_fn``
closes over it for the samplers and ``capture_fn`` for the attention-guided
sampler; ``q_sample`` is the schedule's; ``calibrate_scale_by_std``
(``:123-132``) is the ``scale_by_std`` calibration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from fgdm_tpu_torch.core.schedules import DiffusionSchedule
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL
from fgdm_tpu_torch.models.clip import CLIPTextEncoder
from fgdm_tpu_torch.models.unet import UNetModel

__all__ = ["LatentDiffusion"]

Cond = Dict[str, Any]


@dataclasses.dataclass
class LatentDiffusion:
    unet: UNetModel
    vae: AutoencoderKL
    schedule: DiffusionSchedule
    scale_factor: float = 0.18215
    clip: Optional[CLIPTextEncoder] = None
    # what ``checkpoint/loader.py`` read into the modules, if it built them
    load_report: Optional[Dict[str, Any]] = dataclasses.field(default=None,
                                                              repr=False)

    def get_learned_conditioning(self, input_ids) -> torch.Tensor:
        return self.clip(input_ids)

    def encode_first_stage(self, img, eps: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
        """img ``[B, 3, H, W]`` in [-1, 1] -> scaled latent
        ``[B, 4, H/8, W/8]``: a posterior sample with the injected ``eps``
        or one drawn from ``generator``; the posterior mode if neither."""
        posterior = self.vae.encode(img)
        if eps is None and generator is None:
            z = posterior.mode()
        else:
            z = posterior.sample(eps, generator)
        return self.scale_factor * z

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z / self.scale_factor)

    def apply_model(self, x_noisy, t, cond: Optional[Cond],
                    adapter_on: bool = True, capture=False):
        """eps for x_noisy ``[B, 4, h, w]`` at timesteps t ``[B]``; cond
        carries ``c_crossattn`` and optionally ``pcond`` and
        ``extra_pconds`` (a list of earlier factors' latents for the extra
        adapters).  With ``capture``, ``(eps, selfattn, crossattn)``
        (``UNetModel.forward``)."""
        cond = cond or {}
        return self.unet(x_noisy, t, context=cond["c_crossattn"],
                         pcond=cond.get("pcond"), adapter_on=adapter_on,
                         capture=capture,
                         extra_pconds=cond.get("extra_pconds"))

    def denoise_fn(self, adapter_on: bool = True):
        """``(x, t, cond) -> eps`` for the samplers."""

        def fn(x, t, cond):
            return self.apply_model(x, t, cond, adapter_on=adapter_on)

        return fn

    def capture_fn(self, adapter_on: bool = True, mode="probs"):
        """``(x, t, cond) -> (eps, selfattn, crossattn)`` for the
        attention-guided sampler; ``"probs"`` captures per-head
        probabilities."""

        def fn(x, t, cond):
            return self.apply_model(x, t, cond, adapter_on=adapter_on,
                                    capture=mode)

        return fn

    def q_sample(self, x_start, t, noise):
        return self.schedule.q_sample(x_start, t, noise)

    def calibrate_scale_by_std(self, probe, eps: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None
                               ) -> "LatentDiffusion":
        """``scale_by_std``: this pipeline (the same modules) with
        ``scale_factor = 1 / std`` of the unscaled latents of ``probe``, the
        population std in float32, as the reference calibrates on its first
        training batch (``ddpm.py:580-597``).  The latents are a posterior
        sample with ``eps`` or from ``generator``, else the mode."""
        with torch.no_grad():
            z = dataclasses.replace(self, scale_factor=1.0).encode_first_stage(
                probe, eps=eps, generator=generator)
            std = float(torch.std(z.float(), correction=0))
        return dataclasses.replace(self, scale_factor=1.0 / std)
