"""Latent diffusion pipeline: UNet + VAE + CLIP + noise schedule.

Counterpart of ``fgdm_tpu/diffusion/latent_diffusion.py:50-121``:
``get_learned_conditioning`` runs CLIP on token ids;
``encode_first_stage`` / ``decode_first_stage`` apply and undo the 0.18215
``scale_factor``; ``apply_model`` is the reference's conditioning router
(``DiffusionWrapper``, JAX ``:81-89``): by ``conditioning_key``,
``concat`` concatenates ``c_concat`` onto the latent's channels,
``crossattn`` passes ``c_crossattn`` as the context, ``hybrid`` does both
and ``adm`` passes ``c_adm`` as the class labels ``y``; with ``pcond`` as the
adapter prompt, ``extra_pconds`` as the extra adapters' prompts,
``adapter_on=False`` for the frozen-SD path and ``capture`` for the
attention maps, under every key; ``denoise_fn``
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

__all__ = ["LatentDiffusion", "CONDITIONING_KEYS"]

Cond = Dict[str, Any]

# the keys JAX's router takes (None: no conditioning input)
CONDITIONING_KEYS = (None, "crossattn", "concat", "hybrid", "adm")


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
    conditioning_key: Optional[str] = "crossattn"

    def __post_init__(self):
        if self.conditioning_key not in CONDITIONING_KEYS:
            raise ValueError(f"conditioning_key {self.conditioning_key!r}: "
                             f"not one of {CONDITIONING_KEYS}")

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
        carries what ``conditioning_key`` routes (``c_crossattn``,
        ``c_concat``, ``c_adm``) and optionally ``pcond`` and
        ``extra_pconds`` (a list of earlier factors' latents for the extra
        adapters).  With ``capture``, ``(eps, selfattn, crossattn)``
        (``UNetModel.forward``)."""
        cond = cond or {}
        key = self.conditioning_key
        xc, kw = x_noisy, {}
        if key in ("concat", "hybrid"):
            xc = torch.cat([x_noisy, cond["c_concat"]], dim=1)
        if key in ("crossattn", "hybrid"):
            kw["context"] = cond["c_crossattn"]
        if key == "adm":
            kw["y"] = cond["c_adm"]
        return self.unet(xc, t, pcond=cond.get("pcond"),
                         adapter_on=adapter_on, capture=capture,
                         extra_pconds=cond.get("extra_pconds"), **kw)

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
