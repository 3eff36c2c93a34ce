"""Full-width SD-1.4 FG-DM chain with seeded random weights.

Counterpart of ``bench.py:95-155``: the factor-1 ``LatentDiffusion`` (SD-1.4
UNet + FG-DM adapter) and the factor-2 ``ControlLDM`` (SD UNet without
adapter + ControlNet), sharing one VAE decoder; bf16 compute over float32
params, fused GroupNorm+SiLU on.  The weights are drawn on the device from
explicit generators; the UNets and ControlNet then get the 0.02 N(0, 1)
perturbation of ``tests/test_golden_chain.py:46-64`` so their zero-init
heads do work.  About 2.2B parameters, 9 GB in float32.
"""

from __future__ import annotations

import torch

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.core.schedules import DiffusionSchedule
from fgdm_tpu_torch.diffusion.control import ControlLDM
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL
from fgdm_tpu_torch.models.controlnet import ControlNet
from fgdm_tpu_torch.models.unet import UNetModel
from fgdm_tpu_torch.nn.layers import init_params_

__all__ = ["sd14_schedule", "build_unet", "build_chain"]

_PERTURB = 0.02


def sd14_schedule() -> DiffusionSchedule:
    return DiffusionSchedule.create(1000, "linear", linear_start=0.00085,
                                    linear_end=0.0120)


def _seeded(module: torch.nn.Module, device, seed: int, perturb: float):
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params_(module, gen, perturb).eval()


def build_unet(device=None, dtype=torch.bfloat16, fused_norm: bool = True,
               use_adapter: bool = True, seed: int = 0) -> UNetModel:
    """A full-width SD-1.4 UNet (with or without the FG-DM adapter)."""
    dev = resolve_device(device)
    unet = UNetModel(use_adapter=use_adapter, fused_norm_silu=fused_norm,
                     dtype=dtype, device=dev)
    return _seeded(unet, dev, seed, _PERTURB)


def build_chain(device=None, dtype=torch.bfloat16, fused_norm: bool = True,
                seed: int = 0):
    """``(LatentDiffusion, ControlLDM)`` of the FG-DM chain at SD-1.4 width."""
    dev = resolve_device(device)
    vae = _seeded(AutoencoderKL(fused_norm=fused_norm, dtype=dtype,
                                device=dev), dev, seed + 3, 0.0)
    control = _seeded(ControlNet(fused_norm_silu=fused_norm, dtype=dtype,
                                 device=dev), dev, seed + 2, _PERTURB)
    sched = sd14_schedule()
    ld = LatentDiffusion(build_unet(dev, dtype, fused_norm, True, seed), vae,
                         sched)
    cldm = ControlLDM(build_unet(dev, dtype, fused_norm, False, seed + 1), vae,
                      sched, control=control)
    return ld, cldm
