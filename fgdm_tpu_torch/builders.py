"""Full-width SD-1.4 FG-DM pipelines with seeded random weights.

``build_chain`` is the counterpart of ``bench.py:95-155``: the factor-1
``LatentDiffusion`` (SD-1.4 UNet + FG-DM adapter) and the factor-2
``ControlLDM`` (SD UNet without adapter + ControlNet), sharing one VAE; bf16
compute over float32 params, fused GroupNorm+SiLU on.  Each pipeline also
gets its own CLIP ViT-L/14 text tower, as ``checkpoint/loader.py:99-230``
builds them without checkpoints, so ``get_learned_conditioning`` works (the
serving engine embeds real tokens).  About 2.4B parameters, 9.8 GB in
float32.

``build_trainer`` is the counterpart of ``tools/bench_train.py:49-79``: the
adapter-only fine-tuning step at 256^2 (UNet with adapter, VAE and CLIP,
AdamW on the adapter partition), with a seeded synthetic batch.

The weights are drawn on the device from explicit generators; the UNets and
ControlNet then get the 0.02 N(0, 1) perturbation of
``tests/test_golden_chain.py:46-64`` so their zero-init heads do work (and
pass gradients to the adapter).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.core.schedules import DiffusionSchedule
from fgdm_tpu_torch.diffusion.control import ControlLDM
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL
from fgdm_tpu_torch.models.clip import CLIPTextEncoder, CLIPTokenizer
from fgdm_tpu_torch.models.controlnet import ControlNet
from fgdm_tpu_torch.models.unet import UNetModel
from fgdm_tpu_torch.nn.layers import init_params_
from fgdm_tpu_torch.train.state import TrainState, adapter_filter, make_adamw
from fgdm_tpu_torch.train.train_step import make_train_step

__all__ = ["sd14_schedule", "build_unet", "build_chain", "Trainer",
           "build_trainer", "PROMPTS"]

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
    """``(LatentDiffusion, ControlLDM)`` of the FG-DM chain at SD-1.4 width,
    each with its CLIP text tower."""
    dev = resolve_device(device)
    vae = _seeded(AutoencoderKL(fused_norm=fused_norm, dtype=dtype,
                                device=dev), dev, seed + 3, 0.0)
    control = _seeded(ControlNet(fused_norm_silu=fused_norm, dtype=dtype,
                                 device=dev), dev, seed + 2, _PERTURB)
    clip, cn_clip = (_seeded(CLIPTextEncoder(dtype=dtype, device=dev), dev,
                             s, 0.0) for s in (seed + 4, seed + 5))
    sched = sd14_schedule()
    ld = LatentDiffusion(build_unet(dev, dtype, fused_norm, True, seed), vae,
                         sched, clip=clip)
    cldm = ControlLDM(build_unet(dev, dtype, fused_norm, False, seed + 1), vae,
                      sched, clip=cn_clip, control=control)
    return ld, cldm


# Eight prompts of the kind the seg-factor fine-tuning data carries.
PROMPTS = [
    "a dog running on the beach", "two people riding bicycles in a park",
    "a red car parked next to a building", "a cat sleeping on a sofa",
    "a kitchen with a table and chairs", "a horse in a green field",
    "a man holding a surfboard near the ocean",
    "a bowl of fruit on a wooden table",
]


@dataclasses.dataclass
class Trainer:
    """What ``build_trainer`` returns: the pipeline, the train state over
    ``ld.unet``, the step, and a seeded synthetic batch for it."""

    ld: LatentDiffusion
    state: TrainState
    train_step: Callable
    batch: Dict[str, torch.Tensor]


def build_trainer(device=None, seed: int = 0, batch: int = 8,
                  lr: float = 1e-5, use_ema: bool = False) -> Trainer:
    """The adapter-only fine-tuning step of ``tools/bench_train.py`` at SD-1.4
    width: UNet with adapter (fused norms, bf16 compute over f32 params, no
    activation checkpointing), VAE (fused norms) and CLIP in bf16, the
    linear 0.00085-0.012 schedule, AdamW(``lr``) on the adapter partition.
    The batch holds ``batch`` seeded 256^2 images in [-1, 1] and the
    hash-fallback tokens of ``PROMPTS``."""
    dev = resolve_device(device)
    dtype = torch.bfloat16
    unet = build_unet(dev, dtype, True, True, seed)
    vae = _seeded(AutoencoderKL(fused_norm=True, dtype=dtype, device=dev),
                  dev, seed + 3, 0.0).requires_grad_(False)
    clip = _seeded(CLIPTextEncoder(dtype=dtype, device=dev), dev, seed + 4,
                   0.0).requires_grad_(False)
    ld = LatentDiffusion(unet, vae, sd14_schedule().to(dev), clip=clip)
    state = TrainState.create(unet, make_adamw(lr),
                              trainable_filter=adapter_filter(),
                              use_ema=use_ema)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    image = torch.randn(batch, 3, 256, 256, device=dev,
                        generator=gen).clamp_(-1.0, 1.0)
    ids = CLIPTokenizer()([PROMPTS[i % len(PROMPTS)] for i in range(batch)])
    return Trainer(ld, state, make_train_step(ld),
                   {"image": image, "input_ids": ids.to(dev)})
