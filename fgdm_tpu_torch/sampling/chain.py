"""Factor-graph chain: text -> condition map -> image (the FG-DM product).

Counterpart of ``fgdm_tpu/sampling/chain.py:39-351``: factor 1 samples
condition-map latents with the adapter UNet (CFG 7.5), the VAE decodes them,
``condition_to_hint`` replays the reference's uint8 PNG hop and bilinear
resize, factor 2 renders the image with ControlNet (CFG 9.0), and a final
decode gives the image.  Each factor samples with DDIM, PLMS or
DPM-Solver++ (``sampler=``, ``_sample_factor_latents`` of ``chain.py:106``).
Images are NCHW; condition maps in [0, 1], the image in [-1, 1].  Guess mode
and ``fgdm_chain_n`` are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fgdm_tpu_torch.core.schedules import DDIMSchedule
from fgdm_tpu_torch.diffusion.control import ControlLDM
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion
from fgdm_tpu_torch.sampling.ddim import ddim_sample, derive_seed
from fgdm_tpu_torch.sampling.dpm_solver import dpm_solver_sample
from fgdm_tpu_torch.sampling.plms import plms_sample

__all__ = ["A_PROMPT", "N_PROMPT", "quantize_like_png", "condition_to_hint",
           "factor_slot_seeds", "sample_condition_factor",
           "sample_image_factor", "fgdm_chain"]

# factor 2's positive suffix and negative prompt (run_inference.sh)
A_PROMPT = "best quality, extremely detailed"
N_PROMPT = (
    "longbody, lowres, bad anatomy, bad hands, missing fingers, extra digit, "
    "fewer digits, cropped, worst quality, low quality"
)


def quantize_like_png(img01: torch.Tensor) -> torch.Tensor:
    """Round-trip through uint8, as the reference's PNG save/load does
    (in img01's dtype, as the JAX code; round half to even in both)."""
    return torch.round(img01.clamp(0.0, 1.0) * 255.0) / 255.0


def condition_to_hint(cond_img: torch.Tensor,
                      out_hw: Tuple[int, int]) -> torch.Tensor:
    """[0, 1] condition map ``[B, C, h, w]`` -> hint at ``out_hw``: quantize,
    then bilinear resize (half-pixel centers, as ``jax.image.resize``; the
    chain only upsamples, where neither antialiases)."""
    hint = quantize_like_png(cond_img)
    if tuple(out_hw) == tuple(hint.shape[-2:]):
        return hint
    return F.interpolate(hint.float(), size=tuple(out_hw), mode="bilinear",
                         align_corners=False).to(hint.dtype)


def factor_slot_seeds(slot_seeds: Sequence[int], factor: int) -> list:
    """Factor ``factor``'s per-slot seeds (1 = condition, 2 = image), each a
    function of its slot's seed alone (``chain.py:44 factor_slot_keys``)."""
    return [derive_seed(s, factor) for s in slot_seeds]


def _device(ld: LatentDiffusion) -> torch.device:
    return next(ld.unet.parameters()).device


def _sample_factor_latents(ld: LatentDiffusion, shape, cond, uncond,
                           num_steps: int, cfg_scale: float, eta: float,
                           x_T, generator, slot_seeds, sampler: str):
    """One factor's latents with a sampler choice (``chain.py:106-152``).
    PLMS and DPM-Solver++ are deterministic after x_T, which every sampler
    draws the same way (``ddim.initial_noise``: the slot seeds with DDIM's
    init tag), so the per-slot contract holds for all three."""
    noise = dict(x_T=x_T, generator=generator, slot_seeds=slot_seeds,
                 device=_device(ld))
    if sampler == "ddim":
        sched = DDIMSchedule.create(ld.schedule, num_steps, eta=eta)
        return ddim_sample(ld.denoise_fn(), shape, sched, cond=cond,
                           uncond=uncond, cfg_scale=cfg_scale, **noise)
    if eta != 0.0:
        # plms: the multistep update has no stochastic term (the reference
        # PLMS asserts ddim_eta == 0); dpm: an ODE solver, no eta
        raise ValueError(f"sampler {sampler!r} requires eta=0 (got {eta})")
    if sampler == "plms":
        sched = DDIMSchedule.create(ld.schedule, num_steps)
        return plms_sample(ld.denoise_fn(), shape, sched, cond=cond,
                           uncond=uncond, cfg_scale=cfg_scale, **noise)
    if sampler == "dpm":
        return dpm_solver_sample(ld.denoise_fn(), shape, ld.schedule, cond,
                                 uncond, cfg_scale, steps=num_steps, **noise)
    raise ValueError(f"unknown sampler {sampler!r} (ddim|plms|dpm)")


@torch.inference_mode()
def sample_condition_factor(ld: LatentDiffusion, cond_ctx, uncond_ctx,
                            latent_hw: Tuple[int, int] = (32, 32),
                            num_steps: int = 50, cfg_scale: float = 7.5,
                            eta: float = 0.0, x_T=None, generator=None,
                            slot_seeds: Optional[Sequence[int]] = None,
                            sampler: str = "ddim"):
    """Factor 1: prompt contexts ``[B, 77, 768]`` -> condition latents;
    ``sampler`` is ddim, plms or dpm."""
    b = cond_ctx.shape[0]
    shape = (b, ld.unet.in_channels) + tuple(latent_hw)
    return _sample_factor_latents(
        ld, shape, {"c_crossattn": cond_ctx}, {"c_crossattn": uncond_ctx},
        num_steps, cfg_scale, eta, x_T, generator, slot_seeds, sampler)


@torch.inference_mode()
def sample_image_factor(cldm: ControlLDM, hint, cond_ctx, uncond_ctx,
                        num_steps: int = 20, cfg_scale: float = 9.0,
                        eta: float = 0.0, guess_mode: bool = False,
                        x_T=None, generator=None,
                        slot_seeds: Optional[Sequence[int]] = None,
                        sampler: str = "ddim"):
    """Factor 2: hint ``[B, 3, H, W]`` in [0, 1] -> image latents
    ``[B, 4, H/8, W/8]`` via ControlNet.  The hint pyramid runs once."""
    if guess_mode:
        raise NotImplementedError("guess mode is not ported yet")
    b, _, hh, ww = hint.shape
    shape = (b, cldm.unet.in_channels, hh // 8, ww // 8)
    hint_emb = cldm.encode_hint(hint)
    return _sample_factor_latents(
        cldm, shape, {"c_crossattn": cond_ctx, "c_hint_emb": hint_emb},
        {"c_crossattn": uncond_ctx, "c_hint_emb": hint_emb}, num_steps,
        cfg_scale, eta, x_T, generator, slot_seeds, sampler)


@torch.inference_mode()
def fgdm_chain(ld: LatentDiffusion, cldm: ControlLDM, prompt_ctx, empty_ctx,
               cn_prompt_ctx, cn_neg_ctx,
               cond_hw: Tuple[int, int] = (256, 256),
               image_hw: Tuple[int, int] = (512, 512), f1_steps: int = 50,
               f2_steps: int = 20, f1_scale: float = 7.5,
               f2_scale: float = 9.0, generator=None,
               slot_seeds: Optional[Sequence[int]] = None,
               f1_sampler: str = "ddim", f2_sampler: str = "ddim"
               ) -> Dict[str, torch.Tensor]:
    """The full text -> condition -> image chain.

    Returns ``condition`` ([0, 1] at cond_hw), ``hint`` (resized) and
    ``image`` ([-1, 1] at image_hw).  Noise comes from ``slot_seeds`` (one
    non-negative int per batch slot; a slot's result does not depend on the
    batch it ran in) or else from ``generator``."""
    if slot_seeds is None and generator is None:
        raise ValueError("fgdm_chain needs slot_seeds or a generator")
    s1 = s2 = None
    if slot_seeds is not None:
        s1 = factor_slot_seeds(slot_seeds, 1)
        s2 = factor_slot_seeds(slot_seeds, 2)
    z_cond = sample_condition_factor(
        ld, prompt_ctx, empty_ctx,
        latent_hw=(cond_hw[0] // 8, cond_hw[1] // 8), num_steps=f1_steps,
        cfg_scale=f1_scale, generator=generator, slot_seeds=s1,
        sampler=f1_sampler)
    cond_img = ((ld.decode_first_stage(z_cond) + 1.0) / 2.0).clamp(0.0, 1.0)
    hint = condition_to_hint(cond_img, image_hw)
    z_img = sample_image_factor(cldm, hint, cn_prompt_ctx, cn_neg_ctx,
                                num_steps=f2_steps, cfg_scale=f2_scale,
                                generator=generator, slot_seeds=s2,
                                sampler=f2_sampler)
    image = cldm.decode_first_stage(z_img)
    return {"condition": cond_img, "hint": hint, "image": image}
