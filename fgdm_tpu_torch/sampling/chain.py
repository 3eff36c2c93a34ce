"""Factor-graph chain: text -> condition map -> image (the FG-DM product).

Counterpart of ``fgdm_tpu/sampling/chain.py:39-351``: factor 1 samples
condition-map latents with the adapter UNet (CFG 7.5), the VAE decodes them,
``condition_to_hint`` replays the reference's uint8 PNG hop and bilinear
resize, factor 2 renders the image with ControlNet (CFG 9.0), and a final
decode gives the image.  Each factor samples with DDIM, PLMS or
DPM-Solver++ (``sampler=``, ``_sample_factor_latents`` of ``chain.py:106``).
``fgdm_chain_n`` (``chain.py:219-296``) chains N condition factors
(text -> seg -> depth -> normal -> ...), each adapter-prompted by the
previous factor's latent, and renders the last map with ControlNet.
Images are NCHW; condition maps in [0, 1], the image in [-1, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fgdm_tpu_torch.core.schedules import DDIMSchedule
from fgdm_tpu_torch.diffusion.control import ControlLDM
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion
from fgdm_tpu_torch.models.controlnet import guess_mode_scales
from fgdm_tpu_torch.sampling.ddim import ddim_sample, derive_seed
from fgdm_tpu_torch.sampling.dpm_solver import dpm_solver_sample
from fgdm_tpu_torch.sampling.plms import plms_sample
from fgdm_tpu_torch.utils.profiling import span

__all__ = ["A_PROMPT", "N_PROMPT", "quantize_like_png", "condition_to_hint",
           "latent_to_condition_image", "factor_slot_seeds",
           "sample_condition_factor",
           "sample_image_factor", "fgdm_chain_n", "fgdm_chain"]

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
    with span("chain.hint"):
        hint = quantize_like_png(cond_img)
        if tuple(out_hw) == tuple(hint.shape[-2:]):
            return hint
        return F.interpolate(hint.float(), size=tuple(out_hw),
                             mode="bilinear", align_corners=False
                             ).to(hint.dtype)


@torch.inference_mode()
def latent_to_condition_image(ld: LatentDiffusion, samples: torch.Tensor,
                              out_hw: Tuple[int, int]) -> torch.Tensor:
    """Factor-1 latents -> the [0, 1] hint at ``out_hw``: VAE decode, then
    ``condition_to_hint`` (``chain.py:66-73``)."""
    x = ld.decode_first_stage(samples)
    return condition_to_hint(((x + 1.0) / 2.0).clamp(0.0, 1.0), out_hw)


def factor_slot_seeds(slot_seeds: Sequence[int], factor: int) -> list:
    """Factor ``factor``'s per-slot seeds (1 = the first condition factor,
    2 = the next factor or the image render, ...), each a function of its
    slot's seed alone (``chain.py:44 factor_slot_keys``)."""
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
                        eta: float = 0.0, strength: float = 1.0,
                        guess_mode: bool = False, x_T=None, generator=None,
                        slot_seeds: Optional[Sequence[int]] = None,
                        sampler: str = "ddim"):
    """Factor 2: hint ``[B, 3, H, W]`` in [0, 1] -> image latents
    ``[B, 4, H/8, W/8]`` via ControlNet.  The hint pyramid runs once.

    ``strength`` scales every control residual (``chain.py:205-207``).
    ``guess_mode`` (``chain.py:183-203``, reference ``initialize_cn.py:
    86-91``) samples with DDIM only; the control scales decay geometrically
    from ``strength`` (``guess_mode_scales``), and the uncond branch runs
    the UNet with no control residuals at all (a zero hint would still
    give some), so the two branches are two forwards, not one batch."""
    b, _, hh, ww = hint.shape
    shape = (b, cldm.unet.in_channels, hh // 8, ww // 8)
    hint_emb = cldm.encode_hint(hint)
    if guess_mode:
        if sampler != "ddim":
            raise ValueError("guess mode supports only the ddim sampler")
        cldm = dataclasses.replace(cldm, control_scales=guess_mode_scales(
            strength, num=len(cldm.control_scales)))

        def fn(x, t, cond):
            e_c = cldm.apply_model(x, t, cond)
            e_uc = cldm.apply_model(x, t, {"c_crossattn": uncond_ctx})
            return e_uc + cfg_scale * (e_c - e_uc)

        return ddim_sample(
            fn, shape, DDIMSchedule.create(cldm.schedule, num_steps, eta=eta),
            cond={"c_crossattn": cond_ctx, "c_hint_emb": hint_emb},
            uncond=None, cfg_scale=1.0, x_T=x_T, generator=generator,
            slot_seeds=slot_seeds, device=_device(cldm))
    if strength != 1.0:
        cldm = dataclasses.replace(
            cldm, control_scales=(strength,) * len(cldm.control_scales))
    return _sample_factor_latents(
        cldm, shape, {"c_crossattn": cond_ctx, "c_hint_emb": hint_emb},
        {"c_crossattn": uncond_ctx, "c_hint_emb": hint_emb}, num_steps,
        cfg_scale, eta, x_T, generator, slot_seeds, sampler)


@torch.inference_mode()
def fgdm_chain_n(factors: Sequence[LatentDiffusion],
                 cldm: Optional[ControlLDM], factor_ctxs, empty_ctx,
                 cn_prompt_ctx=None, cn_neg_ctx=None,
                 cond_hw: Tuple[int, int] = (256, 256),
                 image_hw: Tuple[int, int] = (512, 512),
                 factor_steps: int = 50, factor_scale: float = 7.5,
                 f2_steps: int = 20, f2_scale: float = 9.0,
                 all_pconds: bool = False, generator=None,
                 slot_seeds: Optional[Sequence[int]] = None,
                 factor_sampler: str = "ddim", f2_sampler: str = "ddim"
                 ) -> Dict[str, object]:
    """The N-factor chain (text -> seg -> depth -> normal -> ... -> image).

    Factor k > 0 is adapter-prompted by factor k - 1's latent (``pcond``,
    in both CFG branches); with ``all_pconds`` factor k > 1 also gets every
    earlier latent as ``extra_pconds`` (the extra adapters of a
    ``num_prompts > 1`` UNet).  Each condition is decoded once; with
    ``cldm`` the ControlNet stage renders the last one.  Noise comes from
    ``slot_seeds`` (factor k's per-slot seeds are ``factor_slot_seeds(
    slot_seeds, k + 1)``, the render's ``len(factors) + 1``; a slot's
    result does not depend on its batch) or else from ``generator``, drawn
    factor by factor.  So ``fgdm_chain_n([ld], cldm, ...)`` is
    ``fgdm_chain(ld, cldm, ...)``.

    Returns ``conditions`` (one [0, 1] map per factor, at cond_hw),
    ``hint`` (the last map as the ControlNet reads it) and ``image``
    ([-1, 1] at image_hw); both None without ``cldm``."""
    if len(factors) != len(factor_ctxs):
        raise ValueError("one prompt context per factor")
    if slot_seeds is None and generator is None:
        raise ValueError("fgdm_chain_n needs slot_seeds or a generator")

    def seeds(factor):
        return (None if slot_seeds is None
                else factor_slot_seeds(slot_seeds, factor))

    latent_hw = (cond_hw[0] // 8, cond_hw[1] // 8)
    zs = []
    for k, (ld_k, ctx_k) in enumerate(zip(factors, factor_ctxs)):
        cond = {"c_crossattn": ctx_k}
        uncond = {"c_crossattn": empty_ctx}
        if k > 0:
            cond["pcond"] = uncond["pcond"] = zs[-1]
            if all_pconds and k > 1:
                cond["extra_pconds"] = uncond["extra_pconds"] = zs[:-1]
        shape = (ctx_k.shape[0], ld_k.unet.in_channels) + latent_hw
        with span("chain.condition", factor=k):
            zs.append(_sample_factor_latents(
                ld_k, shape, cond, uncond, factor_steps, factor_scale, 0.0,
                None, generator, seeds(k + 1), factor_sampler))
    conditions = [((ld_k.decode_first_stage(z) + 1.0) / 2.0).clamp(0.0, 1.0)
                  for ld_k, z in zip(factors, zs)]
    hint = image = None
    if cldm is not None:
        hint = condition_to_hint(conditions[-1], image_hw)
        with span("chain.image"):
            z_img = sample_image_factor(
                cldm, hint, cn_prompt_ctx, cn_neg_ctx, num_steps=f2_steps,
                cfg_scale=f2_scale, generator=generator,
                slot_seeds=seeds(len(factors) + 1), sampler=f2_sampler)
        image = cldm.decode_first_stage(z_img)
    return {"conditions": conditions, "hint": hint, "image": image}


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
    out = fgdm_chain_n([ld], cldm, [prompt_ctx], empty_ctx,
                       cn_prompt_ctx=cn_prompt_ctx, cn_neg_ctx=cn_neg_ctx,
                       cond_hw=cond_hw, image_hw=image_hw,
                       factor_steps=f1_steps, factor_scale=f1_scale,
                       f2_steps=f2_steps, f2_scale=f2_scale,
                       generator=generator, slot_seeds=slot_seeds,
                       factor_sampler=f1_sampler, f2_sampler=f2_sampler)
    return {"condition": out["conditions"][0], "hint": out["hint"],
            "image": out["image"]}
