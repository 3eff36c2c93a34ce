"""Prompt-to-prompt editing sampler: DDIM with attention editing.

Counterpart of ``fgdm_tpu/sampling/ptp_sampler.py:23-66`` (the reference
drives ``utils/ptp_utils.py``'s controllers through a diffusers-style loop).
P prompts, the base first; one x_T seeds every prompt, so the edits are
comparable.  CFG runs as one batch of 2P, [uncond, cond]; the controller's
editor touches only the conditional half.  The JAX ``lax.scan`` becomes a
Python loop; ``LocalBlend`` runs after each step on the 16^2 cross maps
the editor stored.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fgdm_tpu_torch.core.schedules import DDIMSchedule
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion
from fgdm_tpu_torch.sampling.ddim import ddim_step
from fgdm_tpu_torch.utils.ptp import EditController, LocalBlend

__all__ = ["ptp_sample"]


@torch.inference_mode()
def ptp_sample(ld: LatentDiffusion, controller: EditController,
               cond_ctx: torch.Tensor, uncond_ctx: torch.Tensor,
               latent_hw: Tuple[int, int] = (64, 64), num_steps: int = 50,
               cfg_scale: float = 7.5, eta: float = 0.0,
               local_blend: Optional[LocalBlend] = None,
               x_T: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The P edited latents ``[P, 4, *latent_hw]`` for contexts ``[P, 77,
    D]``.  x_T: ``x_T`` if given, else one draw ``[1, 4, *latent_hw]`` from
    ``generator`` broadcast to all P.  The UNet runs on its own device with
    no ``pcond``, so the adapter prompts itself from the noisy latent.  As in
    JAX, ``eta`` enters the schedule's sigmas and no step noise is drawn."""
    device = next(ld.unet.parameters()).device
    sched = DDIMSchedule.create(ld.schedule, num_steps, eta=eta).to(device)
    P = cond_ctx.shape[0]
    shape = (P, ld.unet.in_channels) + tuple(latent_hw)
    if x_T is not None:
        x = x_T.to(device=device, dtype=torch.float32)
    elif generator is not None:
        x = torch.randn((1,) + shape[1:], generator=generator,
                        device=device).expand(shape)
    else:
        raise ValueError("ptp_sample needs x_T or a generator")
    ctl = controller.to(device)
    blend = local_blend.to(device) if local_blend is not None else None
    ctx_in = torch.cat([uncond_ctx, cond_ctx]).to(device)
    for i in range(sched.num_steps):
        index = sched.num_steps - 1 - i
        t = sched.timesteps[index].expand(2 * P)
        ctl.store = [] if blend is not None else None
        eps = ld.unet(torch.cat([x, x]), t, context=ctx_in,
                      attn_editor=ctl.editor(i))
        e_uc, e_c = eps.chunk(2, dim=0)
        x, _ = ddim_step(x, e_uc + cfg_scale * (e_c - e_uc), index, sched)
        if blend is not None and ctl.store:
            x = blend(x, ctl.store)
        ctl.store = None
    return x
