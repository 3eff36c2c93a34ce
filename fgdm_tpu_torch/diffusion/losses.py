"""Training objective: the weighted simple loss and the VLB term.

Counterpart of ``fgdm_tpu/diffusion/losses.py:102-189 diffusion_loss``
(reference ``ddpm.py:1186-1258 p_losses``) for the eps, x0 and v
parameterizations.  torch cannot reproduce ``jax.random``'s bits, so the
timesteps ``t`` and the ``noise`` may be injected (as the chain injects
``x_T``); otherwise they are drawn from ``generator``.  The attention
distillation term is not ported (ROADMAP Queue A item 13).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from fgdm_tpu_torch.diffusion.latent_diffusion import Cond, LatentDiffusion

__all__ = ["diffusion_loss"]


def diffusion_loss(
    ld: LatentDiffusion,
    x_start: torch.Tensor,
    cond: Cond,
    parameterization: str = "eps",
    l_simple_weight: float = 1.0,
    original_elbo_weight: float = 0.0,
    distill: bool = False,
    generator: Optional[torch.Generator] = None,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One loss evaluation on the latent batch ``x_start [B, 4, h, w]``:
    ``(loss, {"loss_simple", "loss_vlb", "loss"})``, float32 scalars."""
    if distill:
        raise NotImplementedError(
            "attention distillation is not ported yet (ROADMAP Queue A item "
            "13: distill, with attention capture and the 2x teacher)")
    b, dev = x_start.shape[0], x_start.device
    if t is None:
        t = torch.randint(0, ld.schedule.num_timesteps, (b,),
                          generator=generator, device=dev)
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=dev)
    noise = noise.float()
    x_noisy = ld.q_sample(x_start, t, noise)

    if parameterization == "eps":
        target = noise
    elif parameterization == "x0":
        target = x_start.float()
    elif parameterization == "v":
        target = ld.schedule.get_v(x_start.float(), noise, t)
    else:
        raise NotImplementedError(parameterization)

    model_output = ld.apply_model(x_noisy, t, cond)
    loss_simple = ((model_output.float() - target) ** 2).mean(dim=(1, 2, 3))
    loss_dict = {"loss_simple": loss_simple.mean()}
    loss = l_simple_weight * loss_simple.mean()
    lvlb = ld.schedule.lvlb_weights.to(dev)[t]
    loss_dict["loss_vlb"] = (lvlb * loss_simple).mean()
    loss = loss + original_elbo_weight * loss_dict["loss_vlb"]
    loss_dict["loss"] = loss
    return loss, loss_dict
