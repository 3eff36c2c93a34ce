"""Joint two-factor (AdaptDiffusion) training step.

Counterpart of ``fgdm_tpu/train/joint.py:37-101`` (reference
``AdaptDiffusion.p_losses`` and ``configure_optimizers``, ``ddpm.py:
1851-1927``) on one device: the batch latent stacks two factors on its
channels (image half first, ``SeqTwoUNet``'s layout); the step noises the
image half with ``q_sample`` in float32 and regresses its eps, while the
clean condition half enters through ``SeqTwoUNet``'s ``cond_map`` bypass
(``unet2`` does not run).  With ``state`` built on
``joint_image_adapter_filter`` only ``unet1``'s adapter and the channel
mapper train.  ``t`` and ``noise`` may be injected; otherwise they are
drawn from ``generator``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from fgdm_tpu_torch.core.schedules import DiffusionSchedule
from fgdm_tpu_torch.models.seq_two_unet import SeqTwoUNet
from fgdm_tpu_torch.train.state import TrainState, global_norm

__all__ = ["make_joint_train_step"]


def make_joint_train_step(model: SeqTwoUNet, schedule: DiffusionSchedule,
                          l_simple_weight: float = 1.0,
                          original_elbo_weight: float = 0.0):
    """Builds ``step(state, batch, generator, *, t=None, noise=None) ->
    (state, metrics)``.

    ``batch``: ``{"latent": [B, 2 * factor_channels, H, W]`` joint factor
    latents, ``"context": [B, 77, D]}``.  The metrics carry JAX's keys:
    ``train/loss_simple``, ``train/loss``, ``train/loss_vlb`` (with
    ``original_elbo_weight > 0``) and ``grad_norm``."""
    fc = model.factor_channels

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator], *,
             t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None):
        lat = batch["latent"]
        x_img, x_cond = lat[:, :fc], lat[:, fc:]
        b, dev = x_img.shape[0], lat.device
        if t is None:
            t = torch.randint(0, schedule.num_timesteps, (b,),
                              generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(x_img.shape, generator=generator, device=dev)
        noise = noise.float()
        x_noisy = schedule.q_sample(x_img.float(), t, noise)
        x_in = torch.cat([x_noisy.to(lat.dtype), x_cond], dim=1)
        out = model(x_in, t, context=batch.get("context"), cond_map=x_cond)
        loss_simple = ((out[:, :fc].float() - noise) ** 2).mean(dim=(1, 2, 3))
        loss = l_simple_weight * loss_simple.mean()
        metrics = {"train/loss_simple": loss_simple.mean()}
        if original_elbo_weight > 0.0:
            lvlb = schedule.lvlb_weights.to(dev)[t]
            metrics["train/loss_vlb"] = (lvlb * loss_simple).mean()
            loss = loss + original_elbo_weight * metrics["train/loss_vlb"]
        metrics["train/loss"] = loss
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(
            p.grad for p in state.params.values() if p.grad is not None)
        return state.apply_gradients(), metrics

    return step
