"""Training objective: the weighted simple loss, the VLB term and the
attention distillation term.

Counterpart of ``fgdm_tpu/diffusion/losses.py:26-189`` (reference
``ddpm.py:1186-1258 p_losses``) for the eps, x0 and v parameterizations.
torch cannot reproduce ``jax.random``'s bits, so the timesteps ``t`` and the
``noise`` may be injected (as the chain injects ``x_T``); otherwise they are
drawn from ``generator``.

On a distillation step the loss adds ``distill_weight x KL(teacher ||
student)`` over aggregated attention maps (``ddpm.py:1250-1254,1799-1818``):
the student's maps come from a capture forward on the first ``tb`` rows of
the batch, the teacher's from the same UNet with the adapter off on the
2x-upsampled latent, under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from fgdm_tpu_torch.diffusion.latent_diffusion import Cond, LatentDiffusion
from fgdm_tpu_torch.nn.attention import CaptureSpec
from fgdm_tpu_torch.nn.layers import nearest_upsample_2x
from fgdm_tpu_torch.utils.attention_maps import (_resize_query_grid,
                                                 get_token_maps,
                                                 kl_distill_loss)

__all__ = ["nearest_upsample_2x_latent", "teacher_attention_maps",
           "diffusion_loss"]


# [B, C, h, w] -> [B, C, 2h, 2w], each value repeated 2 x 2
nearest_upsample_2x_latent = nearest_upsample_2x


def _pool_cross_2x(m: torch.Tensor) -> torch.Tensor:
    """``[B, r, r, K]`` -> ``[B, r/2, r/2, K]`` average pool (the
    reference's ``downsample2``, ``ddpm.py:131,1814``)."""
    b, r, _, k = m.shape
    return m.reshape(b, r // 2, 2, r // 2, 2, k).mean(dim=(2, 4))


def _rows(cond: Cond, rows: slice) -> Cond:
    return {k: v if v is None else v[rows] for k, v in cond.items()}


@torch.no_grad()
def teacher_attention_maps(ld: LatentDiffusion, x_start: torch.Tensor,
                           noise: torch.Tensor, t: torch.Tensor, cond: Cond
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frozen-SD teacher's maps ``(self [B, r^2, r^2], cross [B, r, r,
    K])`` at the latent's resolution r: the adapter-off forward on the
    2x-upsampled noisy latent, its maps aggregated at 2r and pooled back to
    r (reference ``get_attnmaps``, ``ddpm.py:1799-1818``).  Only the (2r)^2
    self layers emit maps, pooled 4x on both token axes inside the capture
    einsum, so the raw ``[B, (2r)^2, (2r)^2]`` maps never exist."""
    resn = x_start.shape[2]
    r2 = 2 * resn
    x2 = ld.q_sample(nearest_upsample_2x_latent(x_start), t,
                     nearest_upsample_2x_latent(noise))
    _, t_self, t_cross = ld.apply_model(
        x2, t, cond, adapter_on=False,
        capture=CaptureSpec(self_n=r2 * r2, self_pool=4))
    if not t_self:
        raise ValueError(f"no teacher self-attention maps at {r2}")
    self_maps = sum(t_self.values()) / len(t_self)
    cross = []
    for m in t_cross.values():
        r = int(round(m.shape[1] ** 0.5))
        m = _resize_query_grid(m, r, r2).reshape(m.shape[0], r2, r2, -1)
        cross.append(_pool_cross_2x(m))
    return self_maps, sum(cross) / len(cross)


def diffusion_loss(
    ld: LatentDiffusion,
    x_start: torch.Tensor,
    cond: Cond,
    parameterization: str = "eps",
    l_simple_weight: float = 1.0,
    original_elbo_weight: float = 0.0,
    distill: bool = False,
    distill_weight: float = 0.1,
    trunc_bs: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One loss evaluation on the latent batch ``x_start [B, 4, h, w]``:
    ``(loss, {"loss_simple", "loss_vlb", "loss"})``, float32 scalars, and
    ``"loss_distill"`` with ``distill``.

    With ``distill`` the first ``tb = trunc_bs or min(max(2, B // 10), 8)``
    rows (the reference's ``trucbs``) run a capture forward and the rest a
    plain one; only those rows feed the distillation term."""
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

    if distill:
        tb = min(trunc_bs or min(max(2, b // 10), 8), b)
        resn = x_start.shape[2]
        head = slice(0, tb)
        out_tb, selfattn, crossattn = ld.apply_model(
            x_noisy[head], t[head], _rows(cond, head),
            capture=CaptureSpec(self_n=resn * resn))
        if tb < b:
            rest = slice(tb, b)
            model_output = torch.cat([out_tb, ld.apply_model(
                x_noisy[rest], t[rest], _rows(cond, rest))])
        else:
            model_output = out_tb
    else:
        model_output = ld.apply_model(x_noisy, t, cond)
    loss_simple = ((model_output.float() - target) ** 2).mean(dim=(1, 2, 3))
    loss_dict = {"loss_simple": loss_simple.mean()}
    loss = l_simple_weight * loss_simple.mean()
    lvlb = ld.schedule.lvlb_weights.to(dev)[t]
    loss_dict["loss_vlb"] = (lvlb * loss_simple).mean()
    loss = loss + original_elbo_weight * loss_dict["loss_vlb"]
    if distill:
        s_self, s_cross = get_token_maps(selfattn, crossattn, resn=resn)
        t_self, t_cross = teacher_attention_maps(
            ld, x_start[head], noise[head], t[head], _rows(cond, head))
        loss_dict["loss_distill"] = kl_distill_loss(t_self, t_cross, s_self,
                                                    s_cross)
        loss = loss + distill_weight * loss_dict["loss_distill"]
    loss_dict["loss"] = loss
    return loss, loss_dict
