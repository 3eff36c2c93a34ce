"""ControlNet fine-tuning step (the seg -> image factor's trainer).

Counterpart of ``fgdm_tpu/train/control.py:30-111`` (reference
``ControlLDM.configure_optimizers``, ``cldm.py:924-931``) on one device:
AdamW over the control branch; with ``sd_locked=False`` the SD UNet's
decoder (``output_blocks``) and output head join it.  The VAE and CLIP are
outside the optimizer's tree and stay frozen.

The tree is ``control_param_tree``'s ``ModuleDict``, so the trainable names
are ``control.*`` and ``unet.*``; ``TrainState.create`` turns off
``requires_grad`` on the rest.  The frozen UNet still passes activation
gradients back to the 13 control residuals.  As in ``train/train_step.py``
the VAE encode and CLIP run under ``torch.no_grad()``, and ``t``, ``noise``
and the posterior's ``posterior_eps`` may be injected.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from fgdm_tpu_torch.diffusion.control import ControlLDM
from fgdm_tpu_torch.diffusion.losses import diffusion_loss
from fgdm_tpu_torch.train.state import TrainState, global_norm

__all__ = ["control_filter", "control_param_tree", "make_control_train_step"]

Batch = Dict[str, torch.Tensor]


def control_filter(sd_locked: bool = True) -> Callable[[str], bool]:
    """Trainable rule over ``control_param_tree``'s names
    (``cldm.py:924-931``)."""

    def f(name: str) -> bool:
        if name.startswith("control."):
            return True
        if not sd_locked:
            # the decoder and the head only: anchored at the top of the
            # tree, since every ResBlock has its own out_layers
            return (name.startswith("unet.output_blocks.")
                    or name.startswith("unet.out."))
        return False

    return f


def control_param_tree(cldm: ControlLDM) -> nn.ModuleDict:
    """The optimizer's tree for a ControlLDM: its ControlNet and UNet (the
    VAE and CLIP stay outside, as in JAX)."""
    return nn.ModuleDict({"control": cldm.control, "unet": cldm.unet})


def make_control_train_step(cldm: ControlLDM, parameterization: str = "eps",
                            l_simple_weight: float = 1.0,
                            original_elbo_weight: float = 0.0):
    """Builds ``train_step(state, batch, generator, *, t=None, noise=None,
    posterior_eps=None) -> (state, metrics)``.

    ``state`` is ``TrainState.create(control_param_tree(cldm), ...,
    trainable_filter=control_filter(...))``.  ``batch``: ``{"image": [B, 3,
    H, W]`` target RGB in [-1, 1] (or ``"latent"``), ``"hint": [B, 3, H,
    W]`` in [0, 1], ``"input_ids": [B, 77]}`` (the reference's
    ``ControlLDM.get_input``, ``cldm.py:853-866``).  The metrics are the
    loss dict and ``grad_norm``, the global norm of the raw gradients."""

    def train_step(state: TrainState, batch: Batch,
                   generator: Optional[torch.Generator], *,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   posterior_eps: Optional[torch.Tensor] = None):
        with torch.no_grad():
            if "latent" in batch:
                x_start = batch["latent"]
            else:
                x_start = cldm.encode_first_stage(
                    batch["image"], eps=posterior_eps, generator=generator)
            ctx = cldm.get_learned_conditioning(batch["input_ids"])
        cond = {"c_crossattn": ctx, "c_concat": batch["hint"]}
        loss, loss_dict = diffusion_loss(
            cldm, x_start, cond, parameterization=parameterization,
            l_simple_weight=l_simple_weight,
            original_elbo_weight=original_elbo_weight, generator=generator,
            t=t, noise=noise)
        loss.backward()
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["grad_norm"] = global_norm(
            p.grad for p in state.params.values() if p.grad is not None)
        return state.apply_gradients(), metrics

    return train_step
