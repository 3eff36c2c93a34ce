"""Control-conditioned latent diffusion (the seg -> image stage).

Counterpart of ``fgdm_tpu/diffusion/control.py:38-74``: ``apply_model`` runs
ControlNet on the hint (or on its precomputed pyramid, ``c_hint_emb``),
scales its 13 residuals by ``control_scales`` and feeds them to the frozen
SD UNet (adapter off); ``capture`` returns the UNet's attention maps too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from fgdm_tpu_torch.diffusion.latent_diffusion import Cond, LatentDiffusion
from fgdm_tpu_torch.models.controlnet import ControlNet

__all__ = ["ControlLDM"]


@dataclasses.dataclass
class ControlLDM(LatentDiffusion):
    control: Optional[ControlNet] = None
    control_scales: Tuple[float, ...] = (1.0,) * 13
    only_mid_control: bool = False

    def apply_model(self, x_noisy, t, cond: Optional[Cond],
                    adapter_on: bool = True, capture=False):
        cond = cond or {}
        context = cond.get("c_crossattn")
        hint, hint_emb = cond.get("c_concat"), cond.get("c_hint_emb")
        control = None
        if hint is not None or hint_emb is not None:
            control = self.control(x_noisy, hint, t, context,
                                   hint_emb=hint_emb)
            control = tuple(c * s for c, s in zip(control,
                                                  self.control_scales))
        return self.unet(x_noisy, t, context=context, control=control,
                         only_mid_control=self.only_mid_control,
                         adapter_on=False, capture=capture)

    def _graph_parts(self, adapter_on: bool):
        return ((self.unet, self.control),
                (tuple(self.control_scales), self.only_mid_control))

    def encode_hint(self, hint: torch.Tensor) -> torch.Tensor:
        """Hint pyramid only: ``[B, 3, H, W]`` in [0, 1] ->
        ``[B, mc, H/8, W/8]``; step-invariant, so samplers run it once."""
        return self.control(None, hint, None, None, hint_only=True)
