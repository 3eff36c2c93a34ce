"""The training and validation steps on one device.

Counterpart of ``fgdm_tpu/train/train_step.py:49-188`` without a mesh:
``train_step(state, batch, generator)`` encodes the batch image with the
frozen VAE (a posterior sample) and runs the frozen CLIP, both under
``torch.no_grad()`` (never ``inference_mode``: its tensors cannot be saved
for the backward), then ``diffusion_loss``, the backward, the optimizer
step and the EMA.  It returns ``(state, metrics)`` with the loss dict and
``grad_norm``, the global norm of the raw gradients.  ``distill=True``
builds the distillation step (``loss_distill`` in the metrics; the
trainer takes it every ``distill_every_n_step`` steps).

torch cannot reproduce ``jax.random``'s bits: the timesteps ``t``, the
``noise`` and the posterior's ``posterior_eps`` may be injected; whatever is
not injected is drawn from ``generator``.  The annotator synthesis of the
``condition`` targets (ROADMAP Queue A item 14) is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion
from fgdm_tpu_torch.diffusion.losses import diffusion_loss
from fgdm_tpu_torch.train.state import TrainState, global_norm

__all__ = ["make_train_step", "make_eval_step"]

Batch = Dict[str, torch.Tensor]


def _not_ported(condition) -> None:
    if condition is not None:
        raise NotImplementedError(
            "condition-target synthesis is not ported yet (ROADMAP Queue A "
            "item 14)")


def _loss(ld: LatentDiffusion, batch: Batch, generator, t, noise,
          posterior_eps, encode_first_stage: bool, **loss_kw):
    with torch.no_grad():
        if encode_first_stage and "latent" not in batch:
            x_start = ld.encode_first_stage(batch["image"], eps=posterior_eps,
                                            generator=generator)
        else:
            x_start = batch["latent"]
        ctx = ld.get_learned_conditioning(batch["input_ids"])
    return diffusion_loss(ld, x_start, {"c_crossattn": ctx},
                          generator=generator, t=t, noise=noise, **loss_kw)


def make_train_step(ld: LatentDiffusion, distill: bool = False,
                    parameterization: str = "eps",
                    l_simple_weight: float = 1.0,
                    original_elbo_weight: float = 0.0,
                    distill_weight: float = 0.1,
                    encode_first_stage: bool = True, condition=None):
    """Builds ``train_step(state, batch, generator, *, t=None, noise=None,
    posterior_eps=None) -> (state, metrics)``.

    ``batch``: ``{"image": [B, 3, H, W] in [-1, 1]`` (or ``"latent"``),
    ``"input_ids": [B, 77]}`` on the model's device.  ``state.model`` must be
    ``ld.unet``."""
    _not_ported(condition)

    def train_step(state: TrainState, batch: Batch,
                   generator: torch.Generator, *,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   posterior_eps: Optional[torch.Tensor] = None):
        loss, loss_dict = _loss(
            ld, batch, generator, t, noise, posterior_eps,
            encode_first_stage, parameterization=parameterization,
            l_simple_weight=l_simple_weight,
            original_elbo_weight=original_elbo_weight, distill=distill,
            distill_weight=distill_weight)
        loss.backward()
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["grad_norm"] = global_norm(
            p.grad for p in state.params.values() if p.grad is not None)
        return state.apply_gradients(), metrics

    return train_step


def make_eval_step(ld: LatentDiffusion, parameterization: str = "eps",
                   condition=None):
    """Validation loss with the trained and the EMA weights (reference
    ``validation_step``, ``ddpm.py:442-450``): ``eval_step(state, batch,
    generator) -> {"val/<key>", "val/<key>_ema"}``.  Both passes draw the
    same t, noise and posterior sample, as the JAX step reuses its key."""
    _not_ported(condition)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch,
                  generator: torch.Generator, *, t=None, noise=None,
                  posterior_eps=None):
        metrics = {}
        rng_state = generator.get_state()
        passes = [("", None)]
        if state.ema is not None:
            passes.append(("_ema", state.ema.shadow))
        for tag, swap in passes:
            saved = None
            if swap is not None:
                saved = {k: p.detach().clone()
                         for k, p in state.params.items()}
                for k, p in state.params.items():
                    p.copy_(swap[k])
            generator.set_state(rng_state)
            try:
                _, loss_dict = _loss(ld, batch, generator, t, noise,
                                     posterior_eps, True,
                                     parameterization=parameterization)
            finally:
                if saved is not None:
                    for k, p in state.params.items():
                        p.copy_(saved[k])
            for k, v in loss_dict.items():
                metrics[f"val/{k}{tag}"] = v
        return metrics

    return eval_step
