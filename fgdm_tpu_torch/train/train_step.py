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

With a ``condition`` (``train/condition.py``) the frozen annotator turns
the batch image into the factor's target before the encode
(``_encode_target``, JAX ``train_step.py:28-45``).

torch cannot reproduce ``jax.random``'s bits: the timesteps ``t``, the
``noise`` and the posterior's ``posterior_eps`` may be injected (for
``sketch_to_normal`` a pair, one eps for each half); whatever is not
injected is drawn from ``generator``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion
from fgdm_tpu_torch.diffusion.losses import diffusion_loss
from fgdm_tpu_torch.train.state import TrainState, global_norm

__all__ = ["make_train_step", "make_eval_step"]

Batch = Dict[str, torch.Tensor]


def _encode_target(ld: LatentDiffusion, batch: Batch, condition,
                   posterior_eps=None, generator=None) -> torch.Tensor:
    """Batch image -> x_start latent, through the condition's annotator when
    there is one (reference ``get_input``, ``ddpm.py:397-419``).
    ``sketch_to_normal``'s 6 channels are split into (normal, sketch), each
    encoded with its own posterior eps (``posterior_eps`` is then a pair),
    and the latents concatenated (``ddpm.py:765-782``)."""
    img = batch["image"]
    if condition is None:
        return ld.encode_first_stage(img, eps=posterior_eps,
                                     generator=generator)
    tgt = condition.target(img)
    if condition.kind != "sketch_to_normal":
        return ld.encode_first_stage(tgt, eps=posterior_eps,
                                     generator=generator)
    eps = (None, None) if posterior_eps is None else posterior_eps
    return torch.cat([ld.encode_first_stage(half, eps=e, generator=generator)
                      for half, e in zip((tgt[:, :3], tgt[:, 3:]), eps)],
                     dim=1)


def _loss(ld: LatentDiffusion, batch: Batch, generator, t, noise,
          posterior_eps, encode_first_stage: bool, condition=None,
          **loss_kw):
    with torch.no_grad():
        if encode_first_stage and "latent" not in batch:
            x_start = _encode_target(ld, batch, condition, posterior_eps,
                                     generator)
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
    ``ld.unet``.  ``condition`` synthesizes the factor's target from
    ``batch["image"]`` (the depth, normal and sketch configs)."""

    def train_step(state: TrainState, batch: Batch,
                   generator: torch.Generator, *,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   posterior_eps: Optional[torch.Tensor] = None):
        loss, loss_dict = _loss(
            ld, batch, generator, t, noise, posterior_eps,
            encode_first_stage, condition, parameterization=parameterization,
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
                                     posterior_eps, True, condition,
                                     parameterization=parameterization)
            finally:
                if saved is not None:
                    for k, p in state.params.items():
                        p.copy_(saved[k])
            for k, v in loss_dict.items():
                metrics[f"val/{k}{tag}"] = v
        return metrics

    return eval_step
