"""DDIM sampling with classifier-free guidance.

Counterpart of ``fgdm_tpu/sampling/ddim.py:47-207``: ``ddim_step`` is the
update of reference ``ddim.py:248-273``; ``cfg_eps`` batches the [uncond,
cond] branches into one model call; ``ddim_sample`` walks the sub-schedule
from the noisiest step, with x_T injection and eta.  The JAX ``lax.scan``
becomes a Python loop.  ``guidance_fn`` (a capture-mode ``apply_model``)
turns on the attention-alignment inner loop of ``sampling/guidance.py``
(reference ``inference_loss=True``, ``ddim.py:190-191,228-231``).

Noise comes from explicit ``torch.Generator``s.  With ``slot_seeds`` every
draw is per slot (``slot_noise``): slot b's stream depends only on its own
seed, never on the batch it runs in.  Torch cannot reproduce ``jax.random``
bits; the tests inject x_T instead.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from fgdm_tpu_torch.core.schedules import DDIMSchedule

__all__ = ["derive_seed", "slot_noise", "initial_noise", "ddim_step",
           "cfg_inputs", "cfg_eps", "ddim_sample"]

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]

# tags separating a slot's noise streams
SLOT_INIT_TAG = 0   # x_T
SLOT_STEP_TAG = 1   # per-step sigma noise (eta > 0)


def derive_seed(*parts: int) -> int:
    """A 63-bit seed determined by the integers ``parts`` alone."""
    if any(int(p) < 0 for p in parts):
        raise ValueError(f"seeds must be non-negative, got {parts}")
    state = np.random.SeedSequence([int(p) for p in parts]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31 | int(state[1])) & ((1 << 63) - 1)


def slot_noise(slot_seeds: Sequence[int], shape: Tuple[int, ...], tag: int,
               device, step: Optional[int] = None) -> torch.Tensor:
    """Per-slot standard normal ``[len(slot_seeds), *shape[1:]]``: slot b
    is drawn from its own generator seeded by (seed_b, tag[, step])."""
    parts = (tag,) if step is None else (tag, step)
    draws = []
    for s in slot_seeds:
        g = torch.Generator(device=device).manual_seed(derive_seed(s, *parts))
        draws.append(torch.randn(tuple(shape[1:]), generator=g, device=device))
    return torch.stack(draws)


def initial_noise(shape: Tuple[int, ...], x_T: Optional[torch.Tensor],
                  generator: Optional[torch.Generator],
                  slot_seeds: Optional[Sequence[int]], device):
    """``(x_T, device)`` for a sampler: ``x_T`` if given, else per-slot
    streams from ``slot_seeds`` (tag ``SLOT_INIT_TAG``), else ``generator``.
    ``device`` defaults to x_T's, else ``generator``'s."""
    if device is None:
        if x_T is None and generator is None:
            raise ValueError("a sampler needs device= with slot_seeds")
        device = x_T.device if x_T is not None else generator.device
    if slot_seeds is not None and len(slot_seeds) != shape[0]:
        raise ValueError(f"{len(slot_seeds)} slot seeds for batch {shape[0]}")
    if x_T is not None:
        x = x_T.to(device=device, dtype=torch.float32)
    elif slot_seeds is not None:
        x = slot_noise(slot_seeds, shape, SLOT_INIT_TAG, device)
    else:
        x = torch.randn(shape, generator=generator, device=device)
    return x, device


def ddim_step(x, e_t, index: int, sched: DDIMSchedule,
              noise: Optional[torch.Tensor] = None):
    """One DDIM update from the model's eps; returns (x_prev, pred_x0)."""
    a_t = sched.alphas[index]
    a_prev = sched.alphas_prev[index]
    sigma_t = sched.sigmas[index]
    pred_x0 = (x - sched.sqrt_one_minus_alphas[index] * e_t) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(1.0 - a_prev - sigma_t ** 2) * e_t
    x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt
    if noise is not None:
        x_prev = x_prev + sigma_t * noise
    return x_prev, pred_x0


def _cat(u, c):
    """[u, c] along the batch, leaf by leaf through lists and tuples (the
    ``extra_pconds`` of the N-factor chain), as ``jax.tree.map`` does."""
    if u is None and c is None:
        return None
    if isinstance(c, (list, tuple)):
        if not isinstance(u, (list, tuple)) or len(u) != len(c):
            raise ValueError("cond and uncond lists differ in length")
        return type(c)(_cat(a, b) for a, b in zip(u, c))
    return torch.cat([u, c], dim=0)


def cfg_inputs(x, t, cond: Dict[str, Any], uncond: Dict[str, Any]):
    """The doubled model input ``(x_in, t_in, c_in)`` of CFG, [uncond,
    cond] along the batch."""
    if set(uncond) != set(cond):
        raise ValueError(f"cond keys {sorted(cond)} != uncond {sorted(uncond)}")
    c_in = {k: _cat(uncond[k], cond[k]) for k in cond}
    return torch.cat([x, x]), torch.cat([t, t]), c_in


def cfg_eps(denoise_fn: DenoiseFn, x, t, cond: Dict[str, Any],
            uncond: Optional[Dict[str, Any]], scale: float):
    """Classifier-free guidance with one batched forward, [uncond, cond]."""
    if uncond is None or scale == 1.0:
        return denoise_fn(x, t, cond)
    e_uc, e_c = denoise_fn(*cfg_inputs(x, t, cond, uncond)).chunk(2, dim=0)
    return e_uc + scale * (e_c - e_uc)


def ddim_sample(denoise_fn: DenoiseFn, shape: Tuple[int, ...],
                sched: DDIMSchedule, cond: Dict[str, Any],
                uncond: Optional[Dict[str, Any]] = None,
                cfg_scale: float = 7.5, x_T: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                slot_seeds: Optional[Sequence[int]] = None,
                device=None,
                guidance_fn: Optional[Callable] = None) -> torch.Tensor:
    """Full DDIM loop; returns x_0 (float32, ``shape``).

    Noise: see ``initial_noise``; with eta > 0 the step noise comes from the
    same source (per slot, or ``generator``).  ``guidance_fn`` ``(x, t,
    cond) -> (eps, selfattn, crossattn)`` replaces ``denoise_fn`` with the
    guided CFG of ``guidance.guided_cfg_eps`` at sampling step ``i`` (0 at
    the noisiest step); the loop then runs under ``torch.no_grad()``, since
    the guidance differentiates through the UNet, else under
    ``torch.inference_mode()``."""
    mode = torch.inference_mode()
    if guidance_fn is not None:
        from fgdm_tpu_torch.sampling.guidance import guided_cfg_eps

        mode = torch.no_grad()
    with mode:
        x, device = initial_noise(shape, x_T, generator, slot_seeds, device)
        sched = sched.to(device)
        per_slot = slot_seeds is not None
        steps = sched.num_steps
        for i in range(steps):
            index = steps - 1 - i
            t = sched.timesteps[index].expand(shape[0])
            if guidance_fn is not None:
                e_t = guided_cfg_eps(guidance_fn, x, t, cond, uncond,
                                     cfg_scale, i)
            else:
                e_t = cfg_eps(denoise_fn, x, t, cond, uncond, cfg_scale)
            noise = None
            if sched.eta != 0.0:
                noise = (slot_noise(slot_seeds, shape, SLOT_STEP_TAG, device,
                                    i)
                         if per_slot else
                         torch.randn(shape, generator=generator,
                                     device=device))
            x, _ = ddim_step(x, e_t, index, sched, noise)
    return x
