"""Ancestral DDPM sampling over the full schedule (``p_sample_loop``).

Counterpart of ``fgdm_tpu/sampling/ancestral.py:21-64`` (the reference's
``DDPM.p_sample_loop``, ``ddpm.py:276-360``): at each of the T steps, from
t = T - 1 down to 0, x_0 is predicted from the model's eps (clipped to
[-1, 1] with ``clip_denoised``), the posterior mean is taken from it, and
noise at the clipped posterior log-variance is added, none at t = 0.  Used
by the base DDPM models and ``log_images``' progressive rows.  The JAX
``lax.scan`` becomes a Python loop.

Torch cannot reproduce ``jax.random``: ``x_T`` and ``step_noise`` inject
the draws (the tests rebuild JAX's from its key splits); otherwise they come
from ``generator``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from fgdm_tpu_torch.core.schedules import DiffusionSchedule
from fgdm_tpu_torch.sampling.ddim import (DenoiseFn, _bshape, cfg_eps,
                                          initial_noise)

__all__ = ["p_sample_loop"]


def p_sample_loop(
        denoise_fn: DenoiseFn, shape: Tuple[int, ...],
        schedule: DiffusionSchedule, cond: Any = None, uncond: Any = None,
        cfg_scale: float = 1.0, clip_denoised: bool = True,
        x_T: Optional[torch.Tensor] = None, log_every_t: int = 0,
        generator: Optional[torch.Generator] = None,
        step_noise: Union[None, torch.Tensor, Callable[[int], torch.Tensor]]
        = None, device=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(x_0, intermediates)``; ``intermediates["x_inter"]`` stacks every
    ``log_every_t``-th x after a step (from the first), when it is set.

    ``step_noise``: the noise of loop step i (t = T - 1 - i), a ``[T,
    *shape]`` tensor or a callable of i; else drawn from ``generator``.
    The draw at t = 0 is taken and multiplied by 0, as in JAX.  ``device``
    defaults to x_T's, else ``generator``'s."""
    if step_noise is None and generator is None:
        raise ValueError("p_sample_loop needs step_noise or a generator")
    T = schedule.num_timesteps
    inter = []
    with torch.inference_mode():
        x, device = initial_noise(shape, x_T, generator, None, device)
        sched = schedule.to(device)
        for i in range(T):
            t_scalar = T - 1 - i
            t = torch.full((shape[0],), t_scalar, dtype=torch.int64,
                           device=device)
            e_t = cfg_eps(denoise_fn, x, t, cond, uncond, cfg_scale)
            x0 = sched.predict_start_from_noise(x, t, e_t)
            if clip_denoised:
                x0 = x0.clamp(-1.0, 1.0)
            mean = (_bshape(sched.posterior_mean_coef1[t], x) * x0
                    + _bshape(sched.posterior_mean_coef2[t], x) * x)
            log_var = _bshape(sched.posterior_log_variance_clipped[t], x)
            if step_noise is None:
                noise = torch.randn(shape, generator=generator, device=device)
            elif callable(step_noise):
                noise = step_noise(i)
            else:
                noise = step_noise[i]
            nonzero = float(t_scalar > 0)
            x = mean + nonzero * torch.exp(0.5 * log_var) * noise.to(device)
            if log_every_t:
                inter.append(x)
    out = {}
    if log_every_t:
        out["x_inter"] = torch.stack(inter[::log_every_t])
    return x, out
