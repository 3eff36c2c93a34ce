"""PLMS (pseudo-linear multistep) sampling with classifier-free guidance.

Counterpart of ``fgdm_tpu/sampling/plms.py:22 plms_sample`` (reference
``ldm/models/diffusion/plms.py``): order-4 Adams-Bashforth over the eps
history with the reference's warm start.  Step 0 takes a midpoint
correction (one more model call at t_next), steps 1 and 2 the second- and
third-order formulas, later steps the fourth-order one.  JAX's
``lax.switch`` over ``min(i, 3)`` is a Python ``if`` here, and its fixed
``[3, ...]`` history buffer a list of at most 3 tensors, newest first.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from fgdm_tpu_torch.core.schedules import DDIMSchedule
from fgdm_tpu_torch.sampling.ddim import (DenoiseFn, cfg_eps, ddim_step,
                                          initial_noise)
from fgdm_tpu_torch.utils.profiling import span

__all__ = ["plms_sample"]


@torch.inference_mode()
def plms_sample(denoise_fn: DenoiseFn, shape: Tuple[int, ...],
                sched: DDIMSchedule, cond: Dict[str, Any],
                uncond: Optional[Dict[str, Any]] = None,
                cfg_scale: float = 7.5, x_T: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                slot_seeds: Optional[Sequence[int]] = None,
                device=None) -> torch.Tensor:
    """PLMS over the DDIM sub-schedule ``sched`` (eta must be 0); returns
    x_0 (float32, ``shape``).  Noise: ``ddim.initial_noise``."""
    if sched.eta != 0.0:
        raise ValueError(f"plms requires eta=0 (got {sched.eta})")
    x, device = initial_noise(shape, x_T, generator, slot_seeds, device)
    sched = sched.to(device)
    steps, b = sched.num_steps, shape[0]

    def model(x, index):
        t = sched.timesteps[index].expand(b)
        return cfg_eps(denoise_fn, x, t, cond, uncond, cfg_scale)

    hist = []
    for i in range(steps):
        with span("sampler.step"):
            index = steps - 1 - i
            e_t = model(x, index)
            if i == 0:
                x_next, _ = ddim_step(x, e_t, index, sched)
                e_prime = (e_t + model(x_next, max(index - 1, 0))) / 2.0
            elif i == 1:
                e_prime = (3.0 * e_t - hist[0]) / 2.0
            elif i == 2:
                e_prime = (23.0 * e_t - 16.0 * hist[0]
                           + 5.0 * hist[1]) / 12.0
            else:
                e_prime = (55.0 * e_t - 59.0 * hist[0] + 37.0 * hist[1]
                           - 9.0 * hist[2]) / 24.0
            x, _ = ddim_step(x, e_prime, index, sched)
            hist = [e_t] + hist[:2]
    return x
