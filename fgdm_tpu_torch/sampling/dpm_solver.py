"""DPM-Solver++(2M) sampling with classifier-free guidance.

Counterpart of ``fgdm_tpu/sampling/dpm_solver.py`` (``NoiseScheduleVP``
``:30``, ``dpm_solver_sample`` ``:67``) in the configuration the reference
uses (``dpm_solver/sampler.py:67-81``): the discrete VP schedule over the
model's ``alphas_cumprod``, data prediction, multistep order 2,
time-uniform grid (``t_start``/``t_end``, by default 1 to 1/N), first order on the last step (``lower_order_final``).

* log alpha is tabulated in float64 on the host over ``t_i = (i + 1) / N``
  (the concrete branch, ``dpm_solver.py:40-45``) and stored in float32; it
  is interpolated linearly in float32, as ``jnp.interp``.
* The model gets non-integer timesteps ``(t - 1/N) * 1000`` in float32.
* The grid's scalars (lambda, alpha, sigma) are float32 tables on the host;
  each step's coefficients are float32 values applied to the latents on the
  device, so the loop never waits for the device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from fgdm_tpu_torch.core.schedules import DiffusionSchedule
from fgdm_tpu_torch.sampling.ddim import DenoiseFn, cfg_eps, initial_noise
from fgdm_tpu_torch.utils.profiling import span

__all__ = ["NoiseScheduleVP", "dpm_solver_sample"]


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """``jnp.interp`` (increasing ``xp``, clamped outside) in x's dtype."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    f = torch.where(dx == 0, fp[i],
                    fp[i - 1] + ((x - xp[i - 1]) / torch.where(
                        dx == 0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class NoiseScheduleVP:
    """Discrete VP schedule with continuous-time interpolation; float32
    CPU tensors in, float32 CPU tensors out."""

    def __init__(self, alphas_cumprod):
        acp = np.asarray(torch.as_tensor(alphas_cumprod).cpu(), np.float64)
        self.total_N = int(acp.shape[0])
        self.log_alpha_array = torch.as_tensor(0.5 * np.log(acp),
                                               dtype=torch.float32)
        self.t_array = torch.linspace(0.0, 1.0, self.total_N + 1,
                                      dtype=torch.float32)[1:]

    def marginal_log_mean_coeff(self, t):
        return _interp(t, self.t_array, self.log_alpha_array)

    def marginal_alpha(self, t):
        return torch.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        log_a = self.marginal_log_mean_coeff(t)
        return torch.sqrt(1.0 - torch.exp(2.0 * log_a))

    def marginal_lambda(self, t):
        log_a = self.marginal_log_mean_coeff(t)
        return log_a - 0.5 * torch.log(1.0 - torch.exp(2.0 * log_a))

    def model_input_time(self, t):
        return (t - 1.0 / self.total_N) * 1000.0


@torch.inference_mode()
def dpm_solver_sample(denoise_fn: DenoiseFn, shape: Tuple[int, ...],
                      schedule: DiffusionSchedule, cond: Dict[str, Any],
                      uncond: Optional[Dict[str, Any]] = None,
                      cfg_scale: float = 7.5, steps: int = 20,
                      x_T: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      slot_seeds: Optional[Sequence[int]] = None,
                      device=None, t_start: float = 1.0,
                      t_end: Optional[float] = None) -> torch.Tensor:
    """DPM-Solver++(2M) with ``steps`` model evaluations over the
    time-uniform grid from ``t_start`` to ``t_end`` (default 1/N, as
    JAX's ``dpm_solver.py:94``); returns x_0 (float32, ``shape``).
    Noise: ``ddim.initial_noise``."""
    ns = NoiseScheduleVP(schedule.alphas_cumprod)
    x, device = initial_noise(shape, x_T, generator, slot_seeds, device)
    b = shape[0]
    if t_end is None:
        t_end = 1.0 / ns.total_N
    ts = torch.linspace(t_start, t_end, steps + 1, dtype=torch.float32)
    lambdas = ns.marginal_lambda(ts)
    alphas = ns.marginal_alpha(ts)
    sigmas = ns.marginal_std(ts)
    t_in = ns.model_input_time(ts)

    def x0_pred(x, i):
        t = torch.full((b,), float(t_in[i]), dtype=torch.float32,
                       device=device)
        eps = cfg_eps(denoise_fn, x, t, cond, uncond, cfg_scale)
        return (x - float(sigmas[i]) * eps) / float(alphas[i])

    # step 0: first-order update from ts[0] to ts[1]
    with span("sampler.step"):
        m_prev = x0_pred(x, 0)
        h0 = lambdas[1] - lambdas[0]
        x = (float(sigmas[1] / sigmas[0]) * x
             - float(alphas[1] * torch.expm1(-h0)) * m_prev)
    for i in range(1, steps):
        with span("sampler.step"):
            m_cur = x0_pred(x, i)
            h_0 = lambdas[i] - lambdas[i - 1]
            h = lambdas[i + 1] - lambdas[i]
            phi = torch.expm1(-h)
            x_new = (float(sigmas[i + 1] / sigmas[i]) * x
                     - float(alphas[i + 1] * phi) * m_cur)
            if i < steps - 1:   # lower_order_final: first order at the end
                d1 = (m_cur - m_prev) / float(h_0 / h)
                x_new = x_new - float(0.5 * alphas[i + 1] * phi) * d1
            x, m_prev = x_new, m_cur
    return x
