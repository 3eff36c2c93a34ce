"""Diffusion noise schedules and DDIM sub-schedule tables.

Counterpart of ``fgdm_tpu/core/schedules.py``: every quantity is computed
once on the host in float64 numpy (the reference builds its buffers in
float64 before casting) and stored as float32 tensors.  ``to(device)`` moves
a table to where the sampler or the training step runs.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["make_beta_schedule", "make_ddim_timesteps", "DiffusionSchedule",
           "DDIMSchedule"]


def make_beta_schedule(schedule: str, n_timestep: int,
                       linear_start: float = 1e-4, linear_end: float = 2e-2,
                       cosine_s: float = 8e-3) -> np.ndarray:
    """Beta schedule, float64 (reference ``util.py:21-44``)."""
    if schedule == "linear":
        return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                           dtype=np.float64) ** 2
    if schedule == "cosine":
        ts = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(ts / (1 + cosine_s) * math.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1.0 - alphas[1:] / alphas[:-1], 0.0, 0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep,
                           dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep,
                           dtype=np.float64) ** 0.5
    raise ValueError(f"schedule '{schedule}' unknown.")


def make_ddim_timesteps(ddim_discr_method: str, num_ddim_timesteps: int,
                        num_ddpm_timesteps: int) -> np.ndarray:
    """DDIM sub-sequence of DDPM timesteps (reference ``util.py:46-60``),
    shifted by one and clamped as in the JAX package."""
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ts = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif ddim_discr_method == "quad":
        ts = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                          num_ddim_timesteps) ** 2).astype(int)
    else:
        raise NotImplementedError(
            f"unknown ddim discretization: {ddim_discr_method}")
    return np.minimum(ts + 1, num_ddpm_timesteps - 1)


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _gather(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """``table[t]`` shaped ``[B, 1, ...]`` to broadcast over an ``ndim``-d
    batch (a no-op move when the table already lives on t's device)."""
    return table.to(t.device)[t].reshape((-1,) + (1,) * (ndim - 1))


def _move(obj, device):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The DDPM buffers (reference ``ddpm.py:175-227``) that sampling and
    the training loss read, float32 ``[T]``, plus the float64
    ``alphas_cumprod`` for exact DDIM tables."""

    num_timesteps: int
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    lvlb_weights: torch.Tensor
    alphas_cumprod_f64: np.ndarray = dataclasses.field(repr=False)

    @staticmethod
    def create(timesteps: int = 1000, beta_schedule: str = "linear",
               linear_start: float = 1e-4, linear_end: float = 2e-2,
               cosine_s: float = 8e-3, v_posterior: float = 0.0,
               parameterization: str = "eps") -> "DiffusionSchedule":
        betas = make_beta_schedule(beta_schedule, timesteps,
                                   linear_start=linear_start,
                                   linear_end=linear_end, cosine_s=cosine_s)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas, axis=0)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = ((1 - v_posterior) * betas * (1.0 - acp_prev)
                    / (1.0 - acp) + v_posterior * betas)
        if parameterization == "eps":
            with np.errstate(divide="ignore", invalid="ignore"):
                lvlb = betas ** 2 / (2 * post_var * alphas * (1 - acp))
            # t=0 is 0/0; the reference pins it to t=1 (ddpm.py:225-227)
            lvlb[0] = lvlb[1]
        elif parameterization == "x0":
            # the reference's expression, operator precedence included
            lvlb = 0.5 * np.sqrt(acp) / (2.0 * 1 - acp)
        elif parameterization == "v":
            lvlb = np.ones_like(betas)
        else:
            raise ValueError(parameterization)
        return DiffusionSchedule(
            num_timesteps=int(timesteps),
            betas=_f32(betas),
            alphas_cumprod=_f32(acp),
            alphas_cumprod_prev=_f32(acp_prev),
            sqrt_alphas_cumprod=_f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=_f32(np.sqrt(1.0 - acp)),
            log_one_minus_alphas_cumprod=_f32(np.log(1.0 - acp)),
            sqrt_recip_alphas_cumprod=_f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=_f32(np.sqrt(1.0 / acp - 1)),
            posterior_variance=_f32(post_var),
            # the variance is 0 at t = 0: clipped before the log
            posterior_log_variance_clipped=_f32(
                np.log(np.maximum(post_var, 1e-20))),
            posterior_mean_coef1=_f32(betas * np.sqrt(acp_prev)
                                      / (1.0 - acp)),
            posterior_mean_coef2=_f32((1.0 - acp_prev) * np.sqrt(alphas)
                                      / (1.0 - acp)),
            lvlb_weights=_f32(lvlb),
            alphas_cumprod_f64=acp,
        )

    def to(self, device) -> "DiffusionSchedule":
        return _move(self, device)

    def q_sample(self, x_start, t, noise):
        """Forward-process sample ``a_t x_0 + s_t noise`` in float32; ``t``
        is an int tensor ``[B]``."""
        return (_gather(self.sqrt_alphas_cumprod, t, x_start.dim())
                * x_start.float()
                + _gather(self.sqrt_one_minus_alphas_cumprod, t,
                          x_start.dim()) * noise.float())

    def predict_start_from_noise(self, x_t, t, noise):
        """x_0 from the model's eps: ``x_t / a_t - sqrt(1 / a_t^2 - 1)
        noise`` with the float32 tables."""
        return (_gather(self.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t
                - _gather(self.sqrt_recipm1_alphas_cumprod, t, x_t.dim())
                * noise)

    def get_v(self, x, noise, t):
        """The v-prediction target ``a_t noise - s_t x``."""
        return (_gather(self.sqrt_alphas_cumprod, t, x.dim()) * noise
                - _gather(self.sqrt_one_minus_alphas_cumprod, t, x.dim()) * x)

    def predict_start_from_v(self, x_t, t, v):
        return (_gather(self.sqrt_alphas_cumprod, t, x_t.dim()) * x_t
                - _gather(self.sqrt_one_minus_alphas_cumprod, t, x_t.dim())
                * v)


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """DDIM sub-schedule (reference ``util.py:63-76``, ``ddim.py:26-55``).

    ``timesteps[i]`` is the DDPM t fed to the model at step i (ascending;
    the sampler walks it reversed).  Every tensor is ``[S]``."""

    num_steps: int
    eta: float
    timesteps: torch.Tensor         # int64
    alphas: torch.Tensor            # alpha_cumprod at each selected t
    alphas_prev: torch.Tensor
    sqrt_one_minus_alphas: torch.Tensor
    sigmas: torch.Tensor

    @staticmethod
    def create(schedule: DiffusionSchedule, num_steps: int, eta: float = 0.0,
               discretize: str = "uniform") -> "DDIMSchedule":
        ts = make_ddim_timesteps(discretize, num_steps, schedule.num_timesteps)
        acp = schedule.alphas_cumprod_f64
        alphas = acp[ts]
        alphas_prev = np.asarray([acp[0]] + acp[ts[:-1]].tolist())
        sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas)
                               * (1 - alphas / alphas_prev))
        return DDIMSchedule(
            num_steps=int(len(ts)),
            eta=float(eta),
            timesteps=torch.as_tensor(ts, dtype=torch.int64),
            alphas=_f32(alphas),
            alphas_prev=_f32(alphas_prev),
            sqrt_one_minus_alphas=_f32(np.sqrt(1.0 - alphas)),
            sigmas=_f32(sigmas),
        )

    def to(self, device) -> "DDIMSchedule":
        return _move(self, device)
