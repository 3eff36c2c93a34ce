"""Learning-rate multiplier schedules and the reference's LR scaling rule.

Counterpart of ``fgdm_tpu/train/lr_schedules.py:19-80`` (reference
``ldm/lr_scheduler.py``): ``lambda_linear`` (``LambdaLinearScheduler``:
linear warmup f_start -> f_max, then linear decay toward f_min over the
cycle), ``lambda_warmup_cosine`` (``LambdaWarmUpCosineScheduler2``) and
``scaled_lr`` (``main.py:712-732``).  The schedules map an update count to a
Python float, computed in float32 as the JAX versions are.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["lambda_linear", "lambda_warmup_cosine", "scaled_lr"]


def lambda_linear(warm_up_steps: int = 10_000, f_start: float = 1e-5,
                  f_max: float = 1.0, f_min: float = 1.0,
                  cycle_length: float = 1e13):
    warm_up_steps = np.float32(warm_up_steps)
    f_start, f_max, f_min = (np.float32(f) for f in (f_start, f_max, f_min))
    cycle_length = np.float32(cycle_length)

    def schedule(step) -> float:
        step = np.float32(step)
        if step < warm_up_steps:
            return float(f_start + (f_max - f_start) / warm_up_steps * step)
        return float(f_min + (f_max - f_min) * (cycle_length - step)
                     / cycle_length)

    return schedule


def lambda_warmup_cosine(warm_up_steps: int, f_start: float, f_max: float,
                         f_min: float, cycle_length: float):
    warm_up_steps = np.float32(warm_up_steps)
    f_start, f_max, f_min = (np.float32(f) for f in (f_start, f_max, f_min))
    cycle_length = np.float32(cycle_length)

    def schedule(step) -> float:
        step = np.float32(step)
        if step < warm_up_steps:
            return float(f_start + (f_max - f_start) / warm_up_steps * step)
        t = np.clip((step - warm_up_steps) / (cycle_length - warm_up_steps),
                    np.float32(0.0), np.float32(1.0))
        return float(f_min + np.float32(0.5) * (f_max - f_min)
                     * (1 + np.cos(t * np.float32(math.pi))))

    return schedule


def scaled_lr(base_lr: float, batch_size: int, n_devices: int = 1,
              accumulate_grad_batches: int = 1,
              scale_lr: bool = True) -> float:
    if not scale_lr:
        return base_lr
    return accumulate_grad_batches * n_devices * batch_size * base_lr
