"""The sampler arguments JAX takes that the port once lacked:
``dpm_solver_sample(t_start=, t_end=)``, ``ddim_step(temperature=)`` and
``ddim_sample(temperature=, callback=)``, held against the JAX package.

A toy eps model (a fixed elementwise function of x and a per-sample
condition, the same in both packages) stands in for the UNet, so each case
isolates the sampler.  x_T is drawn with numpy and injected; ``ddim_sample``'s
eta noise is JAX's own draws (``split(rng)``, then ``split(rng, S)``)
injected as ``step_noise``.  Tolerance: the sampled latents 2e-3 *
max|ref| (``CHAIN_TOL`` of ``tests/test_torch_samplers.py``); float32 on
both sides.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from fgdm_tpu.core import schedules as jsch  # noqa: E402
from fgdm_tpu.sampling import ddim as jddim  # noqa: E402
from fgdm_tpu.sampling import dpm_solver as jdpm  # noqa: E402
from fgdm_tpu_torch import builders  # noqa: E402
from fgdm_tpu_torch.core import schedules as tsch  # noqa: E402
from fgdm_tpu_torch.sampling import ddim as tddim  # noqa: E402
from fgdm_tpu_torch.sampling import dpm_solver as tdpm  # noqa: E402

CHAIN_TOL = 2e-3
SHAPE = (2, 8, 8, 4)          # NHWC; the port's latents are NCHW


def _jax_schedule():
    return jsch.DiffusionSchedule.create(1000, "linear",
                                         linear_start=0.00085,
                                         linear_end=0.0120)


def _jfn(x, t, cond):
    return jnp.tanh(0.3 * x) + cond["c"][:, None, None, :] \
        + 1e-4 * t[:, None, None, None]


def _tfn(x, t, cond):
    return torch.tanh(0.3 * x) + cond["c"][:, :, None, None] \
        + 1e-4 * t[:, None, None, None]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x_T = rng.standard_normal(SHAPE).astype(np.float32)
    c = (0.1 * rng.standard_normal((SHAPE[0], SHAPE[3]))).astype(np.float32)
    u = (0.1 * rng.standard_normal((SHAPE[0], SHAPE[3]))).astype(np.float32)
    return x_T, c, u


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _close(z, ref):
    ref = np.asarray(ref)
    got = np.moveaxis(z.numpy(), 1, -1)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=CHAIN_TOL * np.abs(ref).max())


@pytest.mark.parametrize("t_start,t_end", [(0.7, 0.05), (1.0, 0.2),
                                           (0.7, None)])
def test_dpm_solver_partial_range_matches_jax(t_start, t_end):
    x_T, c, u = _inputs(31)
    ref = jdpm.dpm_solver_sample(
        _jfn, None, SHAPE, _jax_schedule(), {"c": jnp.asarray(c)},
        {"c": jnp.asarray(u)}, cfg_scale=3.0, steps=6, x_T=jnp.asarray(x_T),
        t_start=t_start, t_end=t_end)
    got = tdpm.dpm_solver_sample(
        _tfn, (SHAPE[0], SHAPE[3]) + SHAPE[1:3], builders.sd14_schedule(),
        {"c": torch.from_numpy(c)}, {"c": torch.from_numpy(u)},
        cfg_scale=3.0, steps=6, x_T=nchw(x_T), t_start=t_start, t_end=t_end)
    _close(got, ref)
    full = tdpm.dpm_solver_sample(
        _tfn, (SHAPE[0], SHAPE[3]) + SHAPE[1:3], builders.sd14_schedule(),
        {"c": torch.from_numpy(c)}, {"c": torch.from_numpy(u)},
        cfg_scale=3.0, steps=6, x_T=nchw(x_T))
    assert (full - got).abs().max() > 1e-3    # the range took effect


def test_dpm_solver_grid_runs_from_t_start_to_t_end():
    calls = []

    def fn(x, t, cond):
        calls.append(float(t[0]))
        return 0.1 * x

    tdpm.dpm_solver_sample(fn, (1, 1, 2, 2), builders.sd14_schedule(), {},
                           cfg_scale=1.0, steps=4, x_T=torch.ones(1, 1, 2, 2),
                           t_start=0.7, t_end=0.05)
    ts = np.linspace(0.7, 0.05, 5, dtype=np.float32)[:4]
    np.testing.assert_allclose(calls, (ts - 1e-3) * 1000.0, rtol=1e-5)


def _jax_step_noise(key, steps):
    rng, _ = jax.random.split(key)
    return np.stack([np.asarray(jax.random.normal(k, SHAPE, jnp.float32))
                     for k in jax.random.split(rng, steps)])


@pytest.mark.parametrize("temperature", [0.5, 1.0, 0.0])
def test_ddim_sample_temperature_matches_jax(temperature):
    steps, key = 5, jax.random.PRNGKey(3)
    x_T, c, u = _inputs(32)
    jsched = jsch.DDIMSchedule.create(_jax_schedule(), steps, eta=0.5)
    ref, _ = jddim.ddim_sample(
        _jfn, key, SHAPE, jsched, {"c": jnp.asarray(c)},
        {"c": jnp.asarray(u)}, cfg_scale=3.0, x_T=jnp.asarray(x_T),
        temperature=temperature, callback=lambda *a: None)
    noise = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(_jax_step_noise(key, steps), -1, 2)))
    calls = []
    tsched = tsch.DDIMSchedule.create(builders.sd14_schedule(), steps,
                                      eta=0.5)
    got = tddim.ddim_sample(
        _tfn, (SHAPE[0], SHAPE[3]) + SHAPE[1:3], tsched,
        {"c": torch.from_numpy(c)}, {"c": torch.from_numpy(u)},
        cfg_scale=3.0, x_T=nchw(x_T), temperature=temperature,
        callback=lambda *a: calls.append(a), step_noise=noise)
    _close(got, ref)
    assert calls == []            # accepted, never called, as in JAX


def test_ddim_step_temperature_scales_the_noise_term_alone():
    x_T, _, _ = _inputs(33)
    rng = np.random.default_rng(34)
    e_t = rng.standard_normal(SHAPE).astype(np.float32)
    noise = rng.standard_normal(SHAPE).astype(np.float32)
    jsched = jsch.DDIMSchedule.create(_jax_schedule(), 10, eta=0.7)
    tsched = tsch.DDIMSchedule.create(builders.sd14_schedule(), 10, eta=0.7)
    for temperature in (0.25, 1.0):
        ref = jddim.ddim_step(jnp.asarray(x_T), jnp.asarray(e_t), 4, jsched,
                              jnp.asarray(noise), temperature)
        got = tddim.ddim_step(nchw(x_T), nchw(e_t), 4, tsched, nchw(noise),
                              temperature)
        for g, r in zip(got, ref):
            _close(g, r)
    base = tddim.ddim_step(nchw(x_T), nchw(e_t), 4, tsched)
    half = tddim.ddim_step(nchw(x_T), nchw(e_t), 4, tsched, nchw(noise), 0.5)
    torch.testing.assert_close(half[1], base[1])     # pred_x0 untouched
    torch.testing.assert_close(
        half[0] - base[0], 0.5 * float(tsched.sigmas[4]) * nchw(noise),
        rtol=1e-5, atol=1e-6)
