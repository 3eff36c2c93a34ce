"""The port's PLMS and DPM-Solver++ samplers and the chain's sampler choice
held against the JAX package.

The tiny pipelines of ``tests/test_torch_chain.py`` (same weights in both
packages, float32 on the CPU).  Torch cannot reproduce ``jax.random`` bits,
so x_T is drawn with numpy (or from the port's slot streams) and injected
into both; PLMS and DPM-Solver++ are deterministic after x_T.

Tolerances: the ``NoiseScheduleVP`` log-alpha table exactly as float32, its
time grid within one float32 ulp, its interpolated tables 1e-5 relative
(float32 arithmetic in another order); sampled latents 2e-3 * max|ref|,
decoded maps and images 2e-3 absolute (``CHAIN_TOL``, values in [0, 1] and
[-1, 1]); the hint 1/255 on at most 1 % of its pixels (the uint8 hop can
flip a step between frameworks).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.sampling.chain as jchain  # noqa: E402
import fgdm_tpu.sampling.dpm_solver as jdpm  # noqa: E402
from fgdm_tpu_torch import builders  # noqa: E402
from fgdm_tpu_torch.core import schedules as tsch  # noqa: E402
from fgdm_tpu_torch.sampling import chain as tchain  # noqa: E402
from fgdm_tpu_torch.sampling import ddim as tddim  # noqa: E402
from fgdm_tpu_torch.sampling import dpm_solver as tdpm  # noqa: E402
from fgdm_tpu_torch.sampling import plms as tplms  # noqa: E402
from test_torch_chain import (CHAIN_TOL, COND_HW, IMAGE_HW,  # noqa: E402,F401
                              nchw, nhwc, sd14_jax_schedule, tiny)

torch.set_num_threads(2)

LAT1 = (COND_HW[0] // 8, COND_HW[1] // 8)
LAT2 = (IMAGE_HW[0] // 8, IMAGE_HW[1] // 8)
STEPS = 4
SAMPLERS = ["plms", "dpm"]


def _close_latents(z, ref):
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(nhwc(z), ref, rtol=0,
                               atol=CHAIN_TOL * np.abs(ref).max())


def _decode01(ld, z):
    with torch.inference_mode():
        return ((ld.decode_first_stage(z) + 1.0) / 2.0).clamp(0.0, 1.0)


# --- the schedule ------------------------------------------------------------

def test_noise_schedule_vp_tables_match_jax():
    j = jdpm.NoiseScheduleVP(sd14_jax_schedule().alphas_cumprod)
    t = tdpm.NoiseScheduleVP(builders.sd14_schedule().alphas_cumprod)
    assert t.total_N == j.total_N == 1000
    np.testing.assert_array_equal(t.log_alpha_array.numpy(),
                                  np.asarray(j.log_alpha_array))
    # linspace in float32 on both sides, within one ulp
    np.testing.assert_allclose(t.t_array.numpy(), np.asarray(j.t_array),
                               rtol=1.2e-7)
    grid = np.concatenate([np.linspace(1.0, 1e-3, 21, dtype=np.float32),
                           np.array([0.0, 5e-4, 0.0137, 0.5001, 1.2],
                                    np.float32)])
    for name in ("marginal_log_mean_coeff", "marginal_alpha", "marginal_std",
                 "marginal_lambda", "model_input_time"):
        got = getattr(t, name)(torch.from_numpy(grid))
        ref = np.asarray(getattr(j, name)(jnp.asarray(grid)))
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["tensor", "moved", "numpy", "list"])
def test_noise_schedule_vp_takes_the_table_in_any_form(kind):
    """The JAX solver once crashed on a schedule that arrived traced
    (recorded in NEXT.md); the port's counterpart is a table that lives on
    the sampler's device or arrives as an array: each gives the same
    float64 log table."""
    sched = builders.sd14_schedule()
    acp = {"tensor": sched.alphas_cumprod,
           "moved": sched.to("cpu").alphas_cumprod,
           "numpy": sched.alphas_cumprod.numpy(),
           "list": sched.alphas_cumprod.tolist()}[kind]
    ref = tdpm.NoiseScheduleVP(sched.alphas_cumprod)
    got = tdpm.NoiseScheduleVP(acp)
    assert torch.equal(got.log_alpha_array, ref.log_alpha_array)
    assert got.total_N == 1000


# --- the samplers' own contracts -------------------------------------------

def _probe(calls):
    def fn(x, t, cond):
        calls.append(t.clone())
        return 0.1 * x + cond["c"][:, :, None, None]
    return fn


def test_plms_calls_the_model_once_more_than_its_steps():
    sched = tsch.DDIMSchedule.create(builders.sd14_schedule(), 5)
    calls = []
    c = torch.ones(2, 3)
    x = tplms.plms_sample(_probe(calls), (2, 3, 4, 4), sched, {"c": c},
                          cfg_scale=1.0, slot_seeds=[1, 2], device="cpu")
    assert x.shape == (2, 3, 4, 4) and len(calls) == 6
    ts = sched.timesteps.tolist()
    # step 0 evaluates t and then the next t for its midpoint correction
    assert [int(t[0]) for t in calls] == [ts[4], ts[3], ts[3], ts[2], ts[1],
                                          ts[0]]
    with pytest.raises(ValueError, match="eta=0"):
        tplms.plms_sample(_probe([]), (2, 3, 4, 4),
                          tsch.DDIMSchedule.create(builders.sd14_schedule(),
                                                   5, eta=0.5), {"c": c},
                          slot_seeds=[1, 2], device="cpu")


def test_dpm_feeds_float_timesteps():
    calls = []
    x = tdpm.dpm_solver_sample(_probe(calls), (2, 3, 4, 4),
                               builders.sd14_schedule(),
                               {"c": torch.ones(2, 3)}, cfg_scale=1.0,
                               steps=5, slot_seeds=[1, 2], device="cpu")
    assert x.shape == (2, 3, 4, 4) and len(calls) == 5
    ts = np.linspace(1.0, 1e-3, 6, dtype=np.float32)[:5]
    for got, t in zip(calls, ts):
        assert got.dtype == torch.float32 and got.shape == (2,)
        np.testing.assert_allclose(got.numpy(), (t - 1e-3) * 1000.0,
                                   rtol=1e-5)
    assert calls[1][0] != round(float(calls[1][0]))   # not an integer t


# --- the factors against JAX -----------------------------------------------

@pytest.fixture(scope="module")
def x_ts():
    rng = np.random.default_rng(21)
    return (rng.standard_normal((1,) + LAT1 + (4,)).astype(np.float32),
            rng.standard_normal((1,) + LAT2 + (4,)).astype(np.float32))


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_condition_factor_matches_jax(tiny, x_ts, sampler):
    c1, u1 = tiny["ctxs"][:2]
    ref = jax.jit(lambda x: jchain.sample_condition_factor(
        tiny["jld"], jax.random.PRNGKey(0), jnp.asarray(c1),
        jnp.asarray(u1), latent_hw=LAT1, num_steps=STEPS, x_T=x,
        sampler=sampler))(jnp.asarray(x_ts[0]))
    z = tchain.sample_condition_factor(
        tiny["ld"], torch.from_numpy(c1), torch.from_numpy(u1),
        latent_hw=LAT1, num_steps=STEPS, x_T=nchw(x_ts[0]), sampler=sampler)
    _close_latents(z, ref)
    ref_cond = np.clip((np.asarray(tiny["jld"].decode_first_stage(ref))
                        + 1.0) / 2.0, 0.0, 1.0)
    np.testing.assert_allclose(nhwc(_decode01(tiny["ld"], z)), ref_cond,
                               rtol=0, atol=CHAIN_TOL)


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_image_factor_matches_jax(tiny, x_ts, sampler):
    c2, u2 = tiny["ctxs"][2:]
    hint = np.random.default_rng(22).random((1,) + IMAGE_HW + (3,)).astype(
        np.float32)
    ref = jax.jit(lambda h, x: jchain.sample_image_factor(
        tiny["jcldm"], jax.random.PRNGKey(1), h, jnp.asarray(c2),
        jnp.asarray(u2), num_steps=STEPS, x_T=x, sampler=sampler))(
            jnp.asarray(hint), jnp.asarray(x_ts[1]))
    z = tchain.sample_image_factor(
        tiny["cldm"], nchw(hint), torch.from_numpy(c2), torch.from_numpy(u2),
        num_steps=STEPS, x_T=nchw(x_ts[1]), sampler=sampler)
    _close_latents(z, ref)


def test_dpm_chain_matches_jax_composition(tiny):
    """``fgdm_chain(f1_sampler="dpm")`` with slot seeds against the JAX
    composition of ``chain.py:334-350`` fed the port's per-slot x_T; JAX's
    image factor takes the port's hint (see the module docstring)."""
    seeds = [7]
    ctxs = [torch.from_numpy(c) for c in tiny["ctxs"]]
    out = tchain.fgdm_chain(tiny["ld"], tiny["cldm"], *ctxs, cond_hw=COND_HW,
                            image_hw=IMAGE_HW, f1_steps=STEPS, f2_steps=3,
                            slot_seeds=seeds, f1_sampler="dpm")
    xt1, xt2 = (nhwc(tddim.slot_noise(tchain.factor_slot_seeds(seeds, f),
                                      (1, 4) + lat, tddim.SLOT_INIT_TAG,
                                      "cpu"))
                for f, lat in ((1, LAT1), (2, LAT2)))
    jld, jcldm = tiny["jld"], tiny["jcldm"]
    c1, u1, c2, u2 = (jnp.asarray(c) for c in tiny["ctxs"])

    @jax.jit
    def f1(x):
        z = jchain.sample_condition_factor(jld, jax.random.PRNGKey(0), c1, u1,
                                           latent_hw=LAT1,
                                           num_steps=STEPS, x_T=x,
                                           sampler="dpm")
        cond = jnp.clip((jld.decode_first_stage(z) + 1.0) / 2.0, 0.0, 1.0)
        return cond, jchain.condition_to_hint(cond, IMAGE_HW)

    @jax.jit
    def f2(hint, x):
        z2 = jchain.sample_image_factor(jcldm, jax.random.PRNGKey(1), hint,
                                        c2, u2,
                                        num_steps=3, x_T=x)
        return jcldm.decode_first_stage(z2)

    cond, hint = f1(jnp.asarray(xt1))
    np.testing.assert_allclose(nhwc(out["condition"]), np.asarray(cond),
                               rtol=0, atol=CHAIN_TOL)
    d = np.abs(nhwc(out["hint"]) - np.asarray(hint))
    assert d.max() <= 1 / 255 + 1e-6 and (d > 1e-6).mean() <= 0.01
    image = np.asarray(f2(jnp.asarray(nhwc(out["hint"])), jnp.asarray(xt2)))
    assert image.std() > 1e-2
    np.testing.assert_allclose(nhwc(out["image"]), image, rtol=0,
                               atol=CHAIN_TOL)


def _chain(tiny, seeds, **kw):
    b = len(seeds)
    ctxs = [torch.from_numpy(c).expand(b, -1, -1) for c in tiny["ctxs"]]
    return tchain.fgdm_chain(tiny["ld"], tiny["cldm"], *ctxs,
                             cond_hw=COND_HW, image_hw=IMAGE_HW, f1_steps=3,
                             f2_steps=3, slot_seeds=seeds, **kw)


def test_multistep_chain_slot_is_independent_of_its_batch(tiny):
    kw = dict(f1_sampler="dpm", f2_sampler="plms")
    solo, pair = _chain(tiny, [7], **kw), _chain(tiny, [3, 7], **kw)
    for name in ("condition", "hint", "image"):
        torch.testing.assert_close(pair[name][1:], solo[name], rtol=0,
                                   atol=1e-5)
    assert (pair["image"][0] - pair["image"][1]).abs().max() > 1e-2
    ddim = _chain(tiny, [7])
    assert (ddim["condition"] - solo["condition"]).abs().max() > 1e-3


@pytest.mark.parametrize("sampler,eta,match", [("plms", 0.5, "eta=0"),
                                               ("dpm", 1.0, "eta=0"),
                                               ("euler", 0.0, "unknown")])
def test_chain_refuses_eta_and_unknown_samplers(tiny, sampler, eta, match):
    c = torch.from_numpy(tiny["ctxs"][0])
    with pytest.raises(ValueError, match=match):
        tchain.sample_condition_factor(tiny["ld"], c, c, latent_hw=LAT1,
                                       num_steps=2, eta=eta, slot_seeds=[1],
                                       sampler=sampler)
