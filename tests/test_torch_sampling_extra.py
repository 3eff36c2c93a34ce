"""The port's remaining samplers held against the JAX package, on the CPU:
the DDPM posterior tables of ``DiffusionSchedule`` and
``predict_start_from_noise``, img2img (``stochastic_encode`` and
``ddim_decode``), ``augmented_cfg_eps``, ``composable_cfg_eps``, the
ancestral ``p_sample_loop``, tiled VAE decode and encode, and the
rich-text parser.

The tiny UNet is ``tests/test_torch_capture.py``'s (``UNET_TINY``, 8x8
latents, the port's seeded init with 0.02 N(0, 1) read into flax through
the JAX ingest); the tiny VAE the port's seeded init of ``VAE_TINY`` read
the same way.  Torch cannot draw ``jax.random``'s bits: the ancestral tests
rebuild JAX's draws from its key splits (``rng, init = split(rng)``,
``split(rng, T)``) and inject them as ``x_T`` and ``step_noise``.

Tolerances: the tables and ``predict_start_from_noise`` bit for bit (the
same float64 numpy, cast once; one f32 product and difference); a UNet
forward and the samplers 1e-5 x max(1, max|ref|) (f32 sums in another
order; the ancestral loop's 20 steps and img2img's 3 read below it on an
x86 CPU), the augmented guidance that times the sum of its weights on the
three eps; the tiled VAE 1e-5 x max(1, max|ref|); the parser exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.core.schedules as jsch  # noqa: E402
import fgdm_tpu.sampling.ancestral as janc  # noqa: E402
import fgdm_tpu.sampling.ddim as jddim  # noqa: E402
import fgdm_tpu.sampling.tiled as jtiled  # noqa: E402
import fgdm_tpu.utils.richtext as jrt  # noqa: E402
from fgdm_tpu.checkpoint import loader as jloader  # noqa: E402
from fgdm_tpu.checkpoint import torch_ingest as jti  # noqa: E402
from fgdm_tpu.diffusion.latent_diffusion import (  # noqa: E402
    LatentDiffusion as JLatentDiffusion)
from fgdm_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL  # noqa: E402
from fgdm_tpu_torch.checkpoint import torch_ingest as ti  # noqa: E402
from fgdm_tpu_torch.core import schedules as tsch  # noqa: E402
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion  # noqa: E402
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL  # noqa: E402
from fgdm_tpu_torch.nn.layers import init_params_  # noqa: E402
from fgdm_tpu_torch.sampling import ancestral as tanc  # noqa: E402
from fgdm_tpu_torch.sampling import ddim as tddim  # noqa: E402
from fgdm_tpu_torch.sampling import tiled as ttiled  # noqa: E402
from fgdm_tpu_torch.utils import richtext as trt  # noqa: E402
from test_torch_capture import tiny_unet  # noqa: E402
from test_torch_train import SCHED, VAE_TINY, nchw  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5
NEW_TABLES = ("log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
              "sqrt_recipm1_alphas_cumprod", "posterior_variance",
              "posterior_log_variance_clipped", "posterior_mean_coef1",
              "posterior_mean_coef2", "lvlb_weights")


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def assert_close(port, ref, tol=TOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


# --- the schedule --------------------------------------------------------------

SCHEDULES = {
    "sd14": dict(timesteps=1000, beta_schedule="linear", **SCHED),
    "cosine": dict(timesteps=1000, beta_schedule="cosine"),
    "v-posterior": dict(timesteps=200, beta_schedule="linear",
                        v_posterior=0.1, **SCHED),
    "x0": dict(timesteps=20, beta_schedule="sqrt_linear",
               parameterization="x0"),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_posterior_tables_match_jax_bit_for_bit(name):
    kw = SCHEDULES[name]
    j = jsch.DiffusionSchedule.create(**kw)
    t = tsch.DiffusionSchedule.create(**kw)
    for table in NEW_TABLES:
        got = getattr(t, table)
        assert got.dtype == torch.float32, table
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(j, table)),
                                      err_msg=table)
    if "v_posterior" not in kw:
        assert t.posterior_variance[0] == 0.0
    moved = t.to("cpu")
    assert torch.equal(moved.posterior_mean_coef2, t.posterior_mean_coef2)


def test_predict_start_from_noise_matches_jax_bit_for_bit():
    kw = SCHEDULES["sd14"]
    j = jsch.DiffusionSchedule.create(**kw)
    t = tsch.DiffusionSchedule.create(**kw)
    rng = np.random.default_rng(0)
    x, n = (rng.standard_normal((3, 4, 5, 6)).astype(np.float32)
            for _ in range(2))
    ts = np.array([0, 417, 999])
    ref = j.predict_start_from_noise(jnp.asarray(x), jnp.asarray(ts),
                                     jnp.asarray(n))
    got = t.predict_start_from_noise(nchw(x), torch.from_numpy(ts), nchw(n))
    np.testing.assert_array_equal(nhwc(got), np.asarray(ref))


# --- img2img and the guidance variants on the tiny UNet ---------------------------

@pytest.fixture(scope="module")
def pipes():
    jdef, jp, unet = tiny_unet(90)
    kw = SCHEDULES["sd14"]
    jld = JLatentDiffusion(unet_def=jdef, vae_def=None, clip_def=None,
                           unet_params=jp,
                           schedule=jsch.DiffusionSchedule.create(**kw))
    ld = LatentDiffusion(unet.requires_grad_(False), None,
                         tsch.DiffusionSchedule.create(**kw))
    rng = np.random.default_rng(91)
    return dict(jld=jld, ld=ld,
                x=rng.standard_normal((1, 8, 8, 4)).astype(np.float32),
                ctx=rng.standard_normal((3, 77, 64)).astype(np.float32),
                uc=rng.standard_normal((1, 77, 64)).astype(np.float32))


def _conds(pipes, rows):
    c = pipes["ctx"][rows]
    return {"c_crossattn": jnp.asarray(c)}, {"c_crossattn":
                                             torch.from_numpy(c)}


@pytest.mark.parametrize("t_index", [0, 3, [1, 4]], ids=["first", "mid",
                                                          "per-item"])
def test_stochastic_encode_matches_jax(pipes, t_index):
    js = jsch.DDIMSchedule.create(pipes["jld"].schedule, 5)
    ts = tsch.DDIMSchedule.create(pipes["ld"].schedule, 5)
    rng = np.random.default_rng(92)
    x0, n = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
             for _ in range(2))
    ref = jddim.stochastic_encode(pipes["jld"].schedule, js, jnp.asarray(x0),
                                  jnp.asarray(t_index), jnp.asarray(n))
    got = tddim.stochastic_encode(pipes["ld"].schedule, ts, nchw(x0),
                                  t_index, nchw(n))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("cfg_scale", [1.0, 7.5])
def test_ddim_decode_matches_jax(pipes, cfg_scale):
    """img2img: encode to step 3 of 5, then three eta-free steps back."""
    p = pipes
    js = jsch.DDIMSchedule.create(p["jld"].schedule, 5)
    ts = tsch.DDIMSchedule.create(p["ld"].schedule, 5)
    n = np.random.default_rng(93).standard_normal((1, 8, 8, 4)).astype(
        np.float32)
    jz = jddim.stochastic_encode(None, js, jnp.asarray(p["x"]), 3,
                                 jnp.asarray(n))
    tz = tddim.stochastic_encode(None, ts, nchw(p["x"]), 3, nchw(n))
    jc, tc = _conds(p, slice(0, 1))
    ju = {"c_crossattn": jnp.asarray(p["uc"])}
    tu = {"c_crossattn": torch.from_numpy(p["uc"])}
    ref = jddim.ddim_decode(p["jld"].denoise_fn(), jz, js, 3, jc, ju,
                            cfg_scale)
    got = tddim.ddim_decode(p["ld"].denoise_fn(), tz, ts, 3, tc, tu,
                            cfg_scale)
    assert got.shape == (1, 4, 8, 8)
    assert np.abs(np.asarray(ref) - np.asarray(jz)).max() > 1e-2
    assert_close(nhwc(got), ref)


def test_augmented_cfg_eps_matches_jax(pipes):
    p = pipes
    t = np.array([601])
    jc, tc = _conds(p, slice(0, 1))
    ja, ta = _conds(p, slice(1, 2))
    ju = {"c_crossattn": jnp.asarray(p["uc"])}
    tu = {"c_crossattn": torch.from_numpy(p["uc"])}
    seen = []

    def fn(x, tt, cond):
        seen.append(x.shape[0])
        return p["ld"].denoise_fn()(x, tt, cond)

    ref = jddim.augmented_cfg_eps(p["jld"].denoise_fn(), jnp.asarray(p["x"]),
                                  jnp.asarray(t), jc, ja, ju, 5.0)
    with torch.no_grad():
        got = tddim.augmented_cfg_eps(fn, nchw(p["x"]), torch.from_numpy(t),
                                      tc, ta, tu, 5.0)
    assert seen == [3]
    # e = (1 - s) uc + s (1 - s) ac + s^2 c: each eps's float32 difference
    # enters times its weight (49 at s = 5)
    s = 5.0
    assert_close(nhwc(got), ref, TOL * (abs(1 - s) + abs(s * (1 - s))
                                        + s * s))


def test_composable_cfg_eps_matches_jax(pipes):
    """Two prompts composed: one forward of batch 3, [uncond, c1, c2]."""
    p = pipes
    t = np.array([301])
    jc, tc = _conds(p, slice(1, 3))
    ju = {"c_crossattn": jnp.asarray(p["uc"])}
    tu = {"c_crossattn": torch.from_numpy(p["uc"])}
    ref = jddim.composable_cfg_eps(p["jld"].denoise_fn(),
                                   jnp.asarray(p["x"]), jnp.asarray(t), jc,
                                   ju, 2)
    with torch.no_grad():
        got = tddim.composable_cfg_eps(p["ld"].denoise_fn(), nchw(p["x"]),
                                       torch.from_numpy(t), tc, tu, 2)
    assert got.shape == (1, 4, 8, 8)
    assert_close(nhwc(got), ref)


def test_guidance_variants_refuse_mismatched_conds(pipes):
    x, t = nchw(pipes["x"]), torch.tensor([1])
    c = {"c_crossattn": torch.zeros(1, 77, 64)}
    with pytest.raises(ValueError, match="cond keys differ"):
        tddim.augmented_cfg_eps(pipes["ld"].denoise_fn(), x, t, c, c,
                                {"other": torch.zeros(1, 77, 64)}, 2.0)


# --- the ancestral sampler ------------------------------------------------------

def jax_draws(seed, shape, T):
    """JAX's x_T and per-step noise of ``p_sample_loop`` (its key splits)."""
    rng = jax.random.PRNGKey(seed)
    rng, init = jax.random.split(rng)
    x_T = jax.random.normal(init, shape, jnp.float32)
    steps = jax.random.split(rng, T)
    noise = jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(
        steps)
    return np.asarray(x_T), np.asarray(noise)


@pytest.mark.parametrize("clip,log_every_t,cfg", [
    (True, 0, 1.0), (False, 5, 1.0), (True, 7, 3.0)],
    ids=["clip", "no-clip-log5", "clip-log7-cfg"])
def test_p_sample_loop_matches_jax(pipes, clip, log_every_t, cfg):
    """T = 20 (``tests/test_observability.py:55``'s schedule) on the tiny
    UNet, JAX's own draws injected into the port."""
    p = pipes
    T, shape = 20, (1, 8, 8, 4)
    js = jsch.DiffusionSchedule.create(T, "linear", **SCHED)
    ts = tsch.DiffusionSchedule.create(T, "linear", **SCHED)
    jc, tc = _conds(p, slice(0, 1))
    ju = {"c_crossattn": jnp.asarray(p["uc"])}
    tu = {"c_crossattn": torch.from_numpy(p["uc"])}
    ref, rinter = janc.p_sample_loop(
        p["jld"].denoise_fn(), jax.random.PRNGKey(7), shape, js, jc, ju,
        cfg, clip_denoised=clip, log_every_t=log_every_t)
    x_T, noise = jax_draws(7, shape, T)
    step_noise = torch.from_numpy(np.moveaxis(noise, -1, 2).copy())
    got, inter = tanc.p_sample_loop(
        p["ld"].denoise_fn(), (1, 4, 8, 8), ts, tc, tu, cfg,
        clip_denoised=clip, x_T=nchw(x_T), log_every_t=log_every_t,
        step_noise=step_noise)
    assert_close(nhwc(got), ref)
    assert sorted(inter) == sorted(rinter)
    if log_every_t:
        assert inter["x_inter"].shape[0] == -(-T // log_every_t)
        assert_close(np.moveaxis(inter["x_inter"].numpy(), 2, -1),
                     rinter["x_inter"])


def test_p_sample_loop_noise_sources():
    """A callable ``step_noise`` equals the stacked tensor; the generator
    draws reproduce; no noise at t = 0 (the last step's draw is
    multiplied by 0)."""
    sched = tsch.DiffusionSchedule.create(6, "linear", **SCHED)

    def fn(x, t, cond):
        return 0.1 * x

    shape = (2, 3, 4, 4)
    g = torch.Generator().manual_seed(3)
    noise = torch.randn((6,) + shape, generator=g)
    x_T = torch.randn(shape, generator=g)
    a, _ = tanc.p_sample_loop(fn, shape, sched, x_T=x_T, step_noise=noise)
    b, _ = tanc.p_sample_loop(fn, shape, sched, x_T=x_T,
                              step_noise=lambda i: noise[i])
    assert torch.equal(a, b)
    last = noise.clone()
    last[-1] = 1e3
    c, _ = tanc.p_sample_loop(fn, shape, sched, x_T=x_T, step_noise=last)
    assert torch.equal(a, c)
    d, _ = tanc.p_sample_loop(fn, shape, sched,
                              generator=torch.Generator().manual_seed(4))
    e, _ = tanc.p_sample_loop(fn, shape, sched,
                              generator=torch.Generator().manual_seed(4))
    assert torch.equal(d, e) and d.shape == shape
    with pytest.raises(ValueError, match="step_noise or a generator"):
        tanc.p_sample_loop(fn, shape, sched, x_T=x_T)


# --- tiling ---------------------------------------------------------------------

@pytest.mark.parametrize("size,tile,stride", [(100, 40, 30), (128, 64, 48),
                                              (1024, 512, 384), (64, 64, 48),
                                              (50, 64, 48)])
def test_tile_starts_and_window_match_jax(size, tile, stride):
    assert ttiled._tile_starts(size, tile, stride) == jtiled._tile_starts(
        size, tile, stride)
    got, ref = ttiled._smooth_window(tile), jtiled._smooth_window(tile)
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got, ref)


def _updown(t, k):
    """A known resolution-changing function: x k by repetition (k > 1) or
    1/k by mean pooling, in NCHW, times a channel mix."""
    if k >= 1:
        t = t.repeat_interleave(k, 2).repeat_interleave(k, 3)
    else:
        t = torch.nn.functional.avg_pool2d(t, int(round(1 / k)))
    return torch.cat([t, 2 * t[:, :1]], dim=1)


def _jupdown(t, k):
    b, h, w, c = t.shape
    if k >= 1:
        t = jnp.repeat(jnp.repeat(t, k, 1), k, 2)
    else:
        s = int(round(1 / k))
        t = t.reshape(b, h // s, s, w // s, s, c).mean((2, 4))
    return jnp.concatenate([t, 2 * t[..., :1]], axis=-1)


@pytest.mark.parametrize("k,tile,stride", [(1, 32, 24), (2, 16, 8),
                                           (0.25, 32, 24)],
                         ids=["identity", "x2", "quarter"])
def test_tiled_apply_matches_jax(k, tile, stride):
    x = np.random.default_rng(5).standard_normal((2, 64, 48, 3)).astype(
        np.float32)
    ref = jtiled.tiled_apply(lambda t: _jupdown(t, k), jnp.asarray(x), tile,
                             stride, out_scale=k if k != 1 else 1)
    got = ttiled.tiled_apply(lambda t: _updown(t, k), nchw(x), tile, stride,
                             out_scale=k if k != 1 else 1)
    assert got.dtype == torch.float32
    assert_close(nhwc(got), ref)
    # the blend of a pointwise function's tiles is the function's output
    whole = _updown(nchw(x), k)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="not by"):
        ttiled.tiled_apply(lambda t: t, nchw(x), tile, stride, out_scale=4)


def test_tiled_apply_keeps_the_output_dtype():
    x = torch.randn(1, 2, 40, 40, generator=torch.Generator().manual_seed(6))
    got = ttiled.tiled_apply(lambda t: t.to(torch.bfloat16), x, 16, 12)
    # each blended value is a bf16 value to f32 rounding: it rounds back
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, x.to(torch.bfloat16))


@pytest.fixture(scope="module")
def vaes():
    """The port's seeded tiny VAE read into flax through the JAX ingest."""
    vae = init_params_(AutoencoderKL(**VAE_TINY, dtype=torch.float32,
                                     device="cpu"),
                       torch.Generator().manual_seed(94), 0.02).eval()
    jvae = JAutoencoderKL(**VAE_TINY, dtype=jnp.float32)
    vae_p, missing, unexpected = jti.ingest_vae(
        {ti.VAE_PREFIX + k: v.numpy() for k, v in vae.state_dict().items()},
        expect=jloader._abstract_init(jvae, jnp.zeros((1, 64, 64, 3)),
                                      sample_posterior=False))
    assert missing == [] and unexpected == []
    jld = JLatentDiffusion(unet_def=None, vae_def=jvae, clip_def=None,
                           vae_params=vae_p)
    return jld, LatentDiffusion(None, vae, None)


def test_tiled_decode_matches_jax(vaes):
    """A 14x14 latent as four 8x8 tiles (overlap 2) -> 112^2."""
    jld, ld = vaes
    z = np.random.default_rng(95).standard_normal((1, 14, 14, 4)).astype(
        np.float32)
    ref = jtiled.tiled_decode(jld, jnp.asarray(z), tile=8, overlap=2)
    got = ttiled.tiled_decode(ld, nchw(z), tile=8, overlap=2)
    assert got.shape == (1, 3, 112, 112)
    assert_close(nhwc(got), ref)
    # where one tile alone covers the output its window normalises away
    with torch.inference_mode():
        alone = ld.decode_first_stage(nchw(z)[:, :, :8, :8])
    np.testing.assert_allclose(got[:, :, :48, :48].numpy(),
                               alone[:, :, :48, :48].numpy(), rtol=0,
                               atol=1e-5)


def test_tiled_encode_matches_jax(vaes):
    """A 112^2 image as four 64^2 tiles (overlap 16) -> a 14x14 latent."""
    jld, ld = vaes
    img = np.random.default_rng(96).uniform(-1, 1, (1, 112, 112, 3)).astype(
        np.float32)
    ref = jtiled.tiled_encode(jld, jnp.asarray(img), tile=64, overlap=16)
    got = ttiled.tiled_encode(ld, nchw(img), tile=64, overlap=16)
    assert got.shape == (1, 4, 14, 14)
    assert_close(nhwc(got), ref)


# --- rich text ------------------------------------------------------------------

PAYLOADS = {
    # tests/test_utils_misc.py:36's payload
    "misc": {"ops": [
        {"insert": "a house "},
        {"insert": "garden", "attributes": {"font": "slabo"}},
        {"insert": " with a "},
        {"insert": "red door", "attributes": {"color": "#ff0000"}},
        {"insert": "sun", "attributes": {"size": "60px"}},
        {"insert": "moon", "attributes": {"link": "a glowing moon"}},
    ]},
    # a font run over two spans, broken by a space and resumed; a second
    # font; a struck-out size; one color over two spans, then another
    "runs": {"ops": [
        {"insert": "a "},
        {"insert": "tall", "attributes": {"font": "mirza"}},
        {"insert": "tree", "attributes": {"font": "mirza",
                                          "color": "#20a020"}},
        {"insert": " "},
        {"insert": "bird", "attributes": {"font": "mirza",
                                          "color": "#20a021"}},
        {"insert": "sky", "attributes": {"font": "Akronim",
                                         "size": "45px", "strike": True}},
        {"insert": "river", "attributes": {"color": "#1010f0",
                                           "link": "a wide blue river",
                                           "size": "90px"}},
        {"insert": "end\n"},
    ]},
    "plain": {"ops": [{"insert": "just words\n"}]},
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_parse_json_matches_jax(name):
    got = trt.parse_json(PAYLOADS[name])
    ref = jrt.parse_json(PAYLOADS[name])
    assert len(got) == len(ref) == 9
    for g, r in zip(got, ref):
        if isinstance(r, list) and r and isinstance(r[0], np.ndarray):
            assert len(g) == len(r)
            for a, b in zip(g, r):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        else:
            assert g == r


def test_colors_match_jax():
    assert trt.COLORS == jrt.COLORS and trt.FONT_STYLES == jrt.FONT_STYLES
    for h in ("#ff8000", "#123456", "#fefefe"):
        np.testing.assert_array_equal(trt.hex_to_rgb(h), jrt.hex_to_rgb(h))
    for rgb in ([250, 5, 5], [0, 0, 10], [0.5, 0.5, 0.52], [200, 100, 150]):
        assert trt.find_nearest_color(rgb) == jrt.find_nearest_color(rgb)
