"""The port's attention-distillation step held against the JAX package, on
the CPU.

``teacher_attention_maps``, ``diffusion_loss(distill=True)`` at batch 4 (the
capture batch ``tb = 2`` splits it), one ``make_train_step(distill=True)``
step (its metrics, and its adapter gradients through an SGD(1.0) JAX step),
the JAX package's two equivalence tests (``tests/test_train.py:156-244``:
rows past ``tb`` do not reach ``loss_distill``; the reduced teacher capture
equals pooling the full maps), and the trainer's distillation cadence.

Tiny geometries of ``tests/test_torch_train.py``, float32.  Weights are the
port's seeded init with 0.02 N(0, 1) on every parameter, read into flax
through the JAX ingest; JAX's ``t``/``noise``/posterior draws are rebuilt
from its key splits and injected into the port.  Tolerances: losses and
maps 1e-4 relative (``LOSS_RTOL``); gradients max|d| <= 1e-3 x max|ref|
(``GRAD_TOL``).
"""

import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import fgdm_tpu.core.schedules as jsch  # noqa: E402
import fgdm_tpu.train.state as jstate  # noqa: E402
from fgdm_tpu import config as jconfig  # noqa: E402
from fgdm_tpu.checkpoint import loader as jloader  # noqa: E402
from fgdm_tpu.checkpoint import torch_ingest as jti  # noqa: E402
from fgdm_tpu.diffusion import losses as jlosses  # noqa: E402
from fgdm_tpu.diffusion.latent_diffusion import (  # noqa: E402
    LatentDiffusion as JLatentDiffusion)
from fgdm_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL  # noqa: E402
from fgdm_tpu.models.clip import CLIPTextEncoder as JCLIPTextEncoder  # noqa: E402
from fgdm_tpu.train.train_step import make_train_step as j_make_train_step  # noqa: E402
from fgdm_tpu_torch import builders, config  # noqa: E402
from fgdm_tpu_torch.checkpoint import torch_ingest as ti  # noqa: E402
from fgdm_tpu_torch.core.schedules import DiffusionSchedule  # noqa: E402
from fgdm_tpu_torch.diffusion import losses  # noqa: E402
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion  # noqa: E402
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL  # noqa: E402
from fgdm_tpu_torch.models.clip import CLIPTextEncoder  # noqa: E402
from fgdm_tpu_torch.nn.attention import CaptureSpec  # noqa: E402
from fgdm_tpu_torch.nn.layers import init_params_  # noqa: E402
from fgdm_tpu_torch.train import state as tstate  # noqa: E402
from fgdm_tpu_torch.train.train_step import make_train_step  # noqa: E402
from fgdm_tpu_torch.utils.attention_maps import (  # noqa: E402
    _resize_query_grid, avg_pool_map_2x)
from test_torch_capture import close, tiny_unet  # noqa: E402
from test_torch_train import (CLIP_TINY, GRAD_TOL, LOSS_RTOL,  # noqa: E402
                              SCHED, VAE_TINY, _capture_grads, _jax_grads,
                              jax_draws, nchw, port_batch)

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _ingested(module, seed, fn, prefix, jdef, *init_args, **init_kw):
    init_params_(module, torch.Generator().manual_seed(seed), 0.02)
    tree, missing, unexpected = fn(
        {prefix + k: v.numpy() for k, v in module.state_dict().items()},
        expect=jloader._abstract_init(jdef, *init_args, **init_kw))
    assert missing == [] and unexpected == []
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """The tiny JAX pipeline and the port's on the same weights, and a
    batch of 4."""
    unet_def, unet_p, unet = tiny_unet(60)
    f32 = dict(dtype=torch.float32, device="cpu")
    vae = AutoencoderKL(**VAE_TINY, **f32)
    clip = CLIPTextEncoder(**CLIP_TINY, **f32)
    vae_def = JAutoencoderKL(**VAE_TINY, dtype=jnp.float32)
    clip_def = JCLIPTextEncoder(**CLIP_TINY)
    vae_p = _ingested(vae, 61, jti.ingest_vae, ti.VAE_PREFIX, vae_def,
                      jnp.zeros((1, 64, 64, 3)), sample_posterior=False)
    clip_p = _ingested(clip, 62, jti.ingest_clip, ti.CLIP_PREFIX, clip_def,
                       jnp.zeros((1, 77), jnp.int32))
    jld = JLatentDiffusion(
        unet_def=unet_def, vae_def=vae_def, clip_def=clip_def,
        unet_params=unet_p, vae_params=vae_p, clip_params=clip_p,
        schedule=jsch.DiffusionSchedule.create(1000, "linear", **SCHED))
    ld = LatentDiffusion(unet.train(), vae.requires_grad_(False).eval(),
                         DiffusionSchedule.create(1000, "linear", **SCHED),
                         clip=clip.requires_grad_(False).eval())
    rng = np.random.default_rng(63)
    batch = dict(image=(rng.standard_normal((4, 64, 64, 3)) * 0.5)
                 .clip(-1, 1).astype(np.float32),
                 input_ids=rng.integers(0, 128, (4, 77)).astype(np.int32))
    return dict(jld=jld, ld=ld, batch=batch)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(64)
    return dict(x=rng.standard_normal((4, 8, 8, 4)).astype(np.float32),
                ctx=rng.standard_normal((4, 77, 64)).astype(np.float32))


def test_teacher_attention_maps_match_jax(tiny, inputs):
    rng = np.random.default_rng(65)
    noise = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([17, 401])
    ref = jlosses.teacher_attention_maps(
        tiny["jld"], jnp.asarray(inputs["x"][:2]), jnp.asarray(noise),
        jnp.asarray(t), {"c_crossattn": jnp.asarray(inputs["ctx"][:2])})
    got = losses.teacher_attention_maps(
        tiny["ld"], nchw(inputs["x"][:2]), nchw(noise), torch.from_numpy(t),
        {"c_crossattn": torch.from_numpy(inputs["ctx"][:2])})
    assert tuple(got[0].shape) == (2, 64, 64)
    assert tuple(got[1].shape) == (2, 8, 8, 77)
    assert not got[0].requires_grad
    for g, r in zip(got, ref):
        close(g, r)


def test_teacher_reduced_capture_equals_pooled_full_maps(tiny, inputs):
    """``tests/test_train.py:198-244`` on the port: the teacher's filtered,
    pool-4 capture equals ``avg_pool_map_2x(times=2)`` of the full capture,
    and its cross maps the resize-then-pool of every layer's."""
    ld = tiny["ld"]
    rng = np.random.default_rng(66)
    x = nchw(inputs["x"][:2])
    noise = nchw(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    t = torch.tensor([17, 401])
    cond = {"c_crossattn": torch.from_numpy(inputs["ctx"][:2])}
    t_self, t_cross = losses.teacher_attention_maps(ld, x, noise, t, cond)
    up = losses.nearest_upsample_2x_latent
    with torch.no_grad():
        _, sa, ca = ld.apply_model(ld.q_sample(up(x), t, up(noise)), t, cond,
                                   adapter_on=False, capture=True)
    full = [avg_pool_map_2x(m, times=2) for m in sa.values()
            if m.shape[1] == 256]
    cross = [losses._pool_cross_2x(_resize_query_grid(
        m, int(round(m.shape[1] ** 0.5)), 16).reshape(2, 16, 16, -1))
        for m in ca.values()]
    torch.testing.assert_close(t_self, sum(full) / len(full), rtol=0,
                               atol=2e-4)
    torch.testing.assert_close(t_cross, sum(cross) / len(cross), rtol=0,
                               atol=2e-4)


@pytest.fixture(scope="module")
def distill_loss(tiny, inputs):
    key = jax.random.PRNGKey(67)
    _, ref = jlosses.diffusion_loss(
        tiny["jld"], key, jnp.asarray(inputs["x"]),
        {"c_crossattn": jnp.asarray(inputs["ctx"])}, distill=True,
        distill_weight=0.3)
    rng_t, rng_noise = jax.random.split(key)
    t = np.array(jax.random.randint(rng_t, (4,), 0, 1000))
    noise = np.array(jax.random.normal(rng_noise, (4, 8, 8, 4), jnp.float32))
    return dict(ref=ref, t=torch.from_numpy(t).long(), noise=nchw(noise))


def _port_loss(tiny, inputs, draws, x=None, **kw):
    with torch.no_grad():
        return losses.diffusion_loss(
            tiny["ld"], nchw(inputs["x"]) if x is None else x,
            {"c_crossattn": torch.from_numpy(inputs["ctx"])}, distill=True,
            distill_weight=0.3, t=draws["t"], noise=draws["noise"], **kw)


def test_distill_loss_matches_jax(tiny, inputs, distill_loss):
    loss, got = _port_loss(tiny, inputs, distill_loss)
    ref = distill_loss["ref"]
    assert set(got) == set(ref) == {"loss", "loss_simple", "loss_vlb",
                                    "loss_distill"}
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                   rtol=LOSS_RTOL)
    assert float(got["loss_distill"]) > 0 and float(loss) == float(
        got["loss"])


def test_distill_split_rows_past_tb_do_not_reach_the_distill_term(
        tiny, inputs, distill_loss):
    """``tests/test_train.py:156-195`` on the port: perturbing rows past
    ``tb`` moves ``loss_simple`` and leaves ``loss_distill``; ``trunc_bs``
    = B captures the whole batch in one forward."""
    _, a = _port_loss(tiny, inputs, distill_loss, trunc_bs=2)
    x2 = nchw(inputs["x"])
    x2[2:] += 0.37
    _, b = _port_loss(tiny, inputs, distill_loss, x=x2, trunc_bs=2)
    np.testing.assert_allclose(float(a["loss_distill"]),
                               float(b["loss_distill"]), rtol=1e-6)
    assert abs(float(a["loss_simple"]) - float(b["loss_simple"])) > 1e-6
    _, c = _port_loss(tiny, inputs, distill_loss, trunc_bs=4)
    assert np.isfinite(float(c["loss_distill"]))
    assert float(c["loss_simple"]) == pytest.approx(float(a["loss_simple"]),
                                                    rel=1e-5)


@pytest.fixture(scope="module")
def distill_step(tiny):
    """One JAX distill step (SGD(1.0): the update is the gradient) and the
    port's on the same weights, batch and draws."""
    jld, batch = tiny["jld"], tiny["batch"]
    js = jstate.TrainState.create(jld.unet_params, optax.sgd(1.0),
                                  trainable_filter=jstate.adapter_filter())
    before = jax.tree.map(np.asarray, js)
    key = jax.random.PRNGKey(68)
    js2, jmetrics = j_make_train_step(jld, distill=True, distill_weight=0.5)(
        js, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    ld = tiny["ld"]
    state = tstate.TrainState.create(ld.unet, tstate.make_adamw(1e-3),
                                     trainable_filter=tstate.adapter_filter())
    grads = _capture_grads(state)
    t, noise, eps = jax_draws(key, 4, (4, 8, 8, 4))
    params0 = {k: p.detach().clone() for k, p in state.params.items()}
    state, metrics = make_train_step(ld, distill=True, distill_weight=0.5)(
        state, port_batch(batch), torch.Generator().manual_seed(0),
        t=torch.from_numpy(t).long(), noise=nchw(noise),
        posterior_eps=nchw(eps))
    with torch.no_grad():   # the module fixture's weights stay as they were
        for k, p in state.params.items():
            p.copy_(params0[k])
    return dict(jmetrics=jmetrics, jgrads=_jax_grads(before, js2),
                metrics=metrics, grads=grads)


@pytest.mark.parametrize("key", ["loss", "loss_simple", "loss_vlb",
                                 "loss_distill", "grad_norm"])
def test_distill_step_metrics_match_jax(distill_step, key):
    np.testing.assert_allclose(float(distill_step["metrics"][key]),
                               float(distill_step["jmetrics"][key]),
                               rtol=LOSS_RTOL)


def test_distill_step_adapter_grads_match_jax(distill_step):
    grads, jgrads = distill_step["grads"], distill_step["jgrads"]
    assert set(grads) == set(jgrads) and grads
    scale = max(np.abs(g).max() for g in map(np.asarray, jgrads.values()))
    assert scale > 0
    err = max(np.abs(grads[k].numpy() - jgrads[k].numpy()).max()
              for k in grads)
    assert err <= GRAD_TOL * scale, (err, scale)


# --- the recipe: config and cadence ----------------------------------------

def test_config_distill_recipe_matches_jax():
    path = str(REPO / "models" / "config.yaml")
    ref = jconfig.instantiate_from_config(
        jconfig.load_config(path)["model"])
    got = config.instantiate_from_config(config.load_config(path)["model"])
    assert (got.apply_distill_loss, got.distill_every_n_step) == (
        ref.apply_distill_loss, ref.distill_every_n_step) == (True, 10)
    bare = builders.build_latent_diffusion()
    assert (bare.apply_distill_loss, bare.distill_every_n_step) == (False, 10)


@pytest.mark.parametrize("every", [10, 3])
def test_trainer_takes_the_distill_step_on_the_cadence(every):
    plain, distill = object(), object()
    tr = builders.Trainer(None, None, plain, {}, distill,
                          distill_every_n_step=every)
    picks = [s for s in range(25) if tr.step_fn(s) is distill]
    assert picks == list(range(0, 25, every))
    assert all(tr.step_fn(s) is plain for s in range(25) if s not in picks)
