"""The port's training path held against the JAX package, on the CPU.

Tiny geometries of ``tests/test_train.py:24-29``, float32.  Flax params
(perturbed by 0.02 N(0, 1) so zero-init heads pass gradients) go through
``fgdm_tpu_torch.checkpoint.convert`` into the port with ``strict=True``;
inputs come from ``np.random.default_rng``.  torch cannot reproduce
``jax.random``'s bits, so the tests rebuild JAX's timesteps, noise and
posterior sample from its key splits (``train_step.py:80``,
``losses.py:117-119``, ``autoencoder.py:262``) and inject them into the port.

Tolerances (float32 on both sides, sums in another order): schedule tables
1e-6 relative; losses 1e-4 relative; gradients and updated parameters
max|d| <= 1e-3 * max|ref| (a whole UNet forward and backward); parameters
after 4 optimizer steps 1e-6 relative plus 1e-6 absolute (float32 rounding
of values near 1); EMA shadows 1e-6 relative plus 1e-7 absolute.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import traverse_util  # noqa: E402

import fgdm_tpu.core.schedules as jsch  # noqa: E402
from fgdm_tpu.diffusion.latent_diffusion import (  # noqa: E402
    LatentDiffusion as JLatentDiffusion)
from fgdm_tpu.diffusion.losses import diffusion_loss as j_diffusion_loss  # noqa: E402
from fgdm_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL  # noqa: E402
from fgdm_tpu.models.clip import CLIPTextEncoder as JCLIPTextEncoder  # noqa: E402
from fgdm_tpu.models.unet import UNetModel as JUNetModel  # noqa: E402
import fgdm_tpu.train.lr_schedules as jlr  # noqa: E402
import fgdm_tpu.train.state as jstate  # noqa: E402
from fgdm_tpu.train.train_step import make_train_step as j_make_train_step  # noqa: E402
from fgdm_tpu_torch.checkpoint import convert  # noqa: E402
from fgdm_tpu_torch.core.schedules import DiffusionSchedule  # noqa: E402
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion  # noqa: E402
from fgdm_tpu_torch.diffusion.losses import diffusion_loss  # noqa: E402
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL  # noqa: E402
from fgdm_tpu_torch.models.clip import CLIPTextEncoder  # noqa: E402
from fgdm_tpu_torch.models.unet import UNetModel  # noqa: E402
from fgdm_tpu_torch.train import lr_schedules as tlr  # noqa: E402
from fgdm_tpu_torch.train import state as tstate  # noqa: E402
from fgdm_tpu_torch.train.train_step import (make_eval_step,  # noqa: E402
                                             make_train_step)

torch.set_num_threads(2)

UNET_TINY = dict(model_channels=32, num_heads=4, context_dim=64,
                 channel_mult=(1, 2), attention_resolutions=(1, 2),
                 num_res_blocks=1)
VAE_TINY = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1,
                resolution=64, z_channels=4, embed_dim=4)
CLIP_TINY = dict(vocab_size=128, embed_dim=64, num_layers=2, num_heads=4)
SCHED = dict(linear_start=0.00085, linear_end=0.0120)
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3


def perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape)
        .astype(np.float32), params)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2))))


def loaded(module, sd):
    module.load_state_dict(sd, strict=True)
    return module


@pytest.fixture(scope="module")
def tiny():
    """The tiny JAX pipeline and the port's on the same weights."""
    unet_def = JUNetModel(**UNET_TINY, dtype=jnp.float32)
    vae_def = JAutoencoderKL(**VAE_TINY, dtype=jnp.float32)
    clip_def = JCLIPTextEncoder(**CLIP_TINY)
    unet_p = perturbed(unet_def.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64))), 20)
    vae_p = perturbed(vae_def.init(jax.random.PRNGKey(1),
                                   jnp.zeros((1, 64, 64, 3)),
                                   sample_posterior=False), 21)
    clip_p = perturbed(clip_def.init(jax.random.PRNGKey(2),
                                     jnp.zeros((1, 77), jnp.int32)), 22)
    jld = JLatentDiffusion(
        unet_def=unet_def, vae_def=vae_def, clip_def=clip_def,
        unet_params=unet_p, vae_params=vae_p, clip_params=clip_p,
        schedule=jsch.DiffusionSchedule.create(1000, "linear", **SCHED))

    def port(schedule=None):
        return LatentDiffusion(
            loaded(UNetModel(**UNET_TINY, dtype=torch.float32, device="cpu"),
                   convert.unet_state_dict(unet_p)),
            loaded(AutoencoderKL(**VAE_TINY, dtype=torch.float32,
                                 device="cpu"),
                   convert.vae_state_dict(vae_p)).requires_grad_(False),
            schedule or DiffusionSchedule.create(1000, "linear", **SCHED),
            clip=loaded(CLIPTextEncoder(**CLIP_TINY, device="cpu"),
                        convert.clip_state_dict(clip_p)).requires_grad_(False))

    rng = np.random.default_rng(23)
    batch = dict(image=(rng.standard_normal((4, 64, 64, 3)) * 0.5)
                 .clip(-1, 1).astype(np.float32),
                 input_ids=rng.integers(0, 128, (4, 77)).astype(np.int32))
    return dict(jld=jld, port=port, batch=batch)


def jax_draws(key, b, latent_shape):
    """t, noise and posterior eps exactly as the JAX train step draws them
    from ``key``."""
    rng_enc, rng_loss = jax.random.split(key)
    rng_t, rng_noise = jax.random.split(rng_loss)
    t = jax.random.randint(rng_t, (b,), 0, 1000)
    noise = jax.random.normal(rng_noise, latent_shape, jnp.float32)
    eps = jax.random.normal(rng_enc, latent_shape, jnp.float32)
    return np.array(t), np.array(noise), np.array(eps)


def port_batch(batch):
    return {"image": nchw(batch["image"]),
            "input_ids": torch.from_numpy(batch["input_ids"]).long()}


# --- schedule and loss -----------------------------------------------------

@pytest.mark.parametrize("param", ["eps", "x0", "v"])
def test_schedule_training_tables_match_jax(param):
    js = jsch.DiffusionSchedule.create(1000, "linear", v_posterior=0.1,
                                       parameterization=param, **SCHED)
    ts = DiffusionSchedule.create(1000, "linear", v_posterior=0.1,
                                  parameterization=param, **SCHED)
    np.testing.assert_allclose(ts.lvlb_weights.numpy(),
                               np.asarray(js.lvlb_weights), rtol=1e-6)
    rng = np.random.default_rng(24)
    x = rng.standard_normal((3, 4, 5, 5)).astype(np.float32)
    n = rng.standard_normal((3, 4, 5, 5)).astype(np.float32)
    t = np.array([0, 417, 999])
    xt, nt, tt = (torch.from_numpy(a) for a in (x, n, t))
    for port, ref in (
            (ts.q_sample(xt, tt, nt), js.q_sample(x, t, n)),
            (ts.get_v(xt, nt, tt), js.get_v(x, n, t)),
            (ts.predict_start_from_v(xt, tt, nt),
             js.predict_start_from_v(x, t, n))):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("param", ["eps", "x0", "v"])
def test_diffusion_loss_matches_jax(tiny, param):
    sched_kw = dict(parameterization=param, **SCHED)
    jld = tiny["jld"].replace(
        schedule=jsch.DiffusionSchedule.create(1000, "linear", **sched_kw))
    ld = tiny["port"](DiffusionSchedule.create(1000, "linear", **sched_kw))
    rng = np.random.default_rng(25)
    x0 = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    key = jax.random.PRNGKey(26)
    loss, ld_j = j_diffusion_loss(jld, key, jnp.asarray(x0),
                                  {"c_crossattn": jnp.asarray(ctx)},
                                  parameterization=param,
                                  l_simple_weight=0.7,
                                  original_elbo_weight=0.3)
    rng_t, rng_noise = jax.random.split(key)
    t = np.array(jax.random.randint(rng_t, (2,), 0, 1000))
    noise = np.array(jax.random.normal(rng_noise, x0.shape, jnp.float32))
    with torch.no_grad():
        tloss, ld_t = diffusion_loss(
            ld, nchw(x0), {"c_crossattn": torch.from_numpy(ctx)},
            parameterization=param, l_simple_weight=0.7,
            original_elbo_weight=0.3, t=torch.from_numpy(t).long(),
            noise=nchw(noise))
    assert set(ld_t) == set(ld_j) == {"loss", "loss_simple", "loss_vlb"}
    for k in ld_j:
        np.testing.assert_allclose(float(ld_t[k]), float(ld_j[k]),
                                   rtol=LOSS_RTOL)
    assert float(tloss) == float(ld_t["loss"])


def test_distill_and_condition_raise(tiny):
    """The distillation step is ported (``tests/test_torch_distill.py``);
    condition-target synthesis still raises."""
    ld = tiny["port"]()
    assert callable(make_train_step(ld, distill=True))
    with pytest.raises(NotImplementedError, match="item 14"):
        make_train_step(ld, condition=object())


# --- the train step --------------------------------------------------------

def _jax_grads(state_before, state_after):
    """The JAX step's gradients from an SGD(1.0) step: p - (p - g)."""
    flat = {k: np.asarray(state_before.params[k])
            - np.asarray(state_after.params[k]) for k in state_before.params}
    return convert.unet_state_dict(traverse_util.unflatten_dict(
        flat, sep="/"))


def _capture_grads(state):
    grads = {}
    step = state.optimizer.step

    def capturing_step():
        grads.update({k: p.grad.detach().clone()
                      for k, p in state.params.items()})
        return step()

    state.optimizer.step = capturing_step
    return grads


@pytest.fixture(scope="module")
def one_step(tiny):
    """One JAX ``make_train_step`` step (SGD(1.0), so the update is the
    gradient) and the port's step on the same weights, batch and draws."""
    jld, batch = tiny["jld"], tiny["batch"]
    jstate_ = jstate.TrainState.create(jld.unet_params, optax.sgd(1.0),
                                       trainable_filter=jstate.adapter_filter(),
                                       use_ema=True)
    before = jax.tree.map(np.asarray, jstate_)
    key = jax.random.PRNGKey(27)
    jstate2, jmetrics = j_make_train_step(jld)(
        jstate_, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    jgrads = _jax_grads(before, jstate2)

    ld = tiny["port"]()
    state = tstate.TrainState.create(ld.unet, tstate.make_adamw(1e-3),
                                     trainable_filter=tstate.adapter_filter(),
                                     use_ema=True)
    frozen_before = {k: p.detach().clone() for k, p in state.frozen.items()}
    params_before = {k: p.detach().clone() for k, p in state.params.items()}
    grads = _capture_grads(state)
    t, noise, eps = jax_draws(key, 4, (4, 8, 8, 4))
    gen = torch.Generator().manual_seed(0)
    state, metrics = make_train_step(ld)(
        state, port_batch(batch), gen, t=torch.from_numpy(t).long(),
        noise=nchw(noise), posterior_eps=nchw(eps))
    return dict(jmetrics=jmetrics, jgrads=jgrads, jstate=jstate2,
                state=state, metrics=metrics, grads=grads,
                frozen_before=frozen_before, params_before=params_before)


@pytest.mark.parametrize("key", ["loss", "loss_simple", "loss_vlb",
                                 "grad_norm"])
def test_train_step_metrics_match_jax(one_step, key):
    np.testing.assert_allclose(float(one_step["metrics"][key]),
                               float(one_step["jmetrics"][key]),
                               rtol=LOSS_RTOL)


def test_train_step_adapter_grads_match_jax(one_step):
    grads, jgrads = one_step["grads"], one_step["jgrads"]
    assert set(grads) == set(jgrads) and grads
    assert all("adapter" in k for k in grads)
    scale = max(np.abs(g).max() for g in map(np.asarray, jgrads.values()))
    assert scale > 0
    err = max(np.abs(grads[k].numpy() - jgrads[k].numpy()).max()
              for k in grads)
    assert err <= GRAD_TOL * scale, (err, scale)


def test_train_step_trains_only_the_adapter(one_step):
    state = one_step["state"]
    assert state.step == 1 and state.ema.num_updates == 1
    assert one_step["jstate"].ema.num_updates == 1
    assert all(not p.requires_grad and p.grad is None
               for p in state.frozen.values())
    for k, p in state.frozen.items():
        assert torch.equal(p, one_step["frozen_before"][k]), k
    moved = max((p - one_step["params_before"][k]).abs().max().item()
                for k, p in state.params.items())
    assert moved > 0
    # the EMA shadow took the warmup decay's first step toward the params
    k0 = next(iter(state.params))
    want = one_step["params_before"][k0].lerp(state.params[k0], 1 - 2 / 11)
    torch.testing.assert_close(state.ema.shadow[k0], want)
    full = state.ema_full_params()
    assert set(full) == set(dict(state.model.named_parameters()))
    assert all(full[k] is s for k, s in state.ema.shadow.items())
    assert all(torch.equal(full[k], p) for k, p in state.frozen.items())


def test_loss_falls_when_everything_trains(tiny):
    """As ``tests/test_train.py:87-98``: all parameters trainable, the same
    batch and draws every step."""
    ld = tiny["port"]()
    state = tstate.TrainState.create(ld.unet, tstate.make_adamw(1e-2))
    step = make_train_step(ld)
    batch = port_batch(tiny["batch"])
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch, torch.Generator().manual_seed(0))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_eval_step_reports_plain_and_ema(tiny):
    ld = tiny["port"]()
    state = tstate.TrainState.create(ld.unet, tstate.make_adamw(1e-3),
                                     trainable_filter=tstate.adapter_filter(),
                                     use_ema=True)
    ev = make_eval_step(ld)
    batch = port_batch(tiny["batch"])
    m = ev(state, batch, torch.Generator().manual_seed(3))
    assert {"val/loss_simple", "val/loss_simple_ema"} <= set(m)
    # a fresh shadow equals the weights, and both passes draw alike
    assert float(m["val/loss"]) == float(m["val/loss_ema"])
    with torch.no_grad():
        for k, s in state.ema.shadow.items():
            s.add_(0.05)
    before = {k: p.clone() for k, p in state.params.items()}
    m2 = ev(state, batch, torch.Generator().manual_seed(3))
    assert float(m2["val/loss"]) == float(m["val/loss"])
    assert float(m2["val/loss_ema"]) != float(m["val/loss_ema"])
    assert all(torch.equal(p, before[k]) for k, p in state.params.items())


# --- optimizer, EMA, schedules ---------------------------------------------

ADAMW_CASES = {
    "plain": dict(),
    "clip": dict(grad_clip=0.5),
    "accumulate": dict(accumulate_steps=2),
    "schedule_clip_accumulate": dict(
        schedule=(4, 0.1), grad_clip=1.0, accumulate_steps=2),
}


@pytest.mark.parametrize("case", list(ADAMW_CASES))
def test_adamw_matches_optax(case):
    """``make_adamw`` against the JAX package's (optax) over the same
    gradients; the large gradient steps exercise the clip."""
    kw = dict(ADAMW_CASES[case])
    sched = kw.pop("schedule", None)
    rng = np.random.default_rng(28)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (0.1, 3.0, 0.2, 2.0)]
    jtx = jstate.make_adamw(
        1e-2, schedule_fn=jlr.lambda_linear(*sched) if sched else None, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = jtx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = tstate.make_adamw(
        1e-2, schedule_fn=tlr.lambda_linear(*sched) if sched else None,
        **kw).init(tp)
    for g in grads:
        upd, jopt = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                               jopt, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6)


def test_global_norm_clip_is_optax_rule():
    """|g| >= c scales by c/|g| exactly; |g| < c passes g unchanged."""
    p = torch.nn.Parameter(torch.zeros(2))
    opt = tstate.make_adamw(1.0, grad_clip=5.0, weight_decay=0.0).init(
        {"p": p})
    seen = []
    opt.inner.step = lambda: seen.append(p.grad.clone())
    for g in ([3.0, 4.0], [6.0, 8.0], [0.3, 0.4]):
        p.grad = torch.tensor(g)
        opt.step()
    torch.testing.assert_close(torch.stack(seen), torch.tensor(
        [[3.0, 4.0], [3.0, 4.0], [0.3, 0.4]]), rtol=0, atol=1e-7)


def test_ema_matches_jax():
    rng = np.random.default_rng(29)
    seq = [rng.standard_normal(5).astype(np.float32) for _ in range(4)]
    jema = jstate.EmaState.create({"w": jnp.asarray(seq[0])}, decay=0.99)
    tema = tstate.EmaState.create({"w": torch.from_numpy(seq[0].copy())},
                                  decay=0.99)
    for p in seq[1:]:
        jema = jema.update({"w": jnp.asarray(p)})
        tema.update({"w": torch.from_numpy(p)})
        np.testing.assert_allclose(tema.shadow["w"].numpy(),
                                   np.asarray(jema.shadow["w"]),
                                   rtol=1e-6, atol=1e-7)
    assert tema.num_updates == int(jema.num_updates) == 3


@pytest.mark.parametrize("name,args", [
    ("lambda_linear", (100, 0.0, 1.0, 1.0)),
    ("lambda_linear", (10, 1e-5, 1.0, 0.5, 1000.0)),
    ("lambda_warmup_cosine", (10, 0.01, 1.0, 0.1, 200.0)),
])
def test_lr_schedules_match_jax(name, args):
    jf, tf = getattr(jlr, name)(*args), getattr(tlr, name)(*args)
    for step in (0, 1, 5, 9, 10, 11, 50, 100, 199, 200, 500, 100000):
        np.testing.assert_allclose(tf(step), float(jf(step)), rtol=1e-6,
                                   atol=1e-9)


def test_scaled_lr_matches_jax():
    for kw in (dict(batch_size=8, n_devices=4, accumulate_grad_batches=2),
               dict(batch_size=8, scale_lr=False)):
        assert tlr.scaled_lr(1e-5, **kw) == jlr.scaled_lr(1e-5, **kw)


def test_randomize_zero_heads_is_seeded_by_name():
    a = UNetModel(**UNET_TINY, dtype=torch.float32, device="cpu")
    b = UNetModel(**UNET_TINY, dtype=torch.float32, device="cpu")
    b.load_state_dict(a.state_dict())
    zero = [k for k, p in a.named_parameters() if p.dim() >= 2
            and not p.any()]
    assert zero
    before = {k: p.clone() for k, p in a.named_parameters()}
    tstate.randomize_zero_heads(a)
    tstate.randomize_zero_heads(b)
    for (k, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb)
        if k in zero:
            assert 0 < pa.abs().max() < 0.2
        else:
            assert torch.equal(pa, before[k])
