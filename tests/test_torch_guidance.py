"""The port's attention-alignment guidance held against the JAX package,
on the CPU.

The step schedule, the alignment losses on seeded per-head maps, one
``guided_update`` at an early (thresholded), a late and an inactive step,
and ``ddim_sample(guidance_fn=)`` over 5 steps with CFG, on a tiny UNet
(``UNET_TINY``) at a 16x16 latent, whose level-0 maps have the 256 tokens
the losses read.  Weights: the port's seeded init with 0.02 N(0, 1) on
every parameter and the q and k projections x4 (at the plain init the maps
are so flat that the guidance moves x by ~1e-6), read into flax through the
JAX ingest; x_T and contexts from ``np.random.default_rng``.

Tolerances: losses 1e-4 relative (``LOSS_RTOL``); guided x and samples
max|d| <= 1e-3 x max|ref| (``GRAD_TOL``: gradients through a UNet forward
and backward).  A single guidance iteration is held tighter, its update
x_out - x_in within 1e-3 of the update's max|ref|; over more iterations
the two packages' float32 differences grow 3-10x an iteration (the cross
loss's x100 softmax), so those are held on x.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.core.schedules as jsch  # noqa: E402
import fgdm_tpu.sampling.guidance as jg  # noqa: E402
from fgdm_tpu.diffusion.latent_diffusion import (  # noqa: E402
    LatentDiffusion as JLatentDiffusion)
from fgdm_tpu.sampling.ddim import ddim_sample as j_ddim_sample  # noqa: E402
from fgdm_tpu_torch.core.schedules import (DDIMSchedule,  # noqa: E402
                                           DiffusionSchedule)
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion  # noqa: E402
from fgdm_tpu_torch.sampling import guidance as tg  # noqa: E402
from fgdm_tpu_torch.sampling.ddim import ddim_sample  # noqa: E402
from test_torch_capture import close, tiny_unet  # noqa: E402
from test_torch_train import GRAD_TOL, LOSS_RTOL, SCHED, nchw  # noqa: E402

torch.set_num_threads(2)


def near(port, ref, tol=GRAD_TOL, base=0.0):
    """max|port - ref| <= tol x max|ref - base|."""
    port, ref = port.detach().numpy(), np.asarray(ref)
    assert port.shape == ref.shape
    err, scale = np.abs(port - ref).max(), np.abs(ref - base).max()
    assert scale > 0 and err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def pipes():
    jdef, jp, unet = tiny_unet(70, qk_scale=4.0)
    jld = JLatentDiffusion(
        unet_def=jdef, vae_def=None, clip_def=None, unet_params=jp,
        schedule=jsch.DiffusionSchedule.create(1000, "linear", **SCHED))
    ld = LatentDiffusion(unet.requires_grad_(False), None,
                         DiffusionSchedule.create(1000, "linear", **SCHED))
    rng = np.random.default_rng(71)
    return dict(jld=jld, ld=ld,
                x=rng.standard_normal((4, 16, 16, 4)).astype(np.float32),
                ctx=rng.standard_normal((2, 77, 64)).astype(np.float32),
                uc=rng.standard_normal((2, 77, 64)).astype(np.float32))


def test_schedule_and_active_steps_match_jax():
    for i in range(60):
        scale, iters = jg._schedule(jnp.asarray(i))
        assert tg._schedule(i) == (float(scale), int(iters)), i
        assert tg._active(i) == bool(jg._active(jnp.asarray(i))), i


@pytest.mark.parametrize("num", [2, 3])
def test_alignment_losses_match_jax(num):
    """Per-head maps at 256 tokens (and some at 64, which the losses skip);
    ``num`` = 3 truncates the 8 rows of the self maps to 6."""
    rng = np.random.default_rng(72 + num)
    sa = {"a": rng.random((4, 2, 256, 256)), "b": rng.random((4, 2, 64, 64)),
          "c": rng.random((4, 2, 256, 256))}
    ca = {"a": rng.random((4, 2, 256, 77)), "b": rng.random((4, 2, 64, 77))}
    tsa, tca = ({k: torch.from_numpy(v.astype(np.float32))
                 for k, v in d.items()} for d in (sa, ca))
    jsa, jca = ({k: jnp.asarray(v, jnp.float32) for k, v in d.items()}
                for d in (sa, ca))
    for got, ref in (
            (tg.self_alignment_loss(tsa, num), jg.self_alignment_loss(jsa,
                                                                      num)),
            (tg.cross_alignment_loss(tca, num),
             jg.cross_alignment_loss(jca, num)),
            (tg.alignment_loss(tsa, tca, num, 3.0),
             jg.alignment_loss(jsa, jca, num, jnp.asarray(3.0)))):
        assert float(ref) > 0
        close(got, ref)
    assert float(tg.alignment_loss({}, {}, num, 3.0)) == 0.0


@pytest.mark.parametrize("index1,threshold,calls", [
    (3, 0.1, 1), (7, 0.03, 3), (10, 0.1, 2), (12, 0.1, 0)],
    ids=["early", "early-low-threshold", "late", "inactive"])
def test_guided_update_matches_jax(pipes, index1, threshold, calls,
                                   monkeypatch):
    """One guidance pass on the CFG-doubled batch of 4.  Before step 10 the
    loss threshold gates the iterations: at step 3 (up to 6) the first loss
    is below 0.1, so one runs; at step 7 (up to 3), with both packages'
    threshold lowered to 0.03, every loss is above it and all 3 run.  At 10
    two run unconditionally, at 12 none.  (Six iterations are not held:
    there a 1e-7 relative change of x alone moves the port's result by
    3e-3.)"""
    monkeypatch.setattr(jg, "LOSS_THRESHOLD", threshold)
    monkeypatch.setattr(tg, "LOSS_THRESHOLD", threshold)
    t = np.array([901, 901, 901, 901])
    ctx = np.concatenate([pipes["uc"], pipes["ctx"]])
    jfn = pipes["jld"].capture_fn()

    @jax.jit
    def run(x, i):
        return jg.guided_update(jfn, x, jnp.asarray(t),
                                {"c_crossattn": jnp.asarray(ctx)}, i, num=2)

    ref = run(jnp.asarray(pipes["x"]), jnp.asarray(index1))
    fn, n = pipes["ld"].capture_fn(), []

    def counted(*a):
        n.append(1)
        return fn(*a)

    with torch.no_grad():
        got = tg.guided_update(counted, nchw(pipes["x"]),
                               torch.from_numpy(t),
                               {"c_crossattn": torch.from_numpy(ctx)},
                               index1, num=2)
    assert len(n) == calls
    if index1 == 12:
        assert torch.equal(got, nchw(pipes["x"]))
        np.testing.assert_array_equal(np.asarray(ref), pipes["x"])
        return
    near(got.permute(0, 2, 3, 1), ref)
    if calls == 1:
        near(got.permute(0, 2, 3, 1), ref, base=pipes["x"])
    assert np.abs(np.asarray(ref) - pipes["x"]).max() > 1e-3


def test_ddim_sample_with_guidance_matches_jax(pipes):
    steps, shape = 5, (2, 16, 16, 4)
    xt = pipes["x"][:2]
    jld = pipes["jld"]

    @functools.partial(jax.jit, static_argnums=0)
    def run(guided, xt, c, u):
        sched = jsch.DDIMSchedule.create(jld.schedule, steps)
        return j_ddim_sample(
            jld.denoise_fn(), jax.random.PRNGKey(0), shape, sched,
            {"c_crossattn": c}, {"c_crossattn": u}, cfg_scale=3.0, x_T=xt,
            guidance_fn=jld.capture_fn() if guided else None)[0]

    args = tuple(jnp.asarray(pipes[k]) for k in ("ctx", "uc"))
    ref = run(True, jnp.asarray(xt), *args)
    ld = pipes["ld"]
    cond, uncond = ({"c_crossattn": torch.from_numpy(pipes[k])}
                    for k in ("ctx", "uc"))
    got = ddim_sample(ld.denoise_fn(), (2, 4, 16, 16),
                      DDIMSchedule.create(ld.schedule, steps), cond, uncond,
                      cfg_scale=3.0, x_T=nchw(xt),
                      guidance_fn=ld.capture_fn())
    near(got.permute(0, 2, 3, 1), ref)
    plain = ddim_sample(ld.denoise_fn(), (2, 4, 16, 16),
                        DDIMSchedule.create(ld.schedule, steps), cond, uncond,
                        cfg_scale=3.0, x_T=nchw(xt))
    assert (got - plain).abs().max() > 1e-3
    assert torch.isfinite(got).all() and not got.is_inference()


def test_conv3x3_backward_gives_only_the_gradients_asked_for():
    """The guidance differentiates the UNet for x alone: ``Conv3x3``'s
    backward returns dx as the full backward does and no weight or bias
    gradient for a frozen conv."""
    from fgdm_tpu_torch.kernels import conv as tc

    rng = np.random.default_rng(74)
    x, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((1, 8, 6, 6), (4, 8, 3, 3)))
    b = torch.zeros(4)
    g = torch.from_numpy(rng.standard_normal((1, 4, 6, 6)).astype(np.float32))
    xs = x.clone().requires_grad_()
    ws, bs = w.clone().requires_grad_(), b.clone().requires_grad_()
    full = torch.autograd.grad(tc.Conv3x3.apply(xs, ws, bs), (xs, ws, bs), g)
    xo = x.clone().requires_grad_()
    tc.Conv3x3.apply(xo, w, b).backward(g)
    assert torch.equal(xo.grad, full[0])
    assert w.grad is None and b.grad is None
