"""The training CLI's pieces held against the JAX package, on the CPU.

``MetricsWriter``, ``ImageLogger``, ``log_txt_as_img`` and
``denoise_row_grid``; ``ddim_sample``'s ``log_every_t``, inpainting mask and
``ucg_schedule``; ``log_images`` on a tiny pipeline; ``calibrate_scale_by_std``;
the UNet's ``use_checkpoint``; the ``CheckpointManager``'s retention against
orbax's; and a train state's round trip through a checkpoint file.

The tiny pipeline: ``tests/test_torch_capture.py``'s UNet (``UNET_TINY``,
8x8 latents), the port's seeded inits of ``VAE_TINY`` and ``CLIP_TINY`` read
into flax through the JAX ingest, float32.  Torch cannot draw
``jax.random``'s bits: the tests rebuild JAX's draws from its key splits
(``log_images``: ``rng, drng = split(rng)`` for the diffusion row, ``rng,
srng = split(rng)`` for the samples, ``rng, r_in, r_out = split(rng, 3)``
for the masks; inside ``ddim_sample`` ``rng, init = split(rng)`` for x_T,
``split(rng, S)`` for the steps and the first half of each step's split for
the mask noise) and inject them.

Tolerances: samplers and images 1e-5 x max(1, max|ref|) (``UNET_TOL``: the
same float32 sums in another order); uint8 grids within 1 (a value at a
rounding boundary of ``to_uint8``), in at most 0.5 % of the pixels;
``calibrate_scale_by_std`` 1e-5 relative; the checkpointed gradients, the
rendered text and the state round trip bit for bit.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.core.schedules as jsch  # noqa: E402
import fgdm_tpu.sampling.ddim as jddim  # noqa: E402
import fgdm_tpu.train.metrics as jmet  # noqa: E402
from fgdm_tpu.checkpoint import loader as jloader  # noqa: E402
from fgdm_tpu.checkpoint import torch_ingest as jti  # noqa: E402
from fgdm_tpu.checkpoint.orbax_io import (  # noqa: E402
    CheckpointManager as JCheckpointManager)
from fgdm_tpu.diffusion.latent_diffusion import (  # noqa: E402
    LatentDiffusion as JLatentDiffusion)
from fgdm_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL  # noqa: E402
from fgdm_tpu.models.clip import CLIPTextEncoder as JCLIPTextEncoder  # noqa: E402
from fgdm_tpu_torch import builders  # noqa: E402
from fgdm_tpu_torch.checkpoint import torch_ingest as ti  # noqa: E402
from fgdm_tpu_torch.checkpoint.state_io import CheckpointManager  # noqa: E402
from fgdm_tpu_torch.core import schedules as tsch  # noqa: E402
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion  # noqa: E402
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL  # noqa: E402
from fgdm_tpu_torch.models.clip import CLIPTextEncoder  # noqa: E402
from fgdm_tpu_torch.models.unet import UNetModel  # noqa: E402
from fgdm_tpu_torch.nn.attention import SpatialTransformer  # noqa: E402
from fgdm_tpu_torch.nn.blocks import ResBlock  # noqa: E402
from fgdm_tpu_torch.nn.layers import init_params_  # noqa: E402
from fgdm_tpu_torch.sampling import ddim as tddim  # noqa: E402
from fgdm_tpu_torch.train import metrics as tmet  # noqa: E402
from fgdm_tpu_torch.train import state as tstate  # noqa: E402
from test_torch_capture import tiny_unet  # noqa: E402
from test_torch_train import (CLIP_TINY, SCHED, UNET_TINY,  # noqa: E402
                              VAE_TINY, nchw)

torch.set_num_threads(2)

UNET_TOL = 1e-5


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def close(port, ref, tol=UNET_TOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port.astype(np.float64) - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def grids_close(port, ref):
    assert port.shape == ref.shape and port.dtype == ref.dtype == np.uint8
    d = np.abs(port.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= 5e-3, (d.max(), (d > 0).mean())


# --- writers and grids ---------------------------------------------------------

def test_metrics_writer_rows_match_jax(tmp_path):
    rows = []
    for mod, conv in ((tmet, torch.tensor), (jmet, jnp.asarray)):
        w = mod.MetricsWriter(str(tmp_path / mod.__name__))
        w.log(3, {"loss": conv(0.25), "grad_norm": conv(1.5), "name": "x"},
              prefix="train")
        w.log(4, {"val/loss": 2})
        w.close()
        rows.append([json.loads(line) for line in open(w.path)])
    for port, ref in zip(*rows):
        assert set(port) == set(ref)
        assert {k: v for k, v in port.items() if k != "time"} == \
            {k: v for k, v in ref.items() if k != "time"}


def _diagnostics():
    rng = np.random.default_rng(0)
    return {"inputs": rng.uniform(-1, 1, (10, 16, 12, 3)).astype(np.float32),
            "mask": rng.uniform(-1, 1, (3, 8, 8, 1)).astype(np.float32),
            "denoise_row": rng.integers(0, 256, (20, 30, 3), dtype=np.uint8),
            "diffusion_row": rng.uniform(-1, 1, (9, 7, 3)).astype(np.float32)}


def test_image_logger_writes_jax_names_and_pixels(tmp_path):
    from PIL import Image

    images = _diagnostics()
    port = tmet.ImageLogger(str(tmp_path / "port"), batch_frequency=5,
                            max_images=4)
    ref = jmet.ImageLogger(str(tmp_path / "jax"), batch_frequency=5,
                           max_images=4)
    assert [port.should_log(s) for s in range(11)] == \
        [ref.should_log(s) for s in range(11)]
    port.log(10, images)
    ref.log(10, images)
    names = sorted(os.listdir(port.dir))
    assert names == sorted(os.listdir(ref.dir)) == sorted(
        f"{k}_gs-000010.png" for k in images)
    for name in names:
        a = np.asarray(Image.open(os.path.join(port.dir, name)))
        b = np.asarray(Image.open(os.path.join(ref.dir, name)))
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_log_txt_as_img_matches_jax():
    caps = ["a dog", "a very long caption that wraps over several lines", ""]
    for wh in ((64, 48), (256, 32)):
        np.testing.assert_array_equal(tmet.log_txt_as_img(wh, caps),
                                      jmet.log_txt_as_img(wh, caps))


def test_denoise_row_grid_matches_jax():
    rng = np.random.default_rng(1)
    frames = rng.uniform(-1.2, 1.2, (3, 2, 8, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(tmet.denoise_row_grid(frames),
                                  jmet.denoise_row_grid(frames))
    lat = rng.standard_normal((4, 2, 8, 8, 4)).astype(np.float32)
    calls = []

    def port_decode(z):   # NCHW latents -> NCHW images, one call
        calls.append(z.shape)
        return torch.tanh(z[:, :3].repeat_interleave(2, 2)
                          .repeat_interleave(2, 3))

    def jax_decode(z):
        return jnp.tanh(jnp.repeat(jnp.repeat(z[..., :3], 2, 1), 2, 2))

    got = tmet.denoise_row_grid(torch.from_numpy(
        np.moveaxis(lat, -1, 2).copy()), decode_fn=port_decode)
    np.testing.assert_array_equal(got, jmet.denoise_row_grid(
        lat, decode_fn=jax_decode))
    assert calls == [(8, 4, 8, 8)]


# --- the sampler's new arguments ----------------------------------------------------

@pytest.fixture(scope="module")
def unet_pair():
    return tiny_unet(60)


def _jax_mask_noise(key, steps, shape):
    """The mask noise JAX's ``ddim_sample`` draws at each step from
    ``key``: ``rng, init = split(key)``, ``split(rng, S)``, the first half
    of each step key's split."""
    rng, _ = jax.random.split(key)
    return np.stack([np.asarray(jax.random.normal(
        jax.random.split(k)[0], shape, jnp.float32))
        for k in jax.random.split(rng, steps)])


@pytest.mark.parametrize("case", ["log_every", "inpaint", "ucg"])
def test_ddim_sample_new_arguments_match_jax(unet_pair, case):
    jdef, jp, unet = unet_pair
    kw = dict(timesteps=1000, beta_schedule="linear", **SCHED)
    jsched, tsched = (jsch.DiffusionSchedule.create(**kw),
                      tsch.DiffusionSchedule.create(**kw))
    jd, td = (jsch.DDIMSchedule.create(jsched, 5),
              tsch.DDIMSchedule.create(tsched, 5))
    rng = np.random.default_rng(61)
    x_T, x0 = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
               for _ in range(2))
    ctx, uc = (rng.standard_normal((2, 77, 64)).astype(np.float32)
               for _ in range(2))

    def jfn(x, t, c):
        return jdef.apply(jp, x, t, context=c["c_crossattn"])

    def tfn(x, t, c):
        return unet(x, t, context=c["c_crossattn"])

    jkw, tkw = {}, {}
    if case == "log_every":
        jkw = tkw = dict(log_every_t=2)
    elif case == "ucg":
        jkw = dict(ucg_schedule=jnp.asarray([7.5, 5.0, 3.0, 1.5, 1.0]))
        tkw = dict(ucg_schedule=[7.5, 5.0, 3.0, 1.5, 1.0])
    else:
        mask = np.ones((2, 8, 8, 1), np.float32)
        mask[:, 2:6, 2:6] = 0.0
        key = jax.random.PRNGKey(62)
        noise = _jax_mask_noise(key, 5, (2, 8, 8, 4))
        jkw = dict(mask=jnp.asarray(mask), x0=jnp.asarray(x0),
                   schedule=jsched)
        tkw = dict(mask=nchw(mask), x0=nchw(x0), schedule=tsched,
                   mask_noise=torch.from_numpy(np.moveaxis(noise, -1, 2)
                                               .copy()))
    ref, jinter = jddim.ddim_sample(
        jfn, jax.random.PRNGKey(62), (2, 8, 8, 4), jd,
        {"c_crossattn": jnp.asarray(ctx)}, {"c_crossattn": jnp.asarray(uc)},
        cfg_scale=7.5, x_T=jnp.asarray(x_T), **jkw)
    with torch.no_grad():
        got = tddim.ddim_sample(
            tfn, (2, 4, 8, 8), td, {"c_crossattn": torch.from_numpy(ctx)},
            {"c_crossattn": torch.from_numpy(uc)}, cfg_scale=7.5,
            x_T=nchw(x_T), **tkw)
    if case == "log_every":
        got, inter = got
        assert set(inter) == set(jinter) == {"x_inter", "pred_x0"}
        for k in inter:
            assert inter[k].shape == (3, 2, 4, 8, 8)
            close(np.moveaxis(inter[k].numpy(), 2, -1), jinter[k])
    close(nhwc(got), ref)


def test_ddim_sample_draws_mask_noise_from_the_generator(unet_pair):
    """Without ``mask_noise`` each step's mask noise comes from the
    generator, before its eta noise; a mask of ones keeps x0's q_sample."""
    _, _, unet = unet_pair
    sched = tsch.DiffusionSchedule.create(1000, "linear", **SCHED)
    dd = tsch.DDIMSchedule.create(sched, 5)
    x0 = torch.randn(1, 4, 8, 8, generator=torch.Generator().manual_seed(1))
    ctx = {"c_crossattn": torch.zeros(1, 77, 64)}

    def run(**kw):
        return tddim.ddim_sample(
            lambda x, t, c: unet(x, t, context=c["c_crossattn"]),
            (1, 4, 8, 8), dd, ctx, None, x0=x0, schedule=sched,
            mask=torch.ones(1, 1, 8, 8), **kw)

    gen = torch.Generator().manual_seed(5)
    a = run(generator=torch.Generator().manual_seed(5))
    x_T = torch.randn(1, 4, 8, 8, generator=gen)
    noise = torch.stack([torch.randn(1, 4, 8, 8, generator=gen)
                         for _ in range(dd.num_steps)])
    b = run(x_T=x_T, mask_noise=lambda i: noise[i])
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="x0"):
        tddim.ddim_sample(None, (1, 4, 8, 8), dd, ctx, mask=x0)


# --- log_images and scale_by_std on a tiny pipeline ------------------------------

@pytest.fixture(scope="module")
def pipes(unet_pair):
    jdef, jp, unet = unet_pair
    vae = init_params_(AutoencoderKL(**VAE_TINY, dtype=torch.float32,
                                     device="cpu"),
                       torch.Generator().manual_seed(63), 0.02).eval()
    clip = init_params_(CLIPTextEncoder(**CLIP_TINY, dtype=torch.float32,
                                        device="cpu"),
                        torch.Generator().manual_seed(64), 0.02).eval()
    jvae = JAutoencoderKL(**VAE_TINY, dtype=jnp.float32)
    vae_p, m1, u1 = jti.ingest_vae(
        {ti.VAE_PREFIX + k: v.numpy() for k, v in vae.state_dict().items()},
        expect=jloader._abstract_init(jvae, jnp.zeros((1, 64, 64, 3)),
                                      sample_posterior=False))
    jclip = JCLIPTextEncoder(**CLIP_TINY, dtype=jnp.float32)
    clip_p, m2, u2 = jti.ingest_clip(
        {ti.CLIP_PREFIX + k: v.numpy() for k, v in clip.state_dict().items()},
        expect=jloader._abstract_init(jclip, jnp.zeros((1, 77), jnp.int32)))
    assert m1 == m2 == u1 == u2 == []
    kw = dict(timesteps=1000, beta_schedule="linear", **SCHED)
    jld = JLatentDiffusion(
        unet_def=jdef, vae_def=jvae, clip_def=jclip, unet_params=jp,
        vae_params=vae_p, clip_params=clip_p,
        schedule=jsch.DiffusionSchedule.create(**kw))
    ld = LatentDiffusion(unet, vae, tsch.DiffusionSchedule.create(**kw),
                         clip=clip)
    rng = np.random.default_rng(65)
    batch = {"image": rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32),
             "input_ids": rng.integers(1, 128, (2, 77)).astype(np.int32),
             "captions": ["a red thing", "two blue things"]}
    return jld, ld, batch


def _log_images_draws(key, z_shape, steps):
    """JAX's draws in ``log_images(..., rng=key)``, NHWC."""
    def normal(k):
        return np.asarray(jax.random.normal(k, z_shape, jnp.float32))

    rng, drng = jax.random.split(key)
    draws = {"diffusion_noise": normal(drng)}
    rng, srng = jax.random.split(rng)
    draws["x_T"] = normal(jax.random.split(srng)[1])
    rng, r_in, r_out = jax.random.split(rng, 3)
    for name, k in (("inpaint", r_in), ("outpaint", r_out)):
        draws[f"{name}_x_T"] = normal(jax.random.split(k)[1])
        draws[f"{name}_mask_noise"] = _jax_mask_noise(k, steps, z_shape)
    return draws


def test_log_images_matches_jax(pipes):
    jld, ld, batch = pipes
    flags = dict(n=2, ddim_steps=4, cfg_scale=5.0, inpaint=True,
                 plot_denoise_rows=True, plot_progressive_rows=True,
                 plot_diffusion_rows=True, n_diffusion_steps=3)
    key = jax.random.PRNGKey(66)
    ref = jmet.log_images(jld, batch, key, **flags)
    draws = {k: torch.from_numpy(np.moveaxis(v, -1, -3).copy())
             for k, v in _log_images_draws(key, (2, 8, 8, 4), 4).items()}
    got = tmet.log_images(ld, {"image": nchw(batch["image"]),
                               "input_ids": torch.from_numpy(
                                   batch["input_ids"]).long(),
                               "captions": batch["captions"]},
                          draws=draws, **flags)
    assert list(got) == list(ref) == [
        "inputs", "reconstruction", "conditioning", "diffusion_row",
        "samples", "denoise_row", "progressive_row", "samples_inpainting",
        "mask", "samples_outpainting"]
    for k in ref:
        if k.endswith("_row"):
            grids_close(got[k], np.asarray(ref[k]))
        else:
            close(got[k], ref[k])


def test_log_images_samples_with_given_params_and_restores(pipes):
    _, ld, batch = pipes
    pb = {"image": nchw(batch["image"]),
          "input_ids": torch.from_numpy(batch["input_ids"]).long()}
    before = {k: p.clone() for k, p in ld.unet.named_parameters()}
    shadow = {k: p * 0.5 for k, p in before.items() if "adapter" in k}
    kw = dict(n=1, ddim_steps=2, draws={
        "x_T": torch.ones(1, 4, 8, 8)})
    plain = tmet.log_images(ld, pb, **kw)
    ema = tmet.log_images(ld, pb, params=shadow, **kw)
    assert set(plain) == {"inputs", "reconstruction", "samples"}
    assert not np.array_equal(plain["samples"], ema["samples"])
    for k, p in ld.unet.named_parameters():
        assert torch.equal(p, before[k]), k
    with torch.no_grad():
        for k, v in shadow.items():
            dict(ld.unet.named_parameters())[k].copy_(v)
    swapped = tmet.log_images(ld, pb, **kw)
    with torch.no_grad():
        for k, p in ld.unet.named_parameters():
            p.copy_(before[k])
    np.testing.assert_array_equal(swapped["samples"], ema["samples"])


def test_calibrate_scale_by_std_matches_jax(pipes):
    jld, ld, batch = pipes
    key = jax.random.PRNGKey(67)
    ref = jld.calibrate_scale_by_std(jnp.asarray(batch["image"]), key)
    eps = np.asarray(jax.random.normal(key, (2, 8, 8, 4), jnp.float32))
    got = ld.calibrate_scale_by_std(nchw(batch["image"]), eps=nchw(eps))
    assert got.unet is ld.unet and got.vae is ld.vae
    assert ld.scale_factor == 0.18215
    np.testing.assert_allclose(got.scale_factor, ref.scale_factor,
                               rtol=1e-5)
    mode = ld.calibrate_scale_by_std(nchw(batch["image"]))
    np.testing.assert_allclose(
        mode.scale_factor,
        jld.calibrate_scale_by_std(jnp.asarray(batch["image"])).scale_factor,
        rtol=1e-5)


# --- activation checkpointing -----------------------------------------------------

def _twins():
    a = UNetModel(**UNET_TINY, dtype=torch.float32, device="cpu")
    init_params_(a, torch.Generator().manual_seed(70), 0.02)
    b = UNetModel(**UNET_TINY, dtype=torch.float32, remat=True, device="cpu")
    b.load_state_dict(a.state_dict())
    return a, b


def _count_calls(monkeypatch):
    """Calls of every ResBlock's and SpatialTransformer's forward (module
    hooks do not see the checkpoint's recompute; the methods do)."""
    counts = {"res": 0, "st": 0}
    for kind, cls in (("res", ResBlock), ("st", SpatialTransformer)):
        def counted(self, *a, _f=cls.forward, _k=kind, **kw):
            counts[_k] += 1
            return _f(self, *a, **kw)
        monkeypatch.setattr(cls, "forward", counted)
    return counts


@pytest.mark.parametrize("capture", [False, "probs"])
def test_use_checkpoint_gradients_equal_plain(capture, monkeypatch):
    """Checkpointing recomputes every ResBlock in the backward, and every
    SpatialTransformer that does not capture (JAX's remat rule); the
    gradients are the plain ones bit for bit."""
    plain, ckpt = _twins()
    rng = np.random.default_rng(71)
    x = torch.from_numpy(rng.standard_normal((2, 4, 8, 8)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 77, 64)).astype(
        np.float32))
    t = torch.tensor([10, 700])
    grads = []
    calls = _count_calls(monkeypatch)
    for unet in (plain, ckpt):
        calls.update(res=0, st=0)
        out = unet(x, t, context=ctx, capture=capture)
        loss = (out[0] if capture else out).square().mean()
        if capture:
            loss = loss + sum(m.float().mean() for d in out[1:]
                              for m in d.values())
        forward = dict(calls)
        loss.backward()
        grads.append({k: p.grad for k, p in unet.named_parameters()})
        recomputed = {k: calls[k] - forward[k] for k in calls}
        if unet is plain:
            assert recomputed == {"res": 0, "st": 0}
        else:
            assert recomputed["res"] == forward["res"] > 0
            assert recomputed["st"] == (0 if capture else forward["st"])
    for k, g in grads[0].items():
        assert torch.equal(g, grads[1][k]), k
    with torch.no_grad():    # no recompute where autograd records nothing
        calls.update(res=0, st=0)
        ckpt(x, t, context=ctx)
        assert calls["res"] == sum(isinstance(m, ResBlock)
                                   for m in ckpt.modules())


@pytest.mark.parametrize("kernel", ["flash", "flash_no_lse", "gn", "conv"])
def test_kernel_functions_backward_under_checkpointing(kernel, monkeypatch):
    """Each kernel's ``autograd.Function`` (its plain version here, on CPU
    tensors) runs its backward inside a checkpointed region as outside:
    a backward that reads ``ctx.saved_tensors`` twice fails under
    ``torch.utils.checkpoint``, whose hooks unpack once."""
    from torch.utils.checkpoint import checkpoint

    from fgdm_tpu_torch.kernels import attention as katt
    from fgdm_tpu_torch.kernels.conv import Conv3x3
    from fgdm_tpu_torch.kernels.groupnorm import GroupNormSiLU

    g = torch.Generator().manual_seed(72)
    if kernel.startswith("flash"):
        monkeypatch.setattr(katt, "_FLASH_BWD", kernel == "flash")
        args = [torch.randn(1, 2, 64, 40, generator=g) for _ in range(3)]

        def fn(*a):
            return katt.FlashAttention.apply(*a, 40 ** -0.5).square()
    elif kernel == "gn":
        args = [torch.randn(2, 64, 4, 4, generator=g),
                torch.randn(64, generator=g), torch.randn(64, generator=g)]

        def fn(*a):
            return GroupNormSiLU.apply(*a, 32, 1e-5, True).square()
    else:
        args = [torch.randn(1, 8, 6, 6, generator=g),
                torch.randn(4, 8, 3, 3, generator=g),
                torch.randn(4, generator=g)]

        def fn(*a):
            return Conv3x3.apply(*a).square()
    grads = []
    for remat in (False, True):
        leaves = [a.clone().requires_grad_() for a in args]
        out = (checkpoint(fn, *leaves, use_reentrant=False) if remat
               else fn(*leaves))
        out.sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_use_checkpoint_reaches_the_unet_from_the_config():
    assert builders.build_unet_from_config(
        use_checkpoint=True).kwargs["remat"] is True
    assert builders.build_unet_from_config().kwargs["remat"] is False
    spec = builders.build_latent_diffusion(
        unet_config={"params": {"use_checkpoint": True}})
    assert spec.unet_def.kwargs["remat"] and spec.use_ema
    tiny = dict(UNET_TINY, channel_mult=list(UNET_TINY["channel_mult"]),
                attention_resolutions=list(
                    UNET_TINY["attention_resolutions"]))
    assert builders.build_unet_from_config(
        use_checkpoint=True, dtype=torch.float32, **tiny).build("cpu").remat


@pytest.mark.parametrize("flags", [
    {}, {"use_depth": True}, {"use_depth": True, "use_normal": True},
    {"use_normal": True}, {"use_sketch": True},
    {"use_sketch": True, "use_hed": True},
    {"sketch_to_normal": True, "use_depth": True}])
def test_model_spec_knobs_match_jax(flags):
    from fgdm_tpu.builders import build_latent_diffusion as jbuild
    from fgdm_tpu.train.condition import condition_kind

    p = {"unet_config": {"params": {"model_channels": 32}}, **flags}
    spec, jspec = builders.build_latent_diffusion(**p), jbuild(**p)
    assert spec.condition_kind() == jspec.condition_kind() == \
        condition_kind(**flags)
    for field in ("image_size", "base_learning_rate", "use_ema",
                  "freeze_backbone", "apply_distill_loss",
                  "distill_every_n_step", "monitor", "scheduler_config",
                  "parameterization", "use_depth", "use_normal",
                  "use_sketch", "use_hed", "sketch_to_normal",
                  "img_factor_train", "scale_by_std"):
        assert getattr(spec, field) == getattr(jspec, field), field


# --- checkpoints of the train state --------------------------------------------------

SAVES = ([(s, False) for s in range(13)]
         + [(7, True), (10, True), (13, True), (3, True)]
         + [(s, False) for s in range(14, 22)] + [(21, True), (22, True)])


def test_checkpoint_manager_keeps_orbax_steps(tmp_path):
    """Interval 5, keep 3, forced saves (one of a step that exists, one of
    an earlier step) and repeated steps: the same answers and the same
    steps on disk after every save."""
    port = CheckpointManager(str(tmp_path / "port"), keep=3,
                             save_interval_steps=5)
    ref = JCheckpointManager(str(tmp_path / "jax"), keep=3,
                             save_interval_steps=5)
    for step, force in SAVES:
        a = port.save(step, {"x": torch.full((2,), float(step))},
                      force=force)
        b = ref.save(step, {"x": np.full((2,), float(step))}, force=force)
        ref.wait()
        assert a == b, (step, force)
        assert port.all_steps() == sorted(ref._mgr.all_steps()), step
        assert port.latest_step() == ref.latest_step()
    assert float(port.restore()["x"][0]) == 22.0
    assert float(port.restore(20)["x"][0]) == 20.0
    assert not [f for f in os.listdir(port.directory) if "tmp" in f]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def _trained_state(seed, steps, accumulate=2):
    unet = UNetModel(**UNET_TINY, dtype=torch.float32, device="cpu")
    init_params_(unet, torch.Generator().manual_seed(seed), 0.02)
    state = tstate.TrainState.create(
        unet, tstate.make_adamw(1e-3, schedule_fn=lambda s: 0.5 + s,
                                accumulate_steps=accumulate,
                                grad_clip=1.0),
        trainable_filter=tstate.adapter_filter(), use_ema=True)
    for i in range(steps):
        _step(state, i)
    return state


def _step(state, i):
    g = torch.Generator().manual_seed(100 + i)
    x = torch.randn(2, 4, 8, 8, generator=g)
    ctx = torch.randn(2, 77, 64, generator=g)
    state.model(x, torch.tensor([5, 900]), context=ctx).square().mean() \
        .backward()
    state.apply_gradients()


def _flat(state):
    tree = tstate.state_to_pytree(state)
    out = {"step": tree["step"]}
    for part in ("params", "frozen"):
        out.update({f"{part}/{k}": v for k, v in tree[part].items()})
    out.update({f"ema/{k}": v for k, v in tree["ema"]["shadow"].items()})
    out["ema/num_updates"] = tree["ema"]["num_updates"]
    opt = tree["opt_state"]
    for i, s in opt["inner"]["state"].items():
        out.update({f"opt/{i}/{k}": v for k, v in s.items()})
    out.update({f"acc/{i}": a for i, a in enumerate(opt["acc"])})
    out.update(count=opt["count"], mini_step=opt["mini_step"])
    return out


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


def test_train_state_round_trip_is_bit_exact(tmp_path):
    """Three steps (one update pending in the accumulation), saved,
    restored into a state of other weights, then one more step on each."""
    state = _trained_state(80, 3)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(3, tstate.state_to_pytree(state))
    fresh = _trained_state(81, 0)
    tstate.state_from_pytree(fresh, mgr.restore())
    assert fresh.step == 3 and fresh.optimizer.mini_step == 1
    _assert_same(fresh, state)
    _step(state, 3)
    _step(fresh, 3)
    _assert_same(fresh, state)
    no_frozen = tstate.state_to_pytree(state, include_frozen=False)
    assert "frozen" not in no_frozen and set(no_frozen["params"]) == set(
        state.params)
