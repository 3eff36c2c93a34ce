"""The port's schedules, DDIM sampler and text->seg->image chain held against
the JAX package, plus the port's own contracts.

The tiny chain uses the geometries of ``tests/test_golden_chain.py:38-43``
with 0.02 N(0, 1)-perturbed weights, float32 on the CPU, and a real resize
ratio (condition maps at 32^2, the image at 64^2).  Torch cannot reproduce
``jax.random`` bits, so JAX's x_T goes into both samplers (eta 0: DDIM is
deterministic after x_T).  The uint8 quantize between the factors can flip
one 1/255 step where the two frameworks' condition maps straddle a rounding
boundary, so the image factor is fed JAX's hint.

Tolerances: schedule tables exact to float32 (1e-7 relative); one DDIM step
1e-6; the chain's condition map and image 2e-3 (values in [0, 1] and
[-1, 1], five and four sampler steps of float32 arithmetic summed in
another order); the hint 1/255 + 1e-6 on at most 1 % of its pixels.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.core.schedules as jsch  # noqa: E402
import fgdm_tpu.sampling.chain as jchain  # noqa: E402
import fgdm_tpu.sampling.ddim as jddim  # noqa: E402
from fgdm_tpu.diffusion.control import ControlLDM as JControlLDM  # noqa: E402
from fgdm_tpu.diffusion.latent_diffusion import (  # noqa: E402
    LatentDiffusion as JLatentDiffusion)
from fgdm_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL  # noqa: E402
from fgdm_tpu.models.controlnet import ControlNet as JControlNet  # noqa: E402
from fgdm_tpu.models.unet import UNetModel as JUNetModel  # noqa: E402
import fgdm_tpu_torch  # noqa: E402
from fgdm_tpu_torch import builders, server  # noqa: E402
from fgdm_tpu_torch.checkpoint import convert  # noqa: E402
from fgdm_tpu_torch.core import schedules as tsch  # noqa: E402
from fgdm_tpu_torch.diffusion.control import ControlLDM  # noqa: E402
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion  # noqa: E402
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL  # noqa: E402
from fgdm_tpu_torch.models.clip import CLIPTextEncoder  # noqa: E402
from fgdm_tpu_torch.models.controlnet import ControlNet  # noqa: E402
from fgdm_tpu_torch.models.unet import UNetModel  # noqa: E402
from fgdm_tpu_torch.sampling import chain as tchain  # noqa: E402
from fgdm_tpu_torch.sampling import ddim as tddim  # noqa: E402
from fgdm_tpu_torch.serving import ChainEngine  # noqa: E402

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(model_channels=32, num_heads=4, context_dim=64,
            channel_mult=(1, 2), attention_resolutions=(1, 2),
            num_res_blocks=1)
VAE_TINY = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1, resolution=64,
                z_channels=4, embed_dim=4)
COND_HW, IMAGE_HW, F1_STEPS, F2_STEPS = (32, 32), (64, 64), 5, 4
CHAIN_TOL = 2e-3


def sd14_jax_schedule():
    return jsch.DiffusionSchedule.create(1000, "linear", linear_start=0.00085,
                                         linear_end=0.0120)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a, np.float32), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


# --- schedules and the DDIM step -------------------------------------------

@pytest.mark.parametrize("kind", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_beta_schedules(kind):
    np.testing.assert_array_equal(
        tsch.make_beta_schedule(kind, 1000, 0.00085, 0.012),
        jsch.make_beta_schedule(kind, 1000, 0.00085, 0.012))


def test_diffusion_schedule_matches_jax():
    j, t = sd14_jax_schedule(), builders.sd14_schedule()
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
                 "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod"):
        got = getattr(t, name)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(j, name)))


@pytest.mark.parametrize("steps,eta,disc", [(50, 0.0, "uniform"),
                                            (20, 0.0, "uniform"),
                                            (50, 0.5, "uniform"),
                                            (30, 1.0, "quad")])
def test_ddim_schedule_matches_jax(steps, eta, disc):
    j = jsch.DDIMSchedule.create(sd14_jax_schedule(), steps, eta, disc)
    t = tsch.DDIMSchedule.create(builders.sd14_schedule(), steps, eta, disc)
    assert t.num_steps == j.num_steps and t.eta == j.eta
    np.testing.assert_array_equal(t.timesteps.numpy(), np.asarray(j.timesteps))
    for name in ("alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=1e-7)


@pytest.mark.parametrize("with_noise", [False, True])
def test_ddim_step_matches_jax(with_noise):
    rng = np.random.default_rng(0)
    x, e, n = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
               for _ in range(3))
    js = jsch.DDIMSchedule.create(sd14_jax_schedule(), 20, eta=0.7)
    ts = tsch.DDIMSchedule.create(builders.sd14_schedule(), 20, eta=0.7)
    for index in (19, 7, 0):
        jx, jp = jddim.ddim_step(jnp.asarray(x), jnp.asarray(e), index, js,
                                 jnp.asarray(n) if with_noise else None)
        tx, tp = tddim.ddim_step(nchw(x), nchw(e), index, ts,
                                 nchw(n) if with_noise else None)
        np.testing.assert_allclose(nhwc(tx), np.asarray(jx), atol=1e-6)
        np.testing.assert_allclose(nhwc(tp), np.asarray(jp), atol=1e-6)


def test_cfg_eps_batches_uncond_first():
    """One forward over [uncond, cond]; the result mixes them by the scale."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    c, u = (rng.standard_normal((2, 5)).astype(np.float32) for _ in range(2))
    t = np.array([7, 7], np.int32)

    def jfn(xx, tt, cond):
        return xx * cond["c"].sum(-1)[:, None, None, None] + tt[:, None,
                                                                None, None]

    def tfn(xx, tt, cond):
        return xx * cond["c"].sum(-1)[:, None, None, None] + tt[:, None,
                                                                None, None]

    ref = jddim.cfg_eps(jfn, jnp.asarray(x), jnp.asarray(t),
                        {"c": jnp.asarray(c)}, {"c": jnp.asarray(u)}, 7.5)
    seen = []
    out = tddim.cfg_eps(lambda *a: seen.append(a[0].shape) or tfn(*a),
                        nchw(x), torch.from_numpy(t).long(),
                        {"c": torch.from_numpy(c)}, {"c": torch.from_numpy(u)},
                        7.5)
    assert seen == [(4, 4, 3, 3)]
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-5)


# --- the PNG hop between the factors ---------------------------------------

def test_quantize_like_png_rounds_half_to_even():
    vals = np.array([0.5, 1.5, 2.5, 3.5, 127.5, 254.5], np.float32) / 255.0
    vals = np.concatenate([vals, np.linspace(-0.2, 1.2, 301,
                                             dtype=np.float32)])
    np.testing.assert_array_equal(
        tchain.quantize_like_png(torch.from_numpy(vals)).numpy(),
        np.asarray(jchain.quantize_like_png(jnp.asarray(vals))))


@pytest.mark.parametrize("out_hw", [(64, 64), (80, 80), (32, 32)])
def test_condition_to_hint_matches_jax(out_hw):
    img = np.random.default_rng(2).random((2, 32, 32, 3)).astype(np.float32)
    ref = jchain.condition_to_hint(jnp.asarray(img), out_hw)
    out = tchain.condition_to_hint(nchw(img), out_hw)
    assert out.shape == (2, 3) + out_hw
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-6)


def test_condition_to_hint_keeps_bf16():
    img = np.random.default_rng(3).random((1, 16, 16, 3)).astype(np.float32)
    ref = jchain.condition_to_hint(jnp.asarray(img, jnp.bfloat16), (32, 32))
    out = tchain.condition_to_hint(nchw(img).to(torch.bfloat16), (32, 32))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(nhwc(out), np.asarray(ref, np.float32),
                               atol=1e-2)


# --- the tiny chain --------------------------------------------------------

def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), params)


@pytest.fixture(scope="module")
def tiny():
    """The tiny JAX pipelines and the port's, on the same weights."""
    x, t = jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32)
    ctx = jnp.zeros((1, 77, 64))
    unet_def = JUNetModel(**TINY, dtype=jnp.float32)
    cn_unet_def = JUNetModel(**TINY, use_adapter=False, dtype=jnp.float32)
    cn_def = JControlNet(**TINY, dtype=jnp.float32)
    vae_def = JAutoencoderKL(**VAE_TINY, dtype=jnp.float32)
    unet_p = _perturbed(unet_def.init(jax.random.PRNGKey(0), x, t, ctx), 10)
    cn_unet_p = _perturbed(cn_unet_def.init(jax.random.PRNGKey(1), x, t,
                                            ctx), 11)
    cn_p = _perturbed(cn_def.init(jax.random.PRNGKey(2), x,
                                  jnp.zeros((1, 64, 64, 3)), t, ctx), 12)
    vae_p = _perturbed(vae_def.init(jax.random.PRNGKey(3),
                                    jnp.zeros((1, 64, 64, 3)),
                                    sample_posterior=False), 13)
    sched = sd14_jax_schedule()
    jld = JLatentDiffusion(unet_def=unet_def, vae_def=vae_def, clip_def=None,
                           unet_params=unet_p, vae_params=vae_p,
                           schedule=sched)
    jcldm = JControlLDM(unet_def=cn_unet_def, vae_def=vae_def, clip_def=None,
                        unet_params=cn_unet_p, vae_params=vae_p,
                        schedule=sched, control_def=cn_def,
                        control_params=cn_p, control_scales=(1.0,) * 5)

    def loaded(module, sd):
        module.load_state_dict(sd, strict=True)
        return module.eval()

    vae = loaded(AutoencoderKL(**VAE_TINY, dtype=torch.float32, device="cpu"),
                 convert.vae_state_dict(vae_p))
    tsched = builders.sd14_schedule()
    ld = LatentDiffusion(
        loaded(UNetModel(**TINY, dtype=torch.float32, device="cpu"),
               convert.unet_state_dict(unet_p)), vae, tsched)
    cldm = ControlLDM(
        loaded(UNetModel(**TINY, use_adapter=False, dtype=torch.float32,
                         device="cpu"), convert.unet_state_dict(cn_unet_p)),
        vae, tsched,
        control=loaded(ControlNet(**TINY, dtype=torch.float32, device="cpu"),
                       convert.controlnet_state_dict(cn_p)),
        control_scales=(1.0,) * 5)
    rng = np.random.default_rng(14)
    ctxs = [rng.standard_normal((1, 77, 64)).astype(np.float32) * s
            for s in (1.0, 0.1, 1.0, 0.1)]
    return dict(jld=jld, jcldm=jcldm, ld=ld, cldm=cldm, ctxs=ctxs)


@pytest.fixture(scope="module")
def jax_chain(tiny):
    """The JAX composition of ``chain.py:334-350`` with injected x_T."""
    rng = np.random.default_rng(15)
    lat1 = (COND_HW[0] // 8, COND_HW[1] // 8)
    xt1 = rng.standard_normal((1,) + lat1 + (4,)).astype(np.float32)
    xt2 = rng.standard_normal((1, IMAGE_HW[0] // 8, IMAGE_HW[1] // 8,
                               4)).astype(np.float32)
    jld, jcldm = tiny["jld"], tiny["jcldm"]
    c1, u1, c2, u2 = (jnp.asarray(c) for c in tiny["ctxs"])

    @jax.jit
    def run(xt1, xt2):
        z = jchain.sample_condition_factor(
            jld, jax.random.PRNGKey(0), c1, u1, latent_hw=lat1,
            num_steps=F1_STEPS, x_T=xt1)
        cond = jnp.clip((jld.decode_first_stage(z) + 1.0) / 2.0, 0.0, 1.0)
        hint = jchain.condition_to_hint(cond, IMAGE_HW)
        z2 = jchain.sample_image_factor(
            jcldm, jax.random.PRNGKey(1), hint, c2, u2, num_steps=F2_STEPS,
            x_T=xt2)
        return cond, hint, jcldm.decode_first_stage(z2)

    cond, hint, image = run(jnp.asarray(xt1), jnp.asarray(xt2))
    return dict(xt1=xt1, xt2=xt2, cond=np.asarray(cond),
                hint=np.asarray(hint), image=np.asarray(image))


def test_chain_condition_and_hint_match_jax(tiny, jax_chain):
    ld = tiny["ld"]
    c1, u1 = (torch.from_numpy(c) for c in tiny["ctxs"][:2])
    z = tchain.sample_condition_factor(
        ld, c1, u1, latent_hw=(COND_HW[0] // 8, COND_HW[1] // 8),
        num_steps=F1_STEPS, x_T=nchw(jax_chain["xt1"]))
    with torch.inference_mode():
        cond = ((ld.decode_first_stage(z) + 1.0) / 2.0).clamp(0.0, 1.0)
    hint = tchain.condition_to_hint(cond, IMAGE_HW)
    assert cond.shape == (1, 3) + COND_HW and hint.shape == (1, 3) + IMAGE_HW
    ref = jax_chain["cond"]
    assert ref.std() > 1e-2   # the condition map is not constant
    np.testing.assert_allclose(nhwc(cond), ref, atol=CHAIN_TOL, rtol=0)
    d = np.abs(nhwc(hint) - jax_chain["hint"])
    assert d.max() <= 1 / 255 + 1e-6
    assert (d > 1e-6).mean() <= 0.01


def test_chain_image_matches_jax(tiny, jax_chain):
    cldm = tiny["cldm"]
    c2, u2 = (torch.from_numpy(c) for c in tiny["ctxs"][2:])
    z2 = tchain.sample_image_factor(cldm, nchw(jax_chain["hint"]), c2, u2,
                                    num_steps=F2_STEPS,
                                    x_T=nchw(jax_chain["xt2"]))
    with torch.inference_mode():
        image = cldm.decode_first_stage(z2)
    ref = jax_chain["image"]
    assert image.shape == (1, 3) + IMAGE_HW and ref.std() > 1e-2
    np.testing.assert_allclose(nhwc(image), ref, atol=CHAIN_TOL, rtol=0)


def _run_chain(tiny, slot_seeds):
    b = len(slot_seeds)
    ctxs = [torch.from_numpy(c).expand(b, -1, -1) for c in tiny["ctxs"]]
    return tchain.fgdm_chain(tiny["ld"], tiny["cldm"], *ctxs,
                             cond_hw=COND_HW, image_hw=IMAGE_HW,
                             f1_steps=F1_STEPS, f2_steps=F2_STEPS,
                             slot_seeds=slot_seeds)


def test_fgdm_chain_is_the_composition(tiny):
    """``fgdm_chain`` with slot seeds = the factor functions fed the x_T
    drawn from each factor's per-slot stream."""
    out = _run_chain(tiny, [7])
    ld, cldm = tiny["ld"], tiny["cldm"]
    c1, u1, c2, u2 = (torch.from_numpy(c) for c in tiny["ctxs"])
    lat1 = (1, 4, COND_HW[0] // 8, COND_HW[1] // 8)
    lat2 = (1, 4, IMAGE_HW[0] // 8, IMAGE_HW[1] // 8)
    xt1 = tddim.slot_noise(tchain.factor_slot_seeds([7], 1), lat1,
                           tddim.SLOT_INIT_TAG, "cpu")
    xt2 = tddim.slot_noise(tchain.factor_slot_seeds([7], 2), lat2,
                           tddim.SLOT_INIT_TAG, "cpu")
    z = tchain.sample_condition_factor(ld, c1, u1, lat1[2:],
                                       num_steps=F1_STEPS, x_T=xt1)
    with torch.inference_mode():
        cond = ((ld.decode_first_stage(z) + 1.0) / 2.0).clamp(0.0, 1.0)
        hint = tchain.condition_to_hint(cond, IMAGE_HW)
        z2 = tchain.sample_image_factor(cldm, hint, c2, u2,
                                        num_steps=F2_STEPS, x_T=xt2)
        image = cldm.decode_first_stage(z2)
    for name, ref in (("condition", cond), ("hint", hint), ("image", image)):
        torch.testing.assert_close(out[name], ref, rtol=0, atol=0)
    assert out["image"].std() > 1e-2


def test_fgdm_chain_slot_is_independent_of_its_batch(tiny):
    solo = _run_chain(tiny, [7])
    pair = _run_chain(tiny, [3, 7])
    for name in ("condition", "hint", "image"):
        torch.testing.assert_close(pair[name][1:], solo[name], rtol=0,
                                   atol=1e-5)
    assert (pair["image"][0] - pair["image"][1]).abs().max() > 1e-2


def test_ddim_slot_noise_with_eta_is_independent_of_its_batch():
    sched = tsch.DDIMSchedule.create(builders.sd14_schedule(), 10, eta=1.0)

    def fn(x, t, cond):
        return 0.1 * x + cond["c"][:, :, None, None]

    def run(seeds, c):
        return tddim.ddim_sample(fn, (len(seeds), 2, 3, 3), sched,
                                 {"c": c}, None, cfg_scale=1.0,
                                 slot_seeds=seeds, device="cpu")

    c = torch.arange(4.0).reshape(2, 2)
    pair, solo = run([5, 9], c), run([9], c[1:])
    torch.testing.assert_close(pair[1:], solo, rtol=0, atol=1e-6)
    assert not torch.equal(pair[0], pair[1])
    with pytest.raises(ValueError, match="slot seeds"):
        tddim.ddim_sample(fn, (2, 2, 3, 3), sched, {"c": c}, slot_seeds=[5],
                          device="cpu")


def test_derive_seed_rejects_negative_seeds():
    assert tddim.derive_seed(1, 2) == tddim.derive_seed(1, 2)
    assert tddim.derive_seed(1, 2) != tddim.derive_seed(2, 1)
    with pytest.raises(ValueError):
        tddim.derive_seed(-1)


def test_chain_needs_a_noise_source(tiny):
    with pytest.raises(ValueError, match="slot_seeds or a generator"):
        tchain.fgdm_chain(tiny["ld"], tiny["cldm"],
                          *(torch.from_numpy(c) for c in tiny["ctxs"]))


def test_guess_mode_is_not_ported(tiny):
    """Guess mode runs with DDIM only (``chain.py:183-184`` refuses the
    other samplers, as the port does); with DDIM it renders."""
    args = (tiny["cldm"], torch.zeros(1, 3, 64, 64), torch.zeros(1, 77, 64),
            torch.zeros(1, 77, 64))
    for sampler in ("plms", "dpm"):
        with pytest.raises(ValueError, match="guess mode"):
            tchain.sample_image_factor(*args, num_steps=2, guess_mode=True,
                                       sampler=sampler)
    z = tchain.sample_image_factor(*args, num_steps=2, guess_mode=True,
                                   generator=torch.Generator().manual_seed(0))
    assert z.shape == (1, 4, 8, 8) and bool(torch.isfinite(z).all())


@pytest.mark.parametrize("kw", [dict(seq_axis="seq",
                                     use_spatial_transformer=False),
                                dict(seq_axis="seq")])
def test_unported_unet_options_raise(kw):
    # pixel attention is ported (tests/test_torch_variants.py), and so is
    # context parallelism (tests/test_torch_parallel.py): a seq_axis UNet
    # builds, and its forward needs a registered context group (JAX's
    # error on an unregistered context mesh), with either attention
    unet = UNetModel(**TINY, device="cpu", **kw)
    assert unet.seq_axis == "seq"
    with pytest.raises(RuntimeError, match="no context group"):
        unet(torch.zeros(1, 4, 8, 8), torch.zeros(1, dtype=torch.long),
             context=torch.zeros(1, 77, 64))


# --- entry points and imports ----------------------------------------------

@pytest.mark.parametrize("entry", [
    lambda: builders.build_chain(), lambda: builders.build_unet(),
    lambda: UNetModel(**TINY), lambda: ControlNet(**TINY),
    lambda: AutoencoderKL(**VAE_TINY), lambda: builders.build_trainer(),
    lambda: CLIPTextEncoder(vocab_size=128, embed_dim=64, num_layers=1),
    lambda: ChainEngine(*builders.build_chain()), lambda: server.main([])],
    ids=["build_chain", "build_unet", "UNetModel", "ControlNet",
         "AutoencoderKL", "build_trainer", "CLIPTextEncoder", "ChainEngine",
         "server_main"])
def test_entry_points_need_cuda_unless_asked_for_cpu(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    assert fgdm_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def _port_sources():
    files = sorted((REPO / "fgdm_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax():
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "fgdm_tpu")
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in banned]
    names = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    assert {"fgdm_tpu_torch/serving.py", "fgdm_tpu_torch/server.py",
            "fgdm_tpu_torch/kernels/conv.py", "fgdm_tpu_torch/sampling/plms.py",
            "fgdm_tpu_torch/sampling/dpm_solver.py"} <= names
    assert len(names) > 20 and not bad, bad


def test_chip_smoke_fails_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
