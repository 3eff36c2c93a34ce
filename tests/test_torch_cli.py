"""The port's inference entry points (``cli/txt2img_fgdm.py``,
``cli/seg2image.py``) held against the JAX package's, on tiny YAML configs
and ``.pth`` checkpoints in the reference's key schema.

The checkpoints hold the port's seeded tiny modules (the geometries of
``tests/test_torch_chain.py``, 0.02 N(0, 1) on every weight), float32 on the
CPU; both packages load the same files through their config specs.  The
CLIP text tower is a one-layer tiny one in both (``build_clip`` patched, as
``tests/test_txt2img_cli.py`` does), tokens come from the hash fallback
under ``FGDM_ALLOW_HASH_TOKENIZER=1``.

* The slice: JAX's x_T goes into both packages (torch cannot draw
  ``jax.random``'s bits).  Factor 1 (the CLI's own stage, DDIM 3 steps,
  decode), ``latent_to_condition_image`` and factor 2 (plain, ``strength``
  0.8, guess mode; 3 steps) agree within ``CHAIN_TOL = 2e-3``; the hint's
  uint8 quantize may flip one 1/255 step on at most 1 % of its pixels, so
  factor 2 is fed JAX's hint, as ``tests/test_torch_chain.py`` does.
* The CLIs write the files the JAX CLIs write, at the same shapes.
* ``--inference_loss`` (the attention-guided DDIM, 128^2 so the tiny UNet
  has the 256-token maps the guidance reads, q and k sharpened x4 so it
  moves x) writes the maps JAX's factor-1 stage gives for the CLI's own
  x_T, within one uint8 step.
* ``--factors`` (the N-factor chain, ``fgdm_chain_n``) writes the
  per-factor maps and the last factor's images the JAX CLI writes
  (``tests/test_txt2img_cli.py:100-170``), builds factor k with
  ``max(1, k)`` adapters under ``--all_pconds``, hands ``--dpm``/``--plms``
  to every factor and refuses a ``--factor_ckpts`` count mismatch with
  JAX's message.  Against JAX's CLI, with x_T injected into each stage of
  both (their ``_sample_factor_latents`` patched) and the ControlNet stage
  at 64^2 and 2 steps in both, the maps and images agree within one uint8
  step on at most 1 % of their pixels.
* ``--detect`` refuses a UniFormer checkpoint with missing keys, as JAX's
  ``load_uniformer`` does (its maps against JAX's CLI:
  ``tests/test_torch_annotators.py``).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402
from PIL import Image  # noqa: E402

import fgdm_tpu.sampling.chain as jchain  # noqa: E402
import fgdm_tpu.sampling.ddim as jddim  # noqa: E402
from fgdm_tpu import builders as jbuilders  # noqa: E402
from fgdm_tpu import config as jconfig  # noqa: E402
from fgdm_tpu.checkpoint import loader as jloader  # noqa: E402
from fgdm_tpu.cli import seg2image as jseg2image  # noqa: E402
from fgdm_tpu.cli import txt2img_fgdm as jtxt2img  # noqa: E402
from fgdm_tpu.core.schedules import DDIMSchedule as JDDIMSchedule  # noqa: E402
from fgdm_tpu.models.clip import CLIPTextEncoder as JCLIPTextEncoder  # noqa: E402
from fgdm_tpu.models.clip import CLIPTokenizer as JCLIPTokenizer  # noqa: E402
from fgdm_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL  # noqa: E402
from fgdm_tpu.models.controlnet import ControlNet as JControlNet  # noqa: E402
from fgdm_tpu.models.unet import UNetModel as JUNetModel  # noqa: E402
from fgdm_tpu_torch import builders, config  # noqa: E402
from fgdm_tpu_torch.checkpoint import convert, loader  # noqa: E402
from fgdm_tpu_torch.checkpoint import torch_ingest as ti  # noqa: E402
from fgdm_tpu_torch.cli import seg2image, txt2img_fgdm  # noqa: E402
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL  # noqa: E402
from fgdm_tpu_torch.models.clip import CLIPTextEncoder, CLIPTokenizer  # noqa: E402
from fgdm_tpu_torch.models.controlnet import ControlNet  # noqa: E402
from fgdm_tpu_torch.models.unet import UNetModel  # noqa: E402
from fgdm_tpu_torch.nn.layers import init_params_  # noqa: E402
from fgdm_tpu_torch.sampling import chain as tchain  # noqa: E402
from fgdm_tpu_torch.train.metrics import make_grid, to_uint8  # noqa: E402
from test_torch_chain import (CHAIN_TOL, TINY, VAE_TINY, nchw,  # noqa: E402
                              nhwc)
from test_torch_chain_n import injected_latents  # noqa: E402

torch.set_num_threads(2)

CLIP_TINY = dict(vocab_size=49408, embed_dim=64, num_layers=1, num_heads=4)
COND_HW, IMAGE_HW, STEPS = (32, 32), (64, 64), 3
F32 = dict(dtype=torch.float32, device="cpu")
_UNET_P = {**{k: list(v) if isinstance(v, tuple) else v
              for k, v in TINY.items()}, "use_checkpoint": True}
_VAE_P = {"embed_dim": 4, "ddconfig": {
    "ch": 32, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 1,
    "resolution": 64, "z_channels": 4, "double_z": True, "in_channels": 3,
    "out_ch": 3, "attn_resolutions": []}}
_COMMON = {"scale_factor": 0.18215, "linear_start": 0.00085,
           "linear_end": 0.0120,
           "first_stage_config": {
               "target": "ldm.models.autoencoder.AutoencoderKL",
               "params": _VAE_P},
           "cond_stage_config": {
               "target": "ldm.modules.encoders.modules.FrozenCLIPEmbedder"}}
F1_CFG = {"model": {
    "target": "ldm.models.diffusion.ddpm.LatentDiffusion",
    "params": {**_COMMON, "image_size": COND_HW[0] // 8, "unet_config": {
        "target": "ldm.modules.diffusionmodules.openaimodel.UNetModel",
        "params": _UNET_P}}}}
CLDM_CFG = {"model": {
    "target": "cldm.cldm.ControlLDM",
    "params": {**_COMMON, "image_size": IMAGE_HW[0] // 8,
               "unet_config": {"target": "cldm.cldm.ControlledUnetModel",
                               "params": _UNET_P},
               "control_stage_config": {
                   "target": "cldm.cldm.ControlNet",
                   "params": {**_UNET_P, "hint_channels": 3}}}}}


def _tiny_clip_defs(mp):
    """Both packages' config CLIP made tiny, and the port loader's SD
    presets (the CLI's ControlNet stage has no config) too."""
    mp.setattr(jbuilders, "build_clip", lambda dtype=jnp.bfloat16, **p: (
        JCLIPTextEncoder(**CLIP_TINY, dtype=dtype)))
    mp.setattr(builders, "build_clip", lambda dtype=torch.bfloat16, **p: (
        builders.ModuleDef(CLIPTextEncoder, dict(**CLIP_TINY, dtype=dtype))))
    mp.setattr(loader, "sd_unet", lambda dtype, device, **o: UNetModel(
        **TINY, dtype=dtype, device=device, **o))
    mp.setattr(loader, "sd_controlnet", lambda dtype, device: ControlNet(
        **TINY, dtype=dtype, device=device))
    mp.setattr(loader, "sd_vae", lambda dtype, device: AutoencoderKL(
        **VAE_TINY, dtype=dtype, device=device))
    mp.setattr(loader, "sd_clip", lambda dtype, device: CLIPTextEncoder(
        **CLIP_TINY, dtype=dtype, device=device))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The two tiny checkpoints and YAMLs, with the tiny CLIP patched in
    for the module's tests."""
    root = tmp_path_factory.mktemp("tiny")
    gen = torch.Generator().manual_seed(30)

    def sd(prefix, module):
        init_params_(module, gen, 0.02)
        return {prefix + k: v for k, v in module.state_dict().items()}

    vae = sd(ti.VAE_PREFIX, AutoencoderKL(**VAE_TINY, **F32))
    clip = sd(ti.CLIP_PREFIX, CLIPTextEncoder(**CLIP_TINY, **F32))
    f1 = {**sd(ti.UNET_PREFIX, UNetModel(**TINY, **F32)), **vae, **clip,
          "model_ema.decay": torch.tensor(0.9999)}
    cn = {**sd(ti.UNET_PREFIX, UNetModel(**TINY, use_adapter=False, **F32)),
          **sd(ti.CONTROL_PREFIX, ControlNet(**TINY, **F32)), **vae, **clip}
    out = {}
    for name, obj in (("f1.pth", f1), ("cn.pth", cn)):
        torch.save({"state_dict": obj}, root / name)
        out[name] = str(root / name)
    for name, cfg in (("f1.yaml", F1_CFG), ("cldm.yaml", CLDM_CFG)):
        (root / name).write_text(yaml.safe_dump(cfg))
        out[name] = str(root / name)
    out["root"] = root
    mp = pytest.MonkeyPatch()
    _tiny_clip_defs(mp)
    mp.setenv("FGDM_ALLOW_HASH_TOKENIZER", "1")
    yield out
    mp.undo()


@pytest.fixture(scope="module")
def pipes(files):
    """Both packages' pipelines, loaded from the same files through their
    config specs."""
    def spec(pkg, name, dtype):
        return pkg.instantiate_from_config(
            pkg.load_config(files[name])["model"], dtype=dtype)

    jld = spec(jconfig, "f1.yaml", jnp.float32).load(files["f1.pth"])
    jcldm = spec(jconfig, "cldm.yaml", jnp.float32).load(files["cn.pth"])
    ld = spec(config, "f1.yaml", torch.float32).load(files["f1.pth"],
                                                     device="cpu")
    cldm = spec(config, "cldm.yaml", torch.float32).load(files["cn.pth"],
                                                         device="cpu")
    assert ld.load_report["missing"] == {"unet": [], "vae": [], "clip": []}
    assert cldm.load_report["unexpected"] == []
    return dict(jld=jld, jcldm=jcldm, ld=ld, cldm=cldm)


@pytest.fixture(scope="module")
def jax_slice(pipes):
    """The JAX CLI's compute on injected x_T: ``sample_f1``'s DDIM +
    decode, ``latent_to_condition_image`` and ``sample_image_factor`` plain,
    at strength 0.8 and in guess mode, each decoded."""
    jld, jcldm = pipes["jld"], pipes["jcldm"]
    tok = JCLIPTokenizer()
    ctxs = [np.asarray(pipe.get_learned_conditioning(jnp.asarray(tok(t))))
            for pipe, t in ((jld, ["a cat", "a dog"]), (jld, ["", ""]),
                            (jcldm, ["a cat, " + jchain.A_PROMPT] * 2),
                            (jcldm, [jchain.N_PROMPT] * 2))]
    rng = np.random.default_rng(31)
    xt1 = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    xt2 = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def run(xt1, xt2, c1, u1, c2, u2):
        sched = JDDIMSchedule.create(jld.schedule, STEPS, eta=0.0)
        z, _ = jddim.ddim_sample(jld.denoise_fn(adapter_on=True), key,
                                 xt1.shape, sched, {"c_crossattn": c1},
                                 {"c_crossattn": u1}, cfg_scale=7.5, x_T=xt1)
        hint = jchain.latent_to_condition_image(jld, z, IMAGE_HW)
        images = {}
        for name, kw in (("plain", {}), ("strength", dict(strength=0.8)),
                         ("guess", dict(strength=0.8, guess_mode=True))):
            z2 = jchain.sample_image_factor(jcldm, key, hint, c2, u2,
                                            num_steps=STEPS, cfg_scale=9.0,
                                            x_T=xt2, **kw)
            images[name] = jcldm.decode_first_stage(z2)
        return z, jld.decode_first_stage(z), hint, images

    z, cond, hint, images = run(jnp.asarray(xt1), jnp.asarray(xt2),
                                *(jnp.asarray(c) for c in ctxs))
    return dict(ctxs=ctxs, xt1=xt1, xt2=xt2, z=np.asarray(z),
                cond=np.asarray(cond), hint=np.asarray(hint),
                images={k: np.asarray(v) for k, v in images.items()})


# --- the slice against JAX -----------------------------------------------------

def test_contexts_from_the_checkpoint_match_jax(pipes, jax_slice):
    tok = CLIPTokenizer()
    for pipe, texts, ref in ((pipes["ld"], ["a cat", "a dog"],
                              jax_slice["ctxs"][0]),
                             (pipes["cldm"], [tchain.N_PROMPT] * 2,
                              jax_slice["ctxs"][3])):
        with torch.inference_mode():
            got = pipe.get_learned_conditioning(tok(texts)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4 * max(
            1.0, float(np.abs(ref).max())))


def test_factor1_stage_matches_jax(pipes, jax_slice):
    c1, u1 = (torch.from_numpy(c) for c in jax_slice["ctxs"][:2])
    z, cond = txt2img_fgdm.sample_condition_maps(
        pipes["ld"], c1, u1, (2, 4) + tuple(s // 8 for s in COND_HW), STEPS,
        7.5, x_T=nchw(jax_slice["xt1"]))
    ref = jax_slice["cond"]
    assert cond.shape == (2, 3) + COND_HW and ref.std() > 1e-2
    np.testing.assert_allclose(nhwc(cond), ref, atol=CHAIN_TOL, rtol=0)
    np.testing.assert_allclose(nhwc(z), jax_slice["z"], atol=CHAIN_TOL,
                               rtol=0)


def test_latent_to_condition_image_matches_jax(pipes, jax_slice):
    hint = tchain.latent_to_condition_image(pipes["ld"],
                                            nchw(jax_slice["z"]), IMAGE_HW)
    assert hint.shape == (2, 3) + IMAGE_HW
    d = np.abs(nhwc(hint) - jax_slice["hint"])
    assert d.max() <= 1 / 255 + 1e-6
    assert (d > 1e-6).mean() <= 0.01


@pytest.mark.parametrize("mode", ["plain", "strength", "guess"])
def test_factor2_matches_jax(pipes, jax_slice, mode, monkeypatch):
    cldm = pipes["cldm"]
    c2, u2 = (torch.from_numpy(c) for c in jax_slice["ctxs"][2:])
    hint, xt2 = nchw(jax_slice["hint"]), nchw(jax_slice["xt2"])
    if mode == "plain":
        # the CLI's own stage, at this test's step count
        monkeypatch.setattr(txt2img_fgdm, "CN_STEPS", STEPS)
        image = txt2img_fgdm.render_images(cldm, hint, c2, u2, x_T=xt2)
    else:
        kw = dict(strength=0.8, guess_mode=mode == "guess")
        z2 = tchain.sample_image_factor(cldm, hint, c2, u2, num_steps=STEPS,
                                        cfg_scale=9.0, x_T=xt2, **kw)
        with torch.inference_mode():
            image = cldm.decode_first_stage(z2)
    ref = jax_slice["images"][mode]
    assert image.shape == (2, 3) + IMAGE_HW and ref.std() > 1e-2
    np.testing.assert_allclose(nhwc(image), ref, atol=CHAIN_TOL, rtol=0)


def test_strength_and_guess_mode_change_the_image(jax_slice):
    imgs = jax_slice["images"]
    assert np.abs(imgs["strength"] - imgs["plain"]).max() > 10 * CHAIN_TOL
    assert np.abs(imgs["guess"] - imgs["strength"]).max() > 10 * CHAIN_TOL


def test_grid_and_uint8_match_jax():
    from fgdm_tpu.train import metrics as jmetrics

    rng = np.random.default_rng(32)
    imgs = rng.integers(0, 256, (5, 6, 7, 3), dtype=np.uint8)
    for nrow in (1, 2, 4):
        np.testing.assert_array_equal(make_grid(imgs, nrow=nrow),
                                      jmetrics.make_grid(imgs, nrow=nrow))
    x = rng.uniform(-1.2, 1.2, (2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(to_uint8(x), jmetrics.to_uint8(x))


# --- the CLIs against the JAX CLIs ---------------------------------------------

def _pngs(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith(".png"):
                p = os.path.join(d, n)
                out[os.path.relpath(p, root)] = np.asarray(Image.open(p)).shape
    return out


def test_txt2img_cli_writes_the_files_jax_writes(files, tmp_path):
    args = ["--prompt", "a cat", "--config", files["f1.yaml"], "--ckpt",
            files["f1.pth"], "--n_samples", "2", "--ddim_steps", "2",
            "--H", "32", "--W", "32", "--precision", "full", "--seed", "3",
            "--n_rows", "2"]
    jtxt2img.main(args + ["--outdir", str(tmp_path / "jax")])
    out = txt2img_fgdm.main(args + ["--outdir", str(tmp_path / "port"),
                                    "--device", "cpu"])
    ref = _pngs(tmp_path / "jax")
    assert sorted(ref) == [os.path.join("samples", "grid_00.png")] + [
        os.path.join("samples", "sample1", f"sample1_00_{i:04}.png")
        for i in range(2)]
    assert _pngs(tmp_path / "port") == ref
    assert ref[os.path.join("samples", "sample1", "sample1_00_0000.png")] \
        == (32, 32, 3)
    assert len(out["files"]) == 3 and len(out["factor1_s"]) == 1
    assert out["factor2_s"] == []


def test_txt2img_cli_controlnet_stage(files, tmp_path, monkeypatch):
    """``--use_controlnet`` at a tiny render size (the reference's is 512^2
    at 20 steps), with ``--from-file`` batching: three prompts at two a
    batch give two batches, the last padded; the files are named as the
    JAX CLI names them (``txt2img_fgdm.py:289-357``)."""
    monkeypatch.setattr(txt2img_fgdm, "CN_HW", IMAGE_HW)
    monkeypatch.setattr(txt2img_fgdm, "CN_STEPS", 2)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a cat\n\na dog\na bird\n")
    out = txt2img_fgdm.main([
        "--from-file", str(prompts), "--config", files["f1.yaml"],
        "--ckpt", files["f1.pth"], "--use_controlnet", "--cn_ckpt",
        files["cn.pth"], "--n_samples", "2", "--ddim_steps", "2", "--H",
        "32", "--W", "32", "--precision", "full", "--device", "cpu",
        "--outdir", str(tmp_path / "o")])
    got = _pngs(tmp_path / "o")
    want = {}
    for tag in ("00_00", "00_01"):
        for i in range(2):
            want[os.path.join("samples", "sample1",
                              f"sample1_{tag}_{i:04}.png")] = (32, 32, 3)
            want[os.path.join("samples", "seg_images",
                              f"sample1_{tag}_{i:04}.png")] = (64, 64, 3)
    assert got == want
    assert len(out["factor1_s"]) == len(out["factor2_s"]) == 2
    # the padded slot repeats the last prompt: same noise source, other draw
    last = [np.asarray(Image.open(tmp_path / "o" / "samples" / "seg_images"
                                  / f"sample1_00_01_{i:04}.png"))
            for i in range(2)]
    assert last[0].std() > 0 and last[1].std() > 0


@pytest.mark.parametrize("flags", [
    ["--plms", "--fixed_code", "--resize", "--skip_grid"],
    ["--dpm", "--use_original", "--n_iter", "2"]], ids=["plms", "dpm"])
def test_txt2img_cli_sampler_flags(files, tmp_path, flags):
    out = txt2img_fgdm.main([
        "--prompt", "a cat", "--config", files["f1.yaml"], "--ckpt",
        files["f1.pth"], "--n_samples", "1", "--ddim_steps", "2", "--H",
        "32", "--W", "32", "--precision", "full", "--device", "cpu",
        "--outdir", str(tmp_path / "o")] + flags)
    got = _pngs(tmp_path / "o")
    if "--plms" in flags:
        # --resize writes the maps at 512^2 (PIL's default resample)
        assert got == {os.path.join("samples", "sample1",
                                    "sample1_00_0000.png"): (512, 512, 3)}
    else:
        assert sorted(got) == [os.path.join("samples", "sample1",
                                            f"sample1_{it:02}_0000.png")
                               for it in range(2)]
        assert len(out["factor1_s"]) == 2


def test_txt2img_inference_loss_matches_jax_stage(files, tmp_path):
    """``--inference_loss --fixed_code``: the maps the port's CLI writes
    against JAX's ``sample_f1`` (DDIM with ``capture_fn`` as the guidance,
    decode, uint8) on the same file, contexts and x_T (the CLI's
    ``torch.randn`` draw from ``--seed``)."""
    sd = torch.load(files["f1.pth"])
    for k, v in sd["state_dict"].items():
        if k.endswith(("to_q.weight", "to_k.weight")):
            v.mul_(4.0)
    ckpt = str(tmp_path / "sharp.pth")
    torch.save(sd, ckpt)
    args = ["--prompt", "a cat", "--config", files["f1.yaml"], "--ckpt",
            ckpt, "--n_samples", "2", "--ddim_steps", "2", "--H", "128",
            "--W", "128", "--precision", "full", "--seed", "3",
            "--fixed_code", "--device", "cpu"]
    txt2img_fgdm.main(args + ["--inference_loss", "--outdir",
                              str(tmp_path / "g")])
    txt2img_fgdm.main(args + ["--outdir", str(tmp_path / "p")])

    def maps(d):
        return np.stack([np.asarray(Image.open(
            tmp_path / d / "samples" / "sample1" / f"sample1_00_{i:04}.png"))
            for i in range(2)])

    jld = jconfig.instantiate_from_config(
        jconfig.load_config(files["f1.yaml"])["model"],
        dtype=jnp.float32).load(ckpt)
    tok = JCLIPTokenizer()
    c, uc = (jld.get_learned_conditioning(jnp.asarray(tok([p] * 2)))
             for p in ("a cat", ""))
    xt = torch.randn((2, 4, 16, 16),
                     generator=torch.Generator().manual_seed(3))
    sched = JDDIMSchedule.create(jld.schedule, 2, eta=0.0)
    z, _ = jddim.ddim_sample(
        jld.denoise_fn(), jax.random.PRNGKey(0), (2, 16, 16, 4), sched,
        {"c_crossattn": c}, {"c_crossattn": uc}, cfg_scale=7.5,
        x_T=jnp.asarray(nhwc(xt)), guidance_fn=jld.capture_fn())
    ref = to_uint8(np.asarray(jld.decode_first_stage(z)))
    got = maps("g")
    assert got.shape == ref.shape == (2, 128, 128, 3) and ref.std() > 1
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01
    assert np.abs(maps("p").astype(int) - got.astype(int)).max() > 1


def _seg_map(root):
    d = root / "maps" / "sample2"
    d.mkdir(parents=True)
    rng = np.random.default_rng(33)
    Image.fromarray(rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(
        d / "m0.png")
    return str(root / "maps")


def test_seg2image_cli_writes_the_files_jax_writes(files, tmp_path):
    data = _seg_map(tmp_path)
    args = ["--data_dir", data, "--config", files["cldm.yaml"], "--cn_ckpt",
            files["cn.pth"], "--image_resolution", "64", "--ddim_steps", "2",
            "--num_images", "1", "--eta", "0.5", "--strength", "0.8",
            "--prompt", "a tiny test", "--precision", "full"]
    jseg2image.main(args + ["--outdir", str(tmp_path / "jax")])
    written = seg2image.main(args + ["--outdir", str(tmp_path / "port"),
                                     "--device", "cpu"])
    ref = _pngs(tmp_path / "jax")
    assert ref == {"m0_render.png": (64, 64, 3)}
    assert _pngs(tmp_path / "port") == ref and len(written) == 1
    # guess mode, and the SD-1.5 layout without --config (tiny presets)
    seg2image.main(["--data_dir", data, "--cn_ckpt", files["cn.pth"],
                    "--image_resolution", "64", "--ddim_steps", "2",
                    "--guess_mode", "--precision", "full", "--device", "cpu",
                    "--outdir", str(tmp_path / "guess")])
    img = np.asarray(Image.open(tmp_path / "guess" / "m0_render.png"))
    assert img.shape == (64, 64, 3) and img.std() > 0


# --- the N-factor chain (--factors) ----------------------------------------------

def _factor_args(files, factors, ckpts, n=2, steps=2):
    return ["--prompt", "a dog | a depth map of a dog", "--config",
            files["f1.yaml"], "--factors", factors, "--factor_ckpts", ckpts,
            "--n_samples", str(n), "--ddim_steps", str(steps), "--H", "32",
            "--W", "32", "--precision", "full", "--seed", "3"]


def _factor_files(names, n, shape=(32, 32, 3)):
    return {os.path.join(f"factor_{m}", f"{m}_00_{i:04}.png"): shape
            for m in names for i in range(n)}


@pytest.fixture()
def chain_calls(monkeypatch):
    """Records what the CLI hands ``fgdm_chain_n``."""
    calls = []
    real = tchain.fgdm_chain_n

    def spy(factors, cldm, *a, **kw):
        calls.append(dict(kw, adapters=[len(f.unet.adapters)
                                        for f in factors], cldm=cldm))
        return real(factors, cldm, *a, **kw)

    monkeypatch.setattr(tchain, "fgdm_chain_n", spy)
    return calls


def test_factor_chain_cli_writes_per_factor_dirs(files, tmp_path,
                                                 chain_calls):
    """``--factors seg,depth``: the first factor from its file, the second
    at the seeded init (an empty ``--factor_ckpts`` entry); one directory
    of maps per factor, no ControlNet stage."""
    out = txt2img_fgdm.main(_factor_args(files, "seg,depth",
                                         files["f1.pth"] + ",")
                            + ["--outdir", str(tmp_path / "o"),
                               "--device", "cpu"])
    assert _pngs(tmp_path / "o") == _factor_files(("seg", "depth"), 2)
    assert len(out["files"]) == 4 and len(out["chain_s"]) == 1
    seg = np.asarray(Image.open(tmp_path / "o" / "factor_seg"
                                / "seg_00_0000.png"))
    assert seg.astype(np.float64).std() > 1.0
    (call,) = chain_calls
    assert call["adapters"] == [0, 0] and not call["all_pconds"]
    assert call["cldm"] is None and call["factor_sampler"] == "ddim"


def test_factor_chain_cli_all_pconds_and_controlnet(files, tmp_path,
                                                    monkeypatch, chain_calls):
    """``--factors seg,depth,normal --all_pconds --use_controlnet``: factor
    3 gets one extra adapter (fed factor 1's latent), the ControlNet stage
    renders the last map under ``normal_images/``."""
    monkeypatch.setattr(txt2img_fgdm, "CN_HW", IMAGE_HW)
    monkeypatch.setattr(txt2img_fgdm, "CN_STEPS", 2)
    out = txt2img_fgdm.main(_factor_args(files, "seg,depth,normal",
                                         files["f1.pth"] + ",,")
                            + ["--all_pconds", "--use_controlnet",
                               "--cn_ckpt", files["cn.pth"], "--outdir",
                               str(tmp_path / "o"), "--device", "cpu"])
    want = _factor_files(("seg", "depth", "normal"), 2)
    want.update({os.path.join("normal_images", f"image_00_{i:04}.png"):
                 IMAGE_HW + (3,) for i in range(2)})
    assert _pngs(tmp_path / "o") == want and len(out["files"]) == 8
    (call,) = chain_calls
    assert call["adapters"] == [0, 0, 1] and call["all_pconds"]
    assert call["cldm"] is not None and call["image_hw"] == IMAGE_HW
    img = np.asarray(Image.open(tmp_path / "o" / "normal_images"
                                / "image_00_0001.png"))
    assert img.std() > 0


@pytest.mark.parametrize("flag", ["--dpm", "--plms"])
def test_factor_chain_cli_sampler_flags(files, tmp_path, flag, chain_calls):
    txt2img_fgdm.main(_factor_args(files, "seg,depth", ",", n=1, steps=3)
                      + [flag, "--outdir", str(tmp_path / "o"), "--device",
                         "cpu"])
    assert _pngs(tmp_path / "o") == _factor_files(("seg", "depth"), 1)
    assert chain_calls[0]["factor_sampler"] == flag[2:]


@pytest.mark.parametrize("factors,ckpts,msg", [
    ("seg,depth,normal", "a.pth,b.pth", "2 entries for 3 factors"),
    (",", ",", "given but empty")], ids=["count", "empty"])
def test_factor_chain_cli_refusals(files, tmp_path, factors, ckpts, msg):
    with pytest.raises(SystemExit, match=msg):
        txt2img_fgdm.main(_factor_args(files, factors, ckpts)
                          + ["--outdir", str(tmp_path), "--device", "cpu"])


def test_all_pconds_without_factors_is_ignored(files, tmp_path):
    """Only the factor chain reads ``--all_pconds``, as in JAX."""
    out = txt2img_fgdm.main([
        "--prompt", "a cat", "--config", files["f1.yaml"], "--ckpt",
        files["f1.pth"], "--all_pconds", "--n_samples", "1",
        "--ddim_steps", "2", "--H", "32", "--W", "32", "--precision",
        "full", "--device", "cpu", "--skip_grid", "--outdir",
        str(tmp_path / "o")])
    assert sorted(_pngs(tmp_path / "o")) == [
        os.path.join("samples", "sample1", "sample1_00_0000.png")]
    assert len(out["factor1_s"]) == 1


def _tiny_jax_presets(mp):
    """The JAX loader's SD presets made tiny: its factor CLI builds the
    ControlNet stage from them (no config)."""
    mp.setattr(jloader, "sd_unet", lambda dtype=jnp.bfloat16, **o: (
        JUNetModel(**TINY, dtype=dtype, **o)))
    mp.setattr(jloader, "sd_controlnet", lambda dtype=jnp.bfloat16, **o: (
        JControlNet(**TINY, dtype=dtype, **o)))
    mp.setattr(jloader, "sd_vae", lambda dtype=jnp.bfloat16, **o: (
        JAutoencoderKL(**VAE_TINY, dtype=dtype, **o)))
    mp.setattr(jloader, "sd_clip", lambda dtype=jnp.bfloat16: (
        JCLIPTextEncoder(**CLIP_TINY, dtype=dtype)))


def test_factor_chain_cli_writes_the_files_jax_writes(files, tmp_path,
                                                      monkeypatch):
    """Both CLIs on ``--factors seg,depth,normal --all_pconds
    --use_controlnet`` with a file for every factor (the packages' seeded
    inits differ; factors 2 and 3 share one of other weights), the same x_T injected into each stage, factor 3's extra
    adapter (which no file holds) given JAX's init, and the ControlNet stage
    at 64^2 with 2 steps in both: the same maps and images, each within one
    uint8 step on at most 1 % of its pixels.  This
    holds the CLI's orchestration against JAX's: the ``|`` prompt split,
    each factor's own text embedding, the uncond from factor 1, the
    ControlNet's prompt from the first factor's, the render of the last map
    and the uint8 truncation."""
    _tiny_jax_presets(monkeypatch)
    rng = np.random.default_rng(34)
    xts = [rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
           for _ in range(3)]
    xts.append(rng.standard_normal((2, 4, 8, 8)).astype(np.float32))
    # factors 2 and 3 from a second file, its UNet and CLIP perturbed, so
    # that each factor's embedding and the uncond's source show
    sd, g = torch.load(files["f1.pth"]), torch.Generator().manual_seed(35)
    for k, v in sd["state_dict"].items():
        if k.startswith((ti.UNET_PREFIX, ti.CLIP_PREFIX)):
            v.add_(0.02 * torch.randn(v.shape, generator=g))
    torch.save(sd, tmp_path / "f1b.pth")
    args = _factor_args(files, "seg,depth,normal", ",".join(
        [files["f1.pth"]] + [str(tmp_path / "f1b.pth")] * 2)) + [
        "--all_pconds", "--use_controlnet", "--cn_ckpt", files["cn.pth"]]
    jlds, real_load = [], jloader.load_fgdm
    monkeypatch.setattr(jloader, "load_fgdm", lambda *a, **kw: (
        jlds.append(real_load(*a, **kw)) or jlds[-1]))
    # the ControlNet stage at the port's patched size and steps below (the
    # JAX CLI passes its 512^2 and 20 steps to fgdm_chain_n)
    real_jchain = jchain.fgdm_chain_n
    monkeypatch.setattr(jchain, "fgdm_chain_n", lambda *a, **kw: real_jchain(
        *a, **{**kw, "image_hw": IMAGE_HW, "f2_steps": 2}))
    monkeypatch.setattr(txt2img_fgdm, "CN_HW", IMAGE_HW)
    monkeypatch.setattr(txt2img_fgdm, "CN_STEPS", 2)
    jzs = injected_latents(monkeypatch, jchain, xts)
    jtxt2img.main(args + ["--outdir", str(tmp_path / "jax")])

    real_chain, copied = tchain.fgdm_chain_n, []

    def with_jax_extra_adapters(factors, *a, **kw):
        for ld, jld in zip(factors, jlds):
            sd = {k: v for k, v in convert.unet_state_dict(jax.tree.map(
                np.asarray, jld.unet_params)).items()
                  if k.startswith("adapters.")}
            res = ld.unet.load_state_dict(sd, strict=False)
            assert not res.unexpected_keys
            copied.append(len(sd))
        return real_chain(factors, *a, **kw)

    monkeypatch.setattr(tchain, "fgdm_chain_n", with_jax_extra_adapters)
    zs = injected_latents(monkeypatch, tchain, xts)
    out = txt2img_fgdm.main(args + ["--outdir", str(tmp_path / "port"),
                                    "--device", "cpu"])
    assert len(jzs) == len(zs) == 4 and copied[:2] == [0, 0] and copied[2]
    ref = _pngs(tmp_path / "jax")
    want = _factor_files(("seg", "depth", "normal"), 2)
    want.update({os.path.join("normal_images", f"image_00_{i:04}.png"):
                 IMAGE_HW + (3,) for i in range(2)})
    assert ref == want
    assert _pngs(tmp_path / "port") == ref and len(out["files"]) == 8
    for name in ref:
        a, b = (np.asarray(Image.open(tmp_path / d / name)).astype(int)
                for d in ("port", "jax"))
        assert b.std() > 1.0, name
        d = np.abs(a - b)
        assert d.max() <= 1 and (d > 0).mean() <= 0.01, (name, d.max(),
                                                         (d > 0).mean())


# --- refusals ------------------------------------------------------------------

def test_seg2image_refuses_detect(files, tmp_path):
    """``--detect`` with a ``--seg_ckpt`` that lacks keys: a part-random
    segmentor would make plausible maps."""
    data = _seg_map(tmp_path)
    (tmp_path / "maps" / "sample2").rename(tmp_path / "maps" / "sample1")
    torch.save({"state_dict": {"decode_head.conv_seg.bias": torch.zeros(
        150)}}, tmp_path / "upernet.pth")
    with pytest.raises(ValueError, match="UniFormer ingest .* missing"):
        seg2image.main(["--data_dir", data, "--detect", "--seg_ckpt",
                        str(tmp_path / "upernet.pth"), "--config",
                        files["cldm.yaml"], "--cn_ckpt", files["cn.pth"],
                        "--precision", "full", "--device", "cpu",
                        "--outdir", str(tmp_path / "out")])


def test_clis_refuse_real_weights_with_the_hash_tokenizer(files, tmp_path,
                                                          monkeypatch):
    monkeypatch.delenv("FGDM_ALLOW_HASH_TOKENIZER")
    monkeypatch.delenv("FGDM_CLIP_VOCAB_DIR", raising=False)
    with pytest.raises(SystemExit, match="no CLIP vocab"):
        txt2img_fgdm.main(["--ckpt", files["f1.pth"], "--device", "cpu",
                           "--outdir", str(tmp_path)])
    with pytest.raises(SystemExit, match="no CLIP vocab"):
        seg2image.main(["--data_dir", str(tmp_path), "--cn_ckpt",
                        files["cn.pth"], "--device", "cpu"])


def test_clis_run_on_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        txt2img_fgdm.main(["--ckpt", "/nonexistent", "--outdir",
                           str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        seg2image.main(["--data_dir", str(tmp_path)])
