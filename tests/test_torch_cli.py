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
* ``--factors``, ``--all_pconds``, ``--inference_loss`` and ``--detect``
  raise ``NotImplementedError`` citing their ROADMAP items.
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
from fgdm_tpu.cli import seg2image as jseg2image  # noqa: E402
from fgdm_tpu.cli import txt2img_fgdm as jtxt2img  # noqa: E402
from fgdm_tpu.core.schedules import DDIMSchedule as JDDIMSchedule  # noqa: E402
from fgdm_tpu.models.clip import CLIPTextEncoder as JCLIPTextEncoder  # noqa: E402
from fgdm_tpu.models.clip import CLIPTokenizer as JCLIPTokenizer  # noqa: E402
from fgdm_tpu_torch import builders, config  # noqa: E402
from fgdm_tpu_torch.checkpoint import loader  # noqa: E402
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


# --- refusals ------------------------------------------------------------------

@pytest.mark.parametrize("argv,item", [
    (["--factors", "seg,depth"], 7), (["--all_pconds"], 7),
    (["--inference_loss"], 13)],
    ids=["factors", "all_pconds", "inference_loss"])
def test_txt2img_refuses_what_is_not_ported(argv, item, tmp_path):
    with pytest.raises(NotImplementedError, match=f"Queue A item {item}\\b"):
        txt2img_fgdm.main(argv + ["--outdir", str(tmp_path), "--device",
                                  "cpu"])


def test_seg2image_refuses_detect(tmp_path):
    with pytest.raises(NotImplementedError, match="Queue A item 14\\b"):
        seg2image.main(["--data_dir", str(tmp_path), "--detect",
                        "--device", "cpu"])


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
