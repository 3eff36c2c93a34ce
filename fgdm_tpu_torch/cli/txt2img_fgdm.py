"""FG-DM chain inference CLI, flag for flag the JAX package's
``fgdm_tpu/cli/txt2img_fgdm.py`` (the reference's
``scripts/txt2img_fgdm_inference.py``, driven by ``run_inference.sh``).

Loads the condition factor from ``--config``/``--ckpt`` (the SD-1.x
defaults when the config file does not exist), samples ``--n_samples``
condition maps at ``--H`` x ``--W`` with DDIM, ``--plms`` or ``--dpm`` at CFG
``--scale`` and writes them under ``samples/sample1/``; with
``--use_controlnet`` it renders each map to a 512^2 image with the
ControlNet stage (20 DDIM steps, CFG 9.0, the reference's positive and
negative prompt suffixes) under ``samples/<cond>_images/``.  The hop
between the factors stays on the device.  ``--device`` (default ``cuda``)
names where the models run; ``--precision full`` computes in float32,
``autocast`` in bf16.  ``--inference_loss`` runs the DDIM sampler with the
attention-alignment guidance of ``sampling/guidance.py`` (the capture
forward ``capture_fn`` as its guidance function; ignored by ``--plms`` and
``--dpm``, as in the JAX CLI).

``--factors seg,depth,normal`` runs the N-factor chain instead
(``sampling.chain.fgdm_chain_n``, JAX ``_run_factor_chain``): one
condition factor per name, from ``--factor_ckpts`` (comma list, an empty
entry or a missing file meaning the seeded init; default
``models/fgdm_<name>.pth``), each adapter-prompted by the previous one;
``--all_pconds`` gives factor k ``max(1, k)`` adapters, every earlier
factor feeding one.  ``--prompt`` splits on ``|`` into per-factor prompts.
The maps go to ``factor_<name>/``, the ControlNet stage's images (from
``--cn_ckpt``, else ``models/fgdm_control_sd15_<last>.pth``) to
``<last>_images/``.  ``--all_pconds`` without ``--factors`` is ignored, as
in JAX.

    python -m fgdm_tpu_torch.cli.txt2img_fgdm --config models/config.yaml \\
        --ckpt models/fgdm_seg.pth --n_samples 5 --ddim_steps 50 \\
        --H 256 --W 256 --use_controlnet
    python -m fgdm_tpu_torch.cli.txt2img_fgdm --config models/config.yaml \\
        --factors seg,depth,normal --all_pconds --use_controlnet

PNGs are written by ``server.png_bytes`` (no Pillow); ``--resize`` needs
Pillow.  ``main`` returns the files it wrote and its timings.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.checkpoint import loader
from fgdm_tpu_torch.checkpoint.loader import load_controlnet, load_fgdm
from fgdm_tpu_torch.config import instantiate_from_config, load_config
from fgdm_tpu_torch.core.schedules import DDIMSchedule
from fgdm_tpu_torch.models.clip import CLIPTokenizer
from fgdm_tpu_torch.sampling import chain as chain_mod
from fgdm_tpu_torch.sampling.ddim import ddim_sample
from fgdm_tpu_torch.sampling.dpm_solver import dpm_solver_sample
from fgdm_tpu_torch.sampling.plms import plms_sample
from fgdm_tpu_torch.server import png_bytes
from fgdm_tpu_torch.train.metrics import make_grid, to_uint8

# the ControlNet stage of the reference (initialize_cn.py:74-102)
CN_HW, CN_STEPS, CN_SCALE = (512, 512), 20, 9.0


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="FG-DM chain inference (PyTorch)")
    p.add_argument("--prompt", type=str, nargs="?",
                   default="a painting of a virus monster playing guitar")
    p.add_argument("--config", type=str,
                   default="configs/stable-diffusion/v1-inference.yaml")
    p.add_argument("--use_controlnet", action="store_true",
                   help="run the seg->image ControlNet second factor")
    p.add_argument("--outdir", type=str, default="outputs/txt2img-samples")
    p.add_argument("--cond", type=str, default="seg",
                   choices=["seg", "depth", "normal", "sketch"])
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--n_prompt", type=str, default="")
    p.add_argument("--plms", action="store_true")
    p.add_argument("--dpm", "--dpm_solver", dest="dpm", action="store_true",
                   help="DPM-Solver++ sampler (extension)")
    p.add_argument("--fixed_code", action="store_true")
    p.add_argument("--resize", action="store_true")
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--n_iter", type=int, default=1)
    p.add_argument("--H", type=int, default=256)
    p.add_argument("--W", type=int, default=256)
    p.add_argument("--ckpt", type=str,
                   default="models/ldm/stable-diffusion-v1/model.ckpt")
    p.add_argument("--cn_ckpt", type=str, default=None,
                   help="ControlNet stage checkpoint "
                        "(default models/fgdm_control_sd15_<cond>.pth)")
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--C", type=int, default=4)
    p.add_argument("--f", type=int, default=8,
                   help="VAE downsample factor (latent = H/f)")
    p.add_argument("--skip_grid", action="store_true",
                   help="do not save the sample grid")
    p.add_argument("--skip_save", action="store_true",
                   help="do not save individual samples")
    p.add_argument("--scale", type=float, default=7.5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--precision", type=str, default="autocast",
                   choices=["autocast", "full"])
    p.add_argument("--vocab_dir", type=str, default=None,
                   help="dir with CLIP vocab.json+merges.txt")
    p.add_argument("--use_original", action="store_true",
                   help="frozen-SD teacher path (adapter disabled)")
    p.add_argument("--from-file", dest="from_file", type=str, default=None,
                   help="file with one prompt per line")
    p.add_argument("--n_rows", type=int, default=0,
                   help="grid row count (0 = no grid)")
    p.add_argument("--inference_loss", action="store_true",
                   help="attention-alignment guidance inside DDIM")
    p.add_argument("--factors", type=str, default=None,
                   help="comma list of condition factors to chain, e.g. "
                        "'seg,depth,normal': each factor is adapter-prompted "
                        "by the previous one; the last map drives the "
                        "ControlNet stage")
    p.add_argument("--factor_ckpts", type=str, default=None,
                   help="comma list of per-factor checkpoints (default "
                        "models/fgdm_<factor>.pth)")
    p.add_argument("--all_pconds", action="store_true",
                   help="multi-adapter composition: every earlier factor "
                        "feeds an extra adapter of each later factor")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the models run (cpu for tests)")
    return p


def sample_condition_maps(ld, cond_ctx, uncond_ctx, shape, steps: int,
                          scale: float, eta: float = 0.0,
                          sampler: str = "ddim", adapter_on: bool = True,
                          x_T=None, generator=None, guided: bool = False):
    """The factor-1 stage (JAX ``sample_f1``): condition latents ``z`` of
    ``shape`` (NCHW) and their decode in [-1, 1].  ``guided`` adds the
    attention-alignment guidance to the DDIM sampler."""
    fn = ld.denoise_fn(adapter_on=adapter_on)
    cond, uncond = {"c_crossattn": cond_ctx}, {"c_crossattn": uncond_ctx}
    noise = dict(x_T=x_T, generator=generator)
    if sampler == "dpm":
        z = dpm_solver_sample(fn, shape, ld.schedule, cond, uncond, scale,
                              steps=steps, **noise)
    else:
        sched = DDIMSchedule.create(ld.schedule, steps, eta=eta)
        if sampler == "plms":
            z = plms_sample(fn, shape, sched, cond, uncond, scale, **noise)
        else:
            gfn = ld.capture_fn(adapter_on=adapter_on) if guided else None
            z = ddim_sample(fn, shape, sched, cond, uncond, scale,
                            guidance_fn=gfn, **noise)
    with torch.inference_mode():
        return z, ld.decode_first_stage(z)


@torch.inference_mode()
def render_images(cldm, hint, cn_ctx, cn_uncond, x_T=None, generator=None):
    """The ControlNet stage (JAX ``sample_f2``): hint ``[B, 3, H, W]`` in
    [0, 1] -> images in [-1, 1], ``CN_STEPS`` DDIM steps at CFG
    ``CN_SCALE``."""
    z = chain_mod.sample_image_factor(cldm, hint, cn_ctx, cn_uncond,
                            num_steps=CN_STEPS, cfg_scale=CN_SCALE, x_T=x_T,
                            generator=generator)
    return cldm.decode_first_stage(z)


def to_uint8_nhwc(img: torch.Tensor) -> np.ndarray:
    """[-1, 1] NCHW -> uint8 NHWC on the host (``metrics.to_uint8``)."""
    return to_uint8(img.float().permute(0, 2, 3, 1).cpu().numpy())


def _write_png(path: str, arr: np.ndarray, resize: bool = False) -> str:
    if resize:
        from PIL import Image

        arr = np.asarray(Image.fromarray(arr).resize((512, 512)))
    with open(path, "wb") as f:
        f.write(png_bytes(np.ascontiguousarray(arr)))
    return path


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_factor_chain(opt, spec, dtype, dev):
    """The N-factor path (JAX ``_run_factor_chain``): load one pipeline per
    factor (factor k with ``max(1, k)`` adapters under ``--all_pconds``)
    and the ControlNet stage, run ``fgdm_chain_n`` ``--n_iter`` times and
    write the maps and images.  Returns the files, the load time and each
    run's wall time."""
    names = [s.strip() for s in opt.factors.split(",") if s.strip()]
    if not names:
        raise SystemExit("--factors given but empty")
    if opt.factor_ckpts:
        cks = [c.strip() or None for c in opt.factor_ckpts.split(",")]
        if len(cks) != len(names):
            raise SystemExit(f"--factor_ckpts has {len(cks)} entries for "
                             f"{len(names)} factors")
    else:
        cks = [f"models/fgdm_{n}.pth" for n in names]
    cks = [ck if ck and os.path.exists(ck) else None for ck in cks]
    cn_ckpt = None
    if opt.use_controlnet:
        cn_ckpt = opt.cn_ckpt or f"models/fgdm_control_sd15_{names[-1]}.pth"
        cn_ckpt = cn_ckpt if os.path.exists(cn_ckpt) else None
    tok = CLIPTokenizer(vocab_dir=opt.vocab_dir)
    if any(cks) or cn_ckpt is not None:
        tok.check_production("txt2img_fgdm")

    t0 = time.perf_counter()
    factors = []
    for k, (name, ck) in enumerate(zip(names, cks)):
        if ck is None:
            print(f"[txt2img_fgdm] factor '{name}': ckpt missing: random "
                  "init")
        n_prompts = max(1, k) if opt.all_pconds else 1
        if spec is not None:
            # the config's pipeline with factor k's adapters, from ck alone
            # (not the config's own ckpt_path)
            factors.append(dataclasses.replace(
                spec, unet_def=spec.unet_def.clone(num_prompts=n_prompts),
                ckpt_path=None).load(ck, device=dev))
        else:
            factors.append(load_fgdm(ck, dtype=dtype, device=dev,
                                     unet=loader.sd_unet(
                                         dtype, dev, num_prompts=n_prompts)))
    cldm = (load_controlnet(cn_ckpt, dtype=dtype, device=dev)
            if opt.use_controlnet else None)
    _sync(dev)
    load_s = time.perf_counter() - t0
    print(f"[txt2img_fgdm] models loaded in {load_s:.2f}s")

    def embed(pipe, texts):
        with torch.inference_mode():
            return pipe.get_learned_conditioning(tok(texts).to(dev))

    b = opt.n_samples
    # '|' splits per-factor prompts; the last one drives the factors after
    prompts = [s.strip() for s in opt.prompt.split("|")]
    prompts = (prompts + [prompts[-1]] * len(names))[:len(names)]
    factor_ctxs = [embed(ld_k, [p] * b) for ld_k, p in zip(factors, prompts)]
    empty_ctx = embed(factors[0], [opt.n_prompt] * b)
    cn_ctx = cn_neg = None
    if cldm is not None:
        cn_ctx = embed(cldm, [prompts[0] + ", " + chain_mod.A_PROMPT] * b)
        cn_neg = embed(cldm, [chain_mod.N_PROMPT] * b)
    image_hw = CN_HW if cldm is not None else (opt.H, opt.W)
    sampler = "plms" if opt.plms else ("dpm" if opt.dpm else "ddim")
    gen = torch.Generator(device=dev).manual_seed(opt.seed)

    os.makedirs(opt.outdir, exist_ok=True)
    written, chain_s = [], []
    for it in range(opt.n_iter):
        t0 = time.perf_counter()
        out = chain_mod.fgdm_chain_n(
            factors, cldm, factor_ctxs, empty_ctx, cn_prompt_ctx=cn_ctx,
            cn_neg_ctx=cn_neg, cond_hw=(opt.H, opt.W), image_hw=image_hw,
            factor_steps=opt.ddim_steps, factor_scale=opt.scale,
            f2_steps=CN_STEPS, f2_scale=CN_SCALE, all_pconds=opt.all_pconds,
            generator=gen, factor_sampler=sampler)
        _sync(dev)
        chain_s.append(time.perf_counter() - t0)
        print(f"[chain_n] {len(names)} factors"
              f"{' + image' if cldm is not None else ''}: {b} samples in "
              f"{chain_s[-1]:.2f}s ({b / chain_s[-1]:.3f} img/s)")
        for name, cond in zip(names, out["conditions"]):
            d = os.path.join(opt.outdir, f"factor_{name}")
            os.makedirs(d, exist_ok=True)
            # [0, 1] -> uint8 by truncation, as the JAX CLI writes them
            arr = (cond * 255).float().permute(0, 2, 3, 1).cpu().numpy()
            for i, a in enumerate(arr.astype(np.uint8)):
                written.append(_write_png(
                    os.path.join(d, f"{name}_{it:02}_{i:04}.png"), a))
        if out["image"] is not None:
            d = os.path.join(opt.outdir, f"{names[-1]}_images")
            os.makedirs(d, exist_ok=True)
            for i, a in enumerate(to_uint8_nhwc(out["image"])):
                written.append(_write_png(
                    os.path.join(d, f"image_{it:02}_{i:04}.png"), a))
    print(f"Samples written to {opt.outdir}")
    return {"files": written, "load_s": load_s, "chain_s": chain_s}


def main(argv=None):
    opt = get_parser().parse_args(argv)
    dev = resolve_device(opt.device)
    dtype = torch.float32 if opt.precision == "full" else torch.bfloat16

    # -- model assembly -----------------------------------------------------
    spec = None
    if opt.config and os.path.exists(opt.config):
        spec = instantiate_from_config(load_config(opt.config)["model"],
                                       dtype=dtype)
    if opt.factors:
        return _run_factor_chain(opt, spec, dtype, dev)
    sample_path = os.path.join(opt.outdir, "samples")
    os.makedirs(os.path.join(sample_path, "sample1"), exist_ok=True)
    ckpt = opt.ckpt if os.path.exists(opt.ckpt) else None
    if ckpt is None:
        print(f"[txt2img_fgdm] ckpt {opt.ckpt} not found: random init")
    cn_ckpt = None
    if opt.use_controlnet:
        cn_ckpt = opt.cn_ckpt or f"models/fgdm_control_sd15_{opt.cond}.pth"
        cn_ckpt = cn_ckpt if os.path.exists(cn_ckpt) else None
    tok = CLIPTokenizer(vocab_dir=opt.vocab_dir)
    if ckpt is not None or cn_ckpt is not None:
        tok.check_production("txt2img_fgdm")

    t0 = time.perf_counter()
    # the parsed config's modules, schedule and scale factor when there is one
    ld = (spec.load(ckpt, device=dev) if spec is not None
          else load_fgdm(ckpt, dtype=dtype, device=dev))
    if opt.inference_loss:
        # the guidance differentiates with respect to x alone
        ld.unet.requires_grad_(False)
    cldm = None
    if opt.use_controlnet:
        cldm = load_controlnet(cn_ckpt, dtype=dtype, device=dev)
    _sync(dev)
    load_s = time.perf_counter() - t0
    print(f"[txt2img_fgdm] models loaded in {load_s:.2f}s")

    b = opt.n_samples
    if opt.from_file:
        # one batch per n_samples prompts; the last is padded by repeating
        with open(opt.from_file) as f:
            prompts = [ln.strip() for ln in f if ln.strip()]
        if not prompts:
            raise SystemExit(f"--from-file {opt.from_file} has no prompts")
        prompt_batches = [prompts[i:i + b] for i in range(0, len(prompts), b)]
        prompt_batches = [pb + [pb[-1]] * (b - len(pb))
                          for pb in prompt_batches]
    else:
        prompt_batches = [[opt.prompt] * b]

    def embed(pipe, texts):
        with torch.inference_mode():
            return pipe.get_learned_conditioning(tok(texts).to(dev))

    uc = embed(ld, [opt.n_prompt] * b)
    cn_uncond = embed(cldm, [chain_mod.N_PROMPT] * b) if cldm else None
    gen = torch.Generator(device=dev).manual_seed(opt.seed)
    shape = (b, opt.C, opt.H // opt.f, opt.W // opt.f)
    x_T = (torch.randn(shape, generator=gen, device=dev) if opt.fixed_code
           else None)
    sampler = "plms" if opt.plms else ("dpm" if opt.dpm else "ddim")

    written, f1_s, f2_s = [], [], []
    for it in range(opt.n_iter):
        for pi, pbatch in enumerate(prompt_batches):
            c = embed(ld, pbatch)
            t0 = time.perf_counter()
            z, cond_img = sample_condition_maps(
                ld, c, uc, shape, opt.ddim_steps, opt.scale,
                eta=opt.ddim_eta, sampler=sampler,
                adapter_on=not opt.use_original, x_T=x_T, generator=gen,
                guided=opt.inference_loss)
            cond8 = to_uint8_nhwc(cond_img)
            f1_s.append(time.perf_counter() - t0)
            print(f"[factor1] {b} maps in {f1_s[-1]:.2f}s "
                  f"({b / f1_s[-1]:.3f} img/s)")

            tag = f"{it:02}_{pi:02}" if len(prompt_batches) > 1 else f"{it:02}"
            if opt.n_rows > 0 and not opt.skip_grid:
                written.append(_write_png(
                    os.path.join(sample_path, f"grid_{tag}.png"),
                    make_grid(cond8, nrow=opt.n_rows)))
            for i, arr in enumerate(cond8 if not opt.skip_save else []):
                written.append(_write_png(
                    os.path.join(sample_path, "sample1",
                                 f"sample1_{tag}_{i:04}.png"),
                    arr, resize=opt.resize))

            if cldm is not None:
                cn_ctx = embed(cldm, [p + ", " + chain_mod.A_PROMPT
                                      for p in pbatch])
                t2 = time.perf_counter()
                hint = chain_mod.latent_to_condition_image(ld, z, CN_HW)
                img8 = to_uint8_nhwc(render_images(cldm, hint, cn_ctx,
                                                   cn_uncond, generator=gen))
                f2_s.append(time.perf_counter() - t2)
                print(f"[factor2] {b} images in {f2_s[-1]:.2f}s "
                      f"({b / f2_s[-1]:.3f} img/s)")
                out_dir = os.path.join(sample_path, f"{opt.cond}_images")
                os.makedirs(out_dir, exist_ok=True)
                for i, arr in enumerate(img8):
                    written.append(_write_png(
                        os.path.join(out_dir, f"sample1_{tag}_{i:04}.png"),
                        arr))

    print(f"Samples written to {opt.outdir}")
    return {"files": written, "load_s": load_s, "factor1_s": f1_s,
            "factor2_s": f2_s}


if __name__ == "__main__":
    main()
