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
``autocast`` in bf16.

Not ported, and refused with ``NotImplementedError``: ``--factors`` and
``--all_pconds`` (``fgdm_chain_n`` and the multi-adapter UNet, ROADMAP
Queue A item 7) and ``--inference_loss`` (attention capture, item 13).

    python -m fgdm_tpu_torch.cli.txt2img_fgdm --config models/config.yaml \\
        --ckpt models/fgdm_seg.pth --n_samples 5 --ddim_steps 50 \\
        --H 256 --W 256 --use_controlnet

PNGs are written by ``server.png_bytes`` (no Pillow); ``--resize`` needs
Pillow.  ``main`` returns the files it wrote and its timings.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from fgdm_tpu_torch import resolve_device
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
                   help="attention-alignment guidance inside DDIM "
                        "(not ported)")
    p.add_argument("--factors", type=str, default=None,
                   help="comma list of condition factors to chain "
                        "(not ported)")
    p.add_argument("--factor_ckpts", type=str, default=None,
                   help="comma list of per-factor checkpoints (with "
                        "--factors, not ported)")
    p.add_argument("--all_pconds", action="store_true",
                   help="multi-adapter composition (not ported)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the models run (cpu for tests)")
    return p


@torch.inference_mode()
def sample_condition_maps(ld, cond_ctx, uncond_ctx, shape, steps: int,
                          scale: float, eta: float = 0.0,
                          sampler: str = "ddim", adapter_on: bool = True,
                          x_T=None, generator=None):
    """The factor-1 stage (JAX ``sample_f1``): condition latents ``z`` of
    ``shape`` (NCHW) and their decode in [-1, 1]."""
    fn = ld.denoise_fn(adapter_on=adapter_on)
    cond, uncond = {"c_crossattn": cond_ctx}, {"c_crossattn": uncond_ctx}
    noise = dict(x_T=x_T, generator=generator)
    if sampler == "dpm":
        z = dpm_solver_sample(fn, shape, ld.schedule, cond, uncond, scale,
                              steps=steps, **noise)
    else:
        sched = DDIMSchedule.create(ld.schedule, steps, eta=eta)
        run = plms_sample if sampler == "plms" else ddim_sample
        z = run(fn, shape, sched, cond, uncond, scale, **noise)
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


def main(argv=None):
    opt = get_parser().parse_args(argv)
    if opt.factors or opt.all_pconds:
        raise NotImplementedError(
            "--factors/--all_pconds: fgdm_chain_n and the multi-adapter UNet "
            "are not ported yet (ROADMAP Queue A item 7)")
    if opt.inference_loss:
        raise NotImplementedError(
            "--inference_loss: attention capture is not ported yet (ROADMAP "
            "Queue A item 13)")

    dev = resolve_device(opt.device)
    dtype = torch.float32 if opt.precision == "full" else torch.bfloat16
    sample_path = os.path.join(opt.outdir, "samples")
    os.makedirs(os.path.join(sample_path, "sample1"), exist_ok=True)

    # -- model assembly -----------------------------------------------------
    spec = None
    if opt.config and os.path.exists(opt.config):
        spec = instantiate_from_config(load_config(opt.config)["model"],
                                       dtype=dtype)
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
    cldm = None
    if opt.use_controlnet:
        cldm = load_controlnet(cn_ckpt, dtype=dtype, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
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
                adapter_on=not opt.use_original, x_T=x_T, generator=gen)
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
