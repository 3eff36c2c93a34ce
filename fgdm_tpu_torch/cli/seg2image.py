"""Seg -> image rendering CLI over a directory of segmentation maps.

Counterpart of ``fgdm_tpu/cli/seg2image.py`` (the reference's
``controlnet/seg2image_inference.py``): loads the ControlNet stage (the
SD-1.5 ControlLDM layout, or a cldm YAML through ``--config``), reads the
maps under ``<data_dir>/sample2/`` (or ``data_dir`` itself), resizes each
NEAREST to ``--image_resolution``, renders it with ``--ddim_steps`` DDIM
steps at CFG ``--scale`` (``--eta``, ``--strength``, ``--guess_mode``) and
writes ``<name>_render.png`` under ``--outdir``.  ``--device`` (default
``cuda``) names where the models run.  Reading the maps needs Pillow.

With ``--detect`` the maps come from the photos under
``<data_dir>/sample1/``: each (NEAREST to ``--image_resolution``, then
BILINEAR to ``--detect_resolution``) goes through the UniFormer annotator
(``--seg_ckpt``, ``upernet_global_small.pth``; without it every weight is
0, as in JAX, and a NOTE says so), and its colourised ADE20K map, NEAREST
back to ``--image_resolution``, is the hint.

    python -m fgdm_tpu_torch.cli.seg2image --data_dir data/samples \\
        --cn_ckpt models/fgdm_control_sd15_seg.pth --prompt "a photo"
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np
import torch

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.checkpoint.loader import load_controlnet
from fgdm_tpu_torch.cli.txt2img_fgdm import _write_png, to_uint8_nhwc
from fgdm_tpu_torch.config import instantiate_from_config, load_config
from fgdm_tpu_torch.data.dataset import list_image_files
from fgdm_tpu_torch.models.clip import CLIPTokenizer
from fgdm_tpu_torch.sampling.chain import sample_image_factor


def get_parser():
    p = argparse.ArgumentParser(description="seg->image (ControlNet) "
                                            "renderer (PyTorch)")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--config", type=str, default=None,
                   help="cldm yaml (reference models/cldm_v15_*.yaml); "
                        "default = SD-1.5 ControlLDM layout")
    p.add_argument("--outdir", type=str, default="outputs/seg2image")
    p.add_argument("--cn_ckpt", type=str, default=None)
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--a_prompt", type=str,
                   default="best quality, extremely detailed")
    p.add_argument("--n_prompt", type=str,
                   default="longbody, lowres, bad anatomy, bad hands, "
                           "missing fingers, extra digit, fewer digits, "
                           "cropped, worst quality, low quality")
    p.add_argument("--ddim_steps", type=int, default=20)
    p.add_argument("--scale", type=float, default=9.0)
    p.add_argument("--strength", type=float, default=1.0)
    p.add_argument("--eta", type=float, default=0.0,
                   help="DDIM eta (reference process() slider default 0.0)")
    p.add_argument("--detect_resolution", type=int, default=512,
                   help="resolution the detector runs at (with --detect)")
    p.add_argument("--guess_mode", action="store_true")
    p.add_argument("--image_resolution", type=int, default=512)
    p.add_argument("--num_images", type=int, default=-1)
    p.add_argument("--detect", action="store_true",
                   help="run the UniFormer annotator on sample1 images "
                        "instead of using sample2 maps")
    p.add_argument("--seg_ckpt", type=str, default=None,
                   help="UniFormer weights for --detect (upernet_global_"
                        "small torch ckpt); without it the detector is "
                        "all-zero (debug only)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--precision", type=str, default="autocast")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the models run (cpu for tests)")
    return p


def _detector(opt, dtype, dev):
    """The UniFormer detector of ``--detect``: ``--seg_ckpt``'s weights, or
    every weight 0 without it (JAX ``cli/seg2image.py:109-131``)."""
    from fgdm_tpu_torch.annotators.uniformer import (UniFormerSeg,
                                                     UniformerDetector)
    from fgdm_tpu_torch.checkpoint.annotator_ingest import load_uniformer

    if opt.seg_ckpt:
        return load_uniformer(opt.seg_ckpt, input_size=opt.detect_resolution,
                              dtype=dtype, device=dev)
    model = UniFormerSeg(dtype=dtype, device=dev).requires_grad_(False)
    with torch.no_grad():
        for t in itertools.chain(model.parameters(), model.buffers()):
            t.zero_()
    print("[seg2image] NOTE: UniFormer weights are random-init — pass "
          "--seg_ckpt or precomputed maps for real use")
    return UniformerDetector(model.eval(), input_size=opt.detect_resolution)


def main(argv=None):
    opt = get_parser().parse_args(argv)
    from PIL import Image

    dev = resolve_device(opt.device)
    dtype = torch.float32 if opt.precision == "full" else torch.bfloat16
    os.makedirs(opt.outdir, exist_ok=True)

    cn_ckpt = (opt.cn_ckpt if opt.cn_ckpt and os.path.exists(opt.cn_ckpt)
               else None)
    tok = CLIPTokenizer()
    if cn_ckpt is not None:
        tok.check_production("seg2image")
    if opt.config:
        spec = instantiate_from_config(load_config(opt.config)["model"],
                                       dtype=dtype)
        cldm = spec.load(cn_ckpt, device=dev)
    else:
        cldm = load_controlnet(cn_ckpt, dtype=dtype, device=dev)

    def embed(texts):
        with torch.inference_mode():
            return cldm.get_learned_conditioning(tok(texts).to(dev))

    full_prompt = (opt.prompt + ", " + opt.a_prompt) if opt.prompt \
        else opt.a_prompt
    ctx, uc = embed([full_prompt]), embed([opt.n_prompt])

    seg_dir = os.path.join(opt.data_dir, "sample2")
    if opt.detect:
        files = list_image_files(os.path.join(opt.data_dir, "sample1"))
    else:
        files = list_image_files(seg_dir if os.path.isdir(seg_dir)
                                 else opt.data_dir)
    if opt.num_images > 0:
        files = files[: opt.num_images]
    detector = _detector(opt, dtype, dev) if opt.detect else None

    gen = torch.Generator(device=dev).manual_seed(opt.seed)
    res = opt.image_resolution
    written = []
    for i, path in enumerate(files):
        img = Image.open(path).convert("RGB").resize((res, res),
                                                     Image.NEAREST)
        arr = np.asarray(img)
        if detector is not None:
            # the detector runs at --detect_resolution (reference
            # process(), seg2image_inference.py:43-60)
            det = opt.detect_resolution
            if det != res:
                arr = np.asarray(Image.fromarray(arr).resize(
                    (det, det), Image.BILINEAR))
            arr = detector(arr)
            if det != res:
                arr = np.asarray(Image.fromarray(arr).resize(
                    (res, res), Image.NEAREST))
        hint = (torch.from_numpy(arr.copy()).permute(2, 0, 1)
                [None].float().to(dev) / 255.0)
        z = sample_image_factor(cldm, hint, ctx, uc,
                                num_steps=opt.ddim_steps,
                                cfg_scale=opt.scale, eta=opt.eta,
                                strength=opt.strength,
                                guess_mode=opt.guess_mode, generator=gen)
        with torch.inference_mode():
            out8 = to_uint8_nhwc(cldm.decode_first_stage(z))
        name = os.path.splitext(os.path.basename(path))[0]
        written.append(_write_png(
            os.path.join(opt.outdir, f"{name}_render.png"), out8[0]))
        print(f"[{i + 1}/{len(files)}] {name}")
    print(f"Renders written to {opt.outdir}")
    return written


if __name__ == "__main__":
    main()
