"""Evaluation CLI: CLIP score, FID and the condition-adherence metrics of
FG-DM samples, flag for flag, error for error and key for key the JAX
package's ``fgdm_tpu/cli/eval.py``.

One command either generates samples from a checkpoint and a prompt file
(the factor-1 pipeline of ``cli/txt2img_fgdm.py``: DDIM under CFG, decoded,
clipped to [0, 1]) and scores them, or scores an image directory
(``--images_dir``, the clean-fid offline workflow).  The metrics go out as
one JSON object, on stdout and to ``--out``: ``clip_score`` (prompts given;
``--clip_ckpt``, an OpenAI- or HF-schema CLIP file read by the fuzzy ingest
of ``checkpoint/fuzzy_ingest.py``), ``fid`` and ``fid_backend`` (with
``--ref_dir``: InceptionV3 pool3 with ``--inception_ckpt``, else the CLIP
tower), ``miou`` and ``miou_classes`` (``--cond_dir`` + ``--seg_ckpt``,
UniFormer re-segmentation), ``depth_rmse_ssi``/``depth_mae_ssi`` and the
normal angles (``--depth_dir``/``--normal_dir`` + ``--midas_ckpt``),
``sketch_f1`` (``--sketch_dir`` + ``--pidinet_ckpt``) and ``pose_f1``
(``--pose_dir`` + ``--openpose_ckpt``), beside ``n_images``.  It fails
loud where weights or the CLIP vocabulary are absent: random towers or a
hash-fallback tokenizer would make plausible-looking garbage
(``FGDM_ALLOW_HASH_TOKENIZER=1`` lets the tokenizer pass for smoke runs).

``--device`` (default ``cuda``) names where the models run.  Generation
runs the UNet and VAE in ``--precision`` (bf16 under ``autocast``), through
the kernels the sampler's gates admit; the metric networks run in float32
with TF32 off (``fgdm_tpu_torch.full_f32``) as plain PyTorch ops, as JAX's
are XLA ops.  Generation's noise is one ``torch.randn`` draw per prompt
chunk from a generator seeded with ``--seed`` (torch cannot reproduce
``jax.random``'s bits; ``_generate`` takes injected x_T).

    python -m fgdm_tpu_torch.cli.eval --config models/config.yaml \\
        --ckpt models/fgdm_seg.pth --from-file prompts.txt \\
        --clip_ckpt clip-vit-large-patch14.bin --ref_dir coco_val \\
        --inception_ckpt pt_inception-2015-12-21.pth --out metrics.json
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fgdm_tpu_torch import full_f32, resolve_device


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="FG-DM evaluation (PyTorch)")
    # generation (ignored with --images_dir)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--from-file", dest="from_file", type=str, default=None,
                   help="file with one prompt per line")
    p.add_argument("--n_samples", type=int, default=4,
                   help="samples per generation batch")
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--scale", type=float, default=7.5)
    p.add_argument("--H", type=int, default=256)
    p.add_argument("--W", type=int, default=256)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--precision", type=str, default="autocast",
                   choices=["autocast", "full"])
    p.add_argument("--outdir", type=str, default=None,
                   help="also save generated samples here")
    # scoring inputs
    p.add_argument("--images_dir", type=str, default=None,
                   help="score this directory instead of generating; "
                        "CLIP score pairs images (sorted) with prompts")
    p.add_argument("--ref_dir", type=str, default=None,
                   help="real-image directory (enables FID)")
    p.add_argument("--cond_dir", type=str, default=None,
                   help="requested condition maps (colorized ADE seg, "
                        "sorted to pair with the images) — enables the "
                        "mIoU adherence metric: generated images are "
                        "re-segmented and compared against these maps")
    p.add_argument("--seg_ckpt", type=str, default=None,
                   help="UniFormer seg checkpoint used to re-annotate "
                        "generated images for mIoU")
    p.add_argument("--depth_dir", type=str, default=None,
                   help="requested depth maps (grayscale, sorted to pair "
                        "with the images) — enables scale-shift-invariant "
                        "depth adherence via MiDaS re-annotation")
    p.add_argument("--midas_ckpt", type=str, default=None,
                   help="MiDaS dpt_hybrid checkpoint for "
                        "--depth_dir/--normal_dir")
    p.add_argument("--normal_dir", type=str, default=None,
                   help="requested normal maps (RGB-encoded [-1,1], sorted "
                        "to pair with the images) — enables angular-error "
                        "adherence via MiDaS depth→normal re-annotation")
    p.add_argument("--sketch_dir", type=str, default=None,
                   help="requested sketch/edge maps (grayscale, sorted to "
                        "pair with the images) — enables edge-F1 adherence "
                        "via PiDiNet re-annotation")
    p.add_argument("--pidinet_ckpt", type=str, default=None,
                   help="PiDiNet table5 checkpoint for --sketch_dir")
    p.add_argument("--pose_dir", type=str, default=None,
                   help="requested skeleton renders (sorted to pair with "
                        "the images) — enables pose adherence: generated "
                        "images are re-annotated with OpenPose and scored "
                        "as tolerant skeleton-F1")
    p.add_argument("--openpose_ckpt", type=str, default=None,
                   help="OpenPose body_pose checkpoint for --pose_dir")
    # metric backends
    p.add_argument("--clip_ckpt", type=str, default=None,
                   help="CLIP checkpoint (vision+text towers) for the "
                        "scorer; required unless a scorer is injected")
    p.add_argument("--inception_ckpt", type=str, default=None,
                   help="InceptionV3 FID checkpoint "
                        "(pt_inception-2015-12-21 / torchvision schema)")
    p.add_argument("--vocab_dir", type=str, default=None,
                   help="dir with CLIP vocab.json+merges.txt")
    p.add_argument("--out", type=str, default=None,
                   help="write the metrics JSON here too")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the models run (cpu for tests)")
    return p


def _load_dir_images(d: str, size=None, nearest: bool = False) -> np.ndarray:
    """PNG/JPG directory -> ``[N, H, W, 3]`` float in [0, 1] (sorted
    order).  ``size``: int or (h, w) target; ``nearest=True`` for
    label-colorized maps (bicubic would blend palette colours)."""
    from PIL import Image

    files = sorted(
        os.path.join(d, f) for f in os.listdir(d)
        if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if not files:
        raise SystemExit(f"[eval] no images under {d}")
    if size is not None and not isinstance(size, (tuple, list)):
        size = (size, size)
    ims = []
    for f in files:
        im = Image.open(f).convert("RGB")
        if size is not None:
            im = im.resize((size[1], size[0]),  # PIL takes (W, H)
                           Image.NEAREST if nearest else Image.BICUBIC)
        ims.append(np.asarray(im, np.float32) / 255.0)
    if size is None:
        hw = ims[0].shape
        if any(i.shape != hw for i in ims):
            raise SystemExit(f"[eval] images under {d} have mixed sizes; "
                             "pass same-size images")
    return np.stack(ims)


def ingest_clip_towers(sd, vision, text):
    """Strict fuzzy ingest of an OpenAI- or HF-schema CLIP state dict into
    the port's ``vision`` / ``text`` towers -> (vision state dict, text
    state dict, text projection ``[embed, proj]``), JAX's
    ``ingest_clip_towers``.

    OpenAI's fused ``attn.in_proj_*`` is split into q/k/v rows; the
    non-parameters (``position_ids``, ``logit_scale``, ``attn_mask``,
    ``num_batches_tracked``) are dropped; a key holding ``visual`` or
    ``vision`` goes to the vision tower, the rest but the projection to the
    text tower; each tower's slots are JAX's (``utils/clip_score.
    flax_paths``).  The text projection is transposed when stored
    HF-style.  Raises ``SystemExit`` (JAX's text) when a checkpoint key
    goes unconsumed, a tower parameter would keep its init, or the file has
    no text projection."""
    from fgdm_tpu_torch.checkpoint.fuzzy_ingest import (apply_mapping,
                                                        match_state_dict)
    from fgdm_tpu_torch.utils.clip_score import flax_paths

    def strict_ingest(sub, module, label):
        slots = flax_paths(module)
        own = module.state_dict()
        expect = {p: tuple(own[k].shape) for p, k in slots.items()}
        mapping, unmatched_t, unmatched_f = match_state_dict(sub, expect)
        if unmatched_t:
            raise SystemExit(
                f"[eval] CLIP {label} ingest failed: {len(unmatched_t)} "
                f"unconsumed ckpt params, e.g. {unmatched_t[:4]}")
        if unmatched_f:
            raise SystemExit(
                f"[eval] CLIP {label} ingest failed: {len(unmatched_f)} "
                f"tower params left at random init, e.g. {unmatched_f[:4]}")
        return apply_mapping(sub, mapping, slots)

    def split_fused_qkv(d):
        out = {}
        for k, v in d.items():
            if k.endswith(("attn.in_proj_weight", "attn.in_proj_bias")):
                q, kk, vv = torch.as_tensor(v).chunk(3, dim=0)
                stem = k.replace("in_proj_weight", "").replace(
                    "in_proj_bias", "")
                leaf = "weight" if k.endswith("weight") else "bias"
                out[f"{stem}q_proj.{leaf}"] = q
                out[f"{stem}k_proj.{leaf}"] = kk
                out[f"{stem}v_proj.{leaf}"] = vv
            else:
                out[k] = v
        return out

    sd = split_fused_qkv(sd)
    drop = ("position_ids", "logit_scale", "attn_mask",
            "num_batches_tracked")
    sd = {k: v for k, v in sd.items() if not k.endswith(drop)}
    vis_sd = {k: v for k, v in sd.items() if "visual" in k or "vision" in k}
    txt_sd = {k: v for k, v in sd.items()
              if not ("visual" in k or "vision" in k
                      or "text_projection" in k)}
    vparams = strict_ingest(vis_sd, vision, "vision")
    tparams = strict_ingest(txt_sd, text, "text")
    proj = (sd["text_projection"] if "text_projection" in sd
            else sd.get("text_projection.weight"))
    if proj is None:
        raise SystemExit("[eval] CLIP ckpt lacks text_projection")
    proj = torch.as_tensor(proj).float()
    if proj.shape[0] != text.text_model.final_layer_norm.weight.shape[0]:
        proj = proj.T  # HF stores [proj, embed]
    return vparams, tparams, proj.contiguous()


def default_scorer_factory(opt):
    """A production ``CLIPScorer`` from ``--clip_ckpt`` through the fuzzy
    matcher; fails loud on missing weights or vocabulary."""
    from fgdm_tpu_torch.checkpoint.torch_ingest import load_torch_state_dict
    from fgdm_tpu_torch.models.clip import CLIPTextEncoder, CLIPTokenizer
    from fgdm_tpu_torch.utils.clip_score import CLIPScorer, CLIPVisionEncoder

    if not (opt.clip_ckpt and os.path.exists(opt.clip_ckpt)):
        raise SystemExit(
            "[eval] --clip_ckpt is required (CLIP score with random towers "
            "is meaningless); pass the OpenAI/HF CLIP checkpoint path")
    tok = CLIPTokenizer(vocab_dir=opt.vocab_dir)
    tok.check_production("eval")

    dev = resolve_device(opt.device)
    vision = CLIPVisionEncoder(device=dev)
    text = CLIPTextEncoder(device=dev)
    vparams, tparams, proj = ingest_clip_towers(
        load_torch_state_dict(opt.clip_ckpt), vision, text)
    vision.load_state_dict(vparams)
    text.load_state_dict(tparams)
    return CLIPScorer(vision, text, proj), tok


def default_fid_backend(opt, scorer) -> Tuple[Callable, int, str]:
    if opt.inception_ckpt:
        if not os.path.exists(opt.inception_ckpt):
            raise SystemExit(
                f"[eval] --inception_ckpt {opt.inception_ckpt} not found")
        from fgdm_tpu_torch.checkpoint.torch_ingest import (
            load_torch_state_dict)
        from fgdm_tpu_torch.utils.inception import (inception_feature_fn,
                                                    ingest_inception)

        net = ingest_inception(load_torch_state_dict(opt.inception_ckpt),
                               device=resolve_device(opt.device))
        fn, dim = inception_feature_fn(net)
        return fn, dim, "inception_pool3"
    from fgdm_tpu_torch.utils.fid import clip_feature_fn

    fn, dim = clip_feature_fn(scorer)
    return fn, dim, "clip"


def default_segmenter_factory(opt):
    """The mIoU re-annotator from ``--seg_ckpt`` -> (labels_fn,
    num_classes, palette); ``labels_fn`` maps ``[B, H, W, 3]`` float in
    [0, 1] to ``[B, H, W]`` int32 ADE labels."""
    if not (opt.seg_ckpt and os.path.exists(opt.seg_ckpt)):
        raise SystemExit(
            "[eval] --cond_dir needs --seg_ckpt (UniFormer weights) to "
            "re-segment generated images for mIoU")
    from fgdm_tpu_torch.checkpoint.annotator_ingest import load_uniformer
    from fgdm_tpu_torch.data.colorize import ade_cmap

    try:
        det = load_uniformer(opt.seg_ckpt, device=resolve_device(opt.device))
    except ValueError as e:
        raise SystemExit(f"[eval] {e}")

    def labels_fn(img01: np.ndarray) -> np.ndarray:
        with full_f32():
            return det.labels(
                (np.clip(img01, 0.0, 1.0) * 255).astype(np.uint8))

    return labels_fn, det.model.num_classes, ade_cmap()[1:]


def _miou(opt, imgs, segmenter_factory) -> Tuple[float, int]:
    """Re-segment ``imgs`` and score them against the ``--cond_dir`` maps."""
    from fgdm_tpu_torch.utils.seg_metrics import (confusion_matrix,
                                                  labels_from_colorized,
                                                  miou_from_confusion)

    labels_fn, num_classes, cmap = segmenter_factory(opt)
    conds = _load_dir_images(opt.cond_dir, size=imgs.shape[1:3],
                             nearest=True)
    if len(conds) != len(imgs):
        raise SystemExit(
            f"[eval] {len(imgs)} images vs {len(conds)} condition maps — "
            "mIoU pairs them in sorted order")
    gt = labels_from_colorized(conds, cmap)
    cm = np.zeros((num_classes, num_classes), np.int64)
    for i in range(0, len(imgs), 8):
        pred = labels_fn(imgs[i:i + 8])
        cm += confusion_matrix(pred, gt[i:i + 8], num_classes)
    return miou_from_confusion(cm)


_MIDAS_MEMO: dict = {}


def _load_midas_det(opt, flag: str):
    if not (opt.midas_ckpt and os.path.exists(opt.midas_ckpt)):
        raise SystemExit(
            f"[eval] {flag} needs --midas_ckpt (MiDaS dpt_hybrid weights) "
            "to re-annotate generated images")
    if opt.midas_ckpt not in _MIDAS_MEMO:
        from fgdm_tpu_torch.checkpoint.annotator_ingest import load_midas

        try:
            _MIDAS_MEMO[opt.midas_ckpt] = load_midas(
                opt.midas_ckpt, device=resolve_device(opt.device))
        except ValueError as e:
            raise SystemExit(f"[eval] {e}")
    return _MIDAS_MEMO[opt.midas_ckpt]


def _midas(det, img01: np.ndarray):
    """MiDaS at 384^2 (``jax.image.resize(..., "bilinear")`` of the image in
    [-1, 1]) -> (depth01 ``[B, 384, 384]``, normal ``[B, 384, 384, 3]``),
    numpy."""
    from fgdm_tpu_torch.annotators.uniformer import resize_bilinear

    dev = next(det.model.parameters()).device
    x = torch.from_numpy(np.asarray(img01, np.float32)).to(dev)
    with full_f32():
        x = resize_bilinear(x.permute(0, 3, 1, 2) * 2.0 - 1.0, (384, 384))
        depth01, normal = det(x)
    return depth01.cpu().numpy(), normal.permute(0, 2, 3, 1).cpu().numpy()


def default_depth_factory(opt):
    """--midas_ckpt -> depth_fn: ``[B, H, W, 3]`` in [0, 1] -> ``[B, H,
    W]`` relative inverse depth in [0, 1] (MiDaS convention, run at
    384^2)."""
    det = _load_midas_det(opt, "--depth_dir")
    return lambda img01: _midas(det, img01)[0]


def default_normal_factory(opt):
    """--midas_ckpt -> normal_fn: ``[B, H, W, 3]`` in [0, 1] -> ``[B, H, W,
    3]`` normal vectors (MiDaS depth -> normal, the condition-synthesis
    convention)."""
    det = _load_midas_det(opt, "--normal_dir")
    return lambda img01: _midas(det, img01)[1]


def default_sketch_factory(opt):
    """--pidinet_ckpt -> edge_fn: ``[B, H, W, 3]`` in [0, 1] -> ``[B, H,
    W]`` edge probabilities in [0, 1]."""
    if not (opt.pidinet_ckpt and os.path.exists(opt.pidinet_ckpt)):
        raise SystemExit(
            "[eval] --sketch_dir needs --pidinet_ckpt (PiDiNet weights) "
            "to re-detect edges on generated images")
    from fgdm_tpu_torch.checkpoint.annotator_ingest import load_pidinet

    dev = resolve_device(opt.device)
    try:
        model = load_pidinet(opt.pidinet_ckpt, device=dev)
    except ValueError as e:
        raise SystemExit(f"[eval] {e}")

    @torch.no_grad()
    def edge_fn(img01: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(img01, np.float32)).to(dev)
        with full_f32():
            out = model(x.permute(0, 3, 1, 2) * 2.0 - 1.0)
        # PiDiNet emits [-1, 1] (the condition-image convention) -> [0, 1]
        return (out[:, 0].cpu().numpy() + 1.0) / 2.0

    return edge_fn


def default_pose_factory(opt):
    """--openpose_ckpt -> pose_fn: ``[B, H, W, 3]`` in [0, 1] -> ``[B, H, W,
    3]`` rendered skeleton maps in [0, 1] (the network on the device, the
    peak grouping on the host, image by image)."""
    if not (opt.openpose_ckpt and os.path.exists(opt.openpose_ckpt)):
        raise SystemExit(
            "[eval] --pose_dir needs --openpose_ckpt (OpenPose body_pose "
            "weights) to re-detect poses on generated images")
    from fgdm_tpu_torch.checkpoint.annotator_ingest import load_openpose

    try:
        det = load_openpose(opt.openpose_ckpt,
                            device=resolve_device(opt.device))
    except ValueError as e:
        raise SystemExit(f"[eval] {e}")

    def pose_fn(img01: np.ndarray) -> np.ndarray:
        renders = [det((np.clip(im, 0.0, 1.0) * 255).astype(np.uint8))
                   for im in np.asarray(img01)]
        return np.stack(renders).astype(np.float32) / 255.0

    return pose_fn


def _reannotate(opt, imgs, factory, cond_dir: str, what: str):
    """Run ``factory(opt)`` over ``imgs`` in batches of 8 and load the
    requested maps, resized to the prediction grid (``jax.image.resize(...,
    "bilinear")``) -> (pred, gt01) of matching shapes."""
    from fgdm_tpu_torch.annotators.uniformer import resize_bilinear

    fn = factory(opt)
    conds = _load_dir_images(cond_dir)
    if len(conds) != len(imgs):
        raise SystemExit(
            f"[eval] {len(imgs)} images vs {len(conds)} {what} maps — "
            "adherence pairs them in sorted order")
    pred = np.concatenate([np.asarray(fn(imgs[i:i + 8]))
                           for i in range(0, len(imgs), 8)])
    if pred.shape[1:3] != conds.shape[1:3]:
        conds = resize_bilinear(torch.from_numpy(conds).permute(0, 3, 1, 2),
                                pred.shape[1:3]).permute(0, 2, 3, 1).numpy()
    return pred, conds


def _depth(opt, imgs, depth_factory) -> dict:
    """Re-estimate depth from ``imgs`` and score it against
    ``--depth_dir``."""
    from fgdm_tpu_torch.utils.depth_metrics import depth_adherence

    pred, conds = _reannotate(opt, imgs, depth_factory, opt.depth_dir,
                              "depth")
    return depth_adherence(pred, conds.mean(-1))


def _read_prompts(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _generate(opt, tok, x_T: Optional[Sequence] = None
              ) -> Tuple[np.ndarray, List[str]]:
    """Sample images for the prompts -> (``[N, H, W, 3]`` in [0, 1],
    prompts).  ``x_T``: one ``[n_samples, C, H/8, W/8]`` start per prompt
    chunk, else drawn from ``--seed``."""
    from fgdm_tpu_torch.checkpoint.loader import load_fgdm
    from fgdm_tpu_torch.cli.txt2img_fgdm import _write_png
    from fgdm_tpu_torch.config import instantiate_from_config, load_config
    from fgdm_tpu_torch.core.schedules import DDIMSchedule
    from fgdm_tpu_torch.sampling.ddim import ddim_sample

    dev = resolve_device(opt.device)
    dtype = torch.float32 if opt.precision == "full" else torch.bfloat16
    spec = None
    if opt.config and os.path.exists(opt.config):
        spec = instantiate_from_config(load_config(opt.config)["model"],
                                       dtype=dtype)
    ckpt = opt.ckpt if (opt.ckpt and os.path.exists(opt.ckpt)) else None
    if opt.ckpt and ckpt is None:
        raise SystemExit(f"[eval] --ckpt {opt.ckpt} not found — metrics on "
                         "a random-init model are meaningless")
    ld = (spec.load(ckpt, device=dev) if spec is not None
          else load_fgdm(ckpt, dtype=dtype, device=dev))

    if opt.from_file:
        prompts = _read_prompts(opt.from_file)
    elif opt.prompt:
        prompts = [opt.prompt]
    else:
        raise SystemExit("[eval] need --prompt or --from-file (or "
                         "--images_dir to skip generation)")

    b = opt.n_samples
    sched = DDIMSchedule.create(ld.schedule, opt.ddim_steps)
    with torch.inference_mode():
        uc = ld.get_learned_conditioning(tok([""] * b).to(dev))
    shape = (b, ld.unet.in_channels, opt.H // 8, opt.W // 8)
    gen = torch.Generator(device=dev).manual_seed(opt.seed)
    chunks = [prompts[i:i + b] for i in range(0, len(prompts), b)]
    imgs, used = [], []
    for j, pb in enumerate(chunks):
        padded = pb + [pb[-1]] * (b - len(pb))
        xt = (torch.as_tensor(np.asarray(x_T[j]), device=dev)
              if x_T is not None
              else torch.randn(shape, generator=gen, device=dev))
        with torch.inference_mode():
            ctx = ld.get_learned_conditioning(tok(padded).to(dev))
            z = ddim_sample(ld.denoise_fn(), shape, sched,
                            {"c_crossattn": ctx}, {"c_crossattn": uc},
                            cfg_scale=opt.scale, x_T=xt)
            x = ld.decode_first_stage(z).float()
        img01 = ((x + 1.0) / 2.0).clamp(0.0, 1.0).permute(0, 2, 3, 1)
        imgs.append(img01.cpu().numpy()[: len(pb)])
        used += pb
    out = np.concatenate(imgs)
    if opt.outdir:
        os.makedirs(opt.outdir, exist_ok=True)
        for i, a in enumerate((out * 255).astype(np.uint8)):
            _write_png(os.path.join(opt.outdir, f"{i:05}.png"), a)
    return out, used


def main(argv: Optional[Sequence[str]] = None,
         scorer_factory=default_scorer_factory,
         fid_backend_factory=default_fid_backend,
         segmenter_factory=default_segmenter_factory,
         depth_factory=default_depth_factory,
         normal_factory=default_normal_factory,
         sketch_factory=default_sketch_factory,
         pose_factory=default_pose_factory) -> dict:
    opt = get_parser().parse_args(argv)

    # the CLIP towers are needed for CLIP score, CLIP-FID and generation
    # only: an mIoU-only or Inception-FID run must not demand --clip_ckpt
    _clip = {}

    def clip_backend():
        if not _clip:
            _clip["scorer"], _clip["tok"] = scorer_factory(opt)
        return _clip["scorer"], _clip["tok"]

    if opt.images_dir:
        imgs = _load_dir_images(opt.images_dir)
        prompts: List[str] = []
        if opt.from_file:
            prompts = _read_prompts(opt.from_file)
        elif opt.prompt:
            prompts = [opt.prompt] * len(imgs)
        if prompts and len(prompts) != len(imgs):
            raise SystemExit(
                f"[eval] {len(imgs)} images vs {len(prompts)} prompts — "
                "CLIP score needs one prompt per (sorted) image")
    else:
        imgs, prompts = _generate(opt, clip_backend()[1])

    if not (prompts or opt.ref_dir or opt.cond_dir or opt.depth_dir
            or opt.normal_dir or opt.sketch_dir or opt.pose_dir):
        raise SystemExit(
            "[eval] nothing to score: give prompts (--prompt/--from-file) "
            "for CLIP score, --ref_dir for FID, or a condition dir "
            "(--cond_dir/--depth_dir/--normal_dir/--sketch_dir/--pose_dir) "
            "for adherence metrics")

    metrics: dict = {"n_images": int(imgs.shape[0])}
    if prompts:
        scorer, tok = clip_backend()
        ids = tok(prompts)
        scores = [np.asarray(scorer.score(imgs[i:i + 16], ids[i:i + 16]))
                  for i in range(0, len(prompts), 16)]
        metrics["clip_score"] = float(np.mean(np.concatenate(scores)))

    if opt.ref_dir:
        from fgdm_tpu_torch.utils.fid import compute_fid

        feat_fn, dim, backend = fid_backend_factory(
            opt, None if opt.inception_ckpt else clip_backend()[0])
        real = _load_dir_images(opt.ref_dir)

        def batches(arr, bs=16):
            for i in range(0, arr.shape[0], bs):
                yield arr[i:i + bs]

        metrics["fid"] = float(compute_fid(
            batches(real), batches(imgs), feat_fn, dim))
        metrics["fid_backend"] = backend

    if opt.cond_dir:
        miou, n_classes = _miou(opt, imgs, segmenter_factory)
        metrics["miou"] = miou
        metrics["miou_classes"] = n_classes

    if opt.depth_dir:
        metrics.update(_depth(opt, imgs, depth_factory))

    if opt.normal_dir:
        from fgdm_tpu_torch.utils.depth_metrics import normal_angular_error

        pred, conds = _reannotate(opt, imgs, normal_factory,
                                  opt.normal_dir, "normal")
        metrics.update(normal_angular_error(pred, conds * 2.0 - 1.0))

    if opt.sketch_dir:
        from fgdm_tpu_torch.utils.edge_metrics import edge_f1

        pred, conds = _reannotate(opt, imgs, sketch_factory,
                                  opt.sketch_dir, "sketch")
        metrics.update(edge_f1(pred, conds.mean(-1)))

    if opt.pose_dir:
        from fgdm_tpu_torch.utils.pose_metrics import skeleton_f1

        pred, conds = _reannotate(opt, imgs, pose_factory,
                                  opt.pose_dir, "pose")
        metrics.update(skeleton_f1(pred, conds))

    line = json.dumps(metrics)
    print(line)
    if opt.out:
        with open(opt.out, "w") as f:
            f.write(line + "\n")
    return metrics


if __name__ == "__main__":
    main()
