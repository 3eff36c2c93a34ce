"""The two training recipes the training CLI does not cover, at full width
on one device, fed by the COCO loader, with a checkpoint round trip.

    python -m fgdm_tpu_torch.cli.recipes control   # 512^2 ControlLDM, sd_locked
    python -m fgdm_tpu_torch.cli.recipes joint     # 256^2 SeqTwoUNet adapter

Counterpart of ``tools/hw_validate_recipes.py``:

* ``control``: ControlNet fine-tuning (``train/control.py``, reference
  ``cldm.py:924-931``): the SD UNet without adapter (activation
  checkpointing, fused GroupNorm+SiLU), the VAE (fused), CLIP and the
  ControlNet (fused), seeded; only the UNet's zero-init heads are
  randomized, so the ControlNet's zero convs start at true zero, as in the
  reference.  AdamW 1e-5 with ``sd_locked``; the target is the COCO RGB
  image, the hint the colourised segmentation in [0, 1].  ``STEPS`` steps,
  a checkpoint round trip, then 2 steps from a fresh loader.
* ``joint``: joint two-factor training (``train/joint.py``, reference
  ``ddpm.py:1851-1927``): ``SeqTwoUNet(image_adapter=True, remat=True)``
  with its zero-init heads randomized; both halves of the latent are VAE
  posterior samples (RGB image, colourised segmentation) times 0.18215,
  the context CLIP's.  ``STEPS + 2`` steps, the round trip after step
  ``STEPS - 1``.

Environment: ``FGDM_COCO_DIR`` (default ``fgdm_coco`` in the temporary
directory), ``FGDM_HW_STEPS`` (default 12), ``FGDM_HW_BATCH`` (default 2
for control, 4 for joint).  Prints one JSON line (``recipe``, ``batch``,
``res``, ``steps``, ``losses``, ``wall_s``, and each step's ms to its
metrics' read-back and, on a CUDA device, the peak memory) and writes
``logs/hw_<recipe>/metrics.jsonl``.  The round trip saves the whole train
state with ``checkpoint/state_io.py``, reads it back to host tensors (never
a second copy on the device) and compares every twelfth trainable tensor
with the live one.  ``--device`` (default ``cuda``) names where it runs.

The ``build_*`` functions take the modules as arguments (full-width SD-1.4
modules by default), so that tests can run the recipes at a tiny width.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.checkpoint.loader import (SD_SCHEDULE, sd_clip,
                                              sd_controlnet, sd_unet, sd_vae,
                                              seeded_init_)
from fgdm_tpu_torch.checkpoint.state_io import CheckpointManager
from fgdm_tpu_torch.core.schedules import DiffusionSchedule
from fgdm_tpu_torch.data.dataset import load_data
from fgdm_tpu_torch.data.prefetch import ParallelBatchLoader, to_device
from fgdm_tpu_torch.diffusion.control import ControlLDM
from fgdm_tpu_torch.models.clip import CLIPTokenizer
from fgdm_tpu_torch.models.seq_two_unet import SeqTwoUNet
from fgdm_tpu_torch.train.control import (control_filter, control_param_tree,
                                          make_control_train_step)
from fgdm_tpu_torch.train.joint import make_joint_train_step
from fgdm_tpu_torch.train.state import (TrainState, joint_image_adapter_filter,
                                        make_adamw, randomize_zero_heads,
                                        state_to_pytree)

__all__ = ["build_control", "train_control", "run_control", "build_joint",
           "train_joint", "run_joint", "ckpt_roundtrip", "main"]

CONTROL_RES, JOINT_RES = 512, 256
SCALE_FACTOR = 0.18215
LR = 1e-5


def _setting(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _coco_dir() -> str:
    return os.environ.get("FGDM_COCO_DIR",
                          os.path.join(tempfile.gettempdir(), "fgdm_coco"))


def _loader(image_size: int, batch: int):
    ds = load_data("coco", _coco_dir(), image_size, use_rgb=True,
                   use_ade_colormap=True)
    return ParallelBatchLoader(ds, batch, tokenizer=CLIPTokenizer(), seed=0,
                               num_workers=4, prefetch_batches=4)


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def ckpt_roundtrip(mgr: CheckpointManager, state: TrainState,
                   step: int) -> int:
    """Save the whole state as ``step``, restore it to the host and compare
    every twelfth trainable tensor with the live one, bit for bit (JAX's
    ``_ckpt_roundtrip``).  Returns the number of tensors compared; raises on
    a mismatch.  Training goes on with the live state."""
    if not mgr.save(step, state_to_pytree(state), force=True):
        raise RuntimeError(f"step {step} already saved in {mgr.directory}")
    back = mgr.restore(step)["params"]
    if list(back) != list(state.params):
        raise RuntimeError("the restored state holds other tensors")
    names = list(state.params)[::max(1, len(state.params) // 12)]
    for name in names:
        if not torch.equal(state.params[name].detach().cpu(), back[name]):
            raise RuntimeError(f"checkpoint mismatch at {name}")
    return len(names)


def _prepare_logdir(logdir: str) -> CheckpointManager:
    os.makedirs(logdir, exist_ok=True)
    shutil.rmtree(os.path.join(logdir, "checkpoints"), ignore_errors=True)
    return CheckpointManager(os.path.join(logdir, "checkpoints"), keep=2,
                             save_interval_steps=10_000)


def _summary(recipe: str, batch: int, res: int, losses: List[float],
             step_ms: List[float], t0: float, dev: torch.device) -> Dict:
    out = {"recipe": recipe, "batch": batch, "res": res,
           "steps": len(losses), "losses": [round(x, 4) for x in losses],
           "wall_s": round(time.time() - t0, 1),
           "step_ms": [round(x, 1) for x in step_ms]}
    if dev.type == "cuda":
        out["peak_gib"] = round(torch.cuda.max_memory_allocated(dev)
                                / 2 ** 30, 2)
    return out


def _timed(fn: Callable):
    """``fn()`` and its ms: ``fn`` reads the step's metrics back to the
    host, which waits for the device, so the time ends with the step."""
    t0 = time.perf_counter()
    out = fn()
    return out, 1e3 * (time.perf_counter() - t0)


# --- ControlNet fine-tuning ---------------------------------------------------

def build_control(device=None, unet=None, vae=None, clip=None, control=None):
    """``(ControlLDM, TrainState)``: the modules (SD-1.4 width by default)
    seeded, the UNet's zero-init heads randomized, AdamW(``LR``) over the
    control branch (``sd_locked``)."""
    dev = resolve_device(device)
    dtype = torch.bfloat16
    unet = (unet if unet is not None
            else sd_unet(dtype, dev, use_adapter=False, remat=True))
    vae = vae if vae is not None else sd_vae(dtype, dev)
    clip = clip if clip is not None else sd_clip(dtype, dev)
    control = control if control is not None else sd_controlnet(dtype, dev)
    for seed, module in enumerate((unet, vae, clip, control)):
        seeded_init_(module, seed)
    randomize_zero_heads(unet)
    vae.requires_grad_(False)
    clip.requires_grad_(False)
    cldm = ControlLDM(unet, vae, DiffusionSchedule.create(**SD_SCHEDULE)
                      .to(dev), clip=clip, control=control)
    state = TrainState.create(control_param_tree(cldm), make_adamw(LR),
                              trainable_filter=control_filter(sd_locked=True))
    return cldm, state


def train_control(cldm: ControlLDM, state: TrainState,
                  logdir: str = "logs/hw_control",
                  res: int = CONTROL_RES) -> Dict:
    """``FGDM_HW_STEPS`` steps, the round trip, 2 more steps from a fresh
    loader; the summary."""
    steps, batch = _setting("FGDM_HW_STEPS", 12), _setting("FGDM_HW_BATCH", 2)
    dev = _device_of(cldm.unet)
    step_fn = make_control_train_step(cldm)
    mgr = _prepare_logdir(logdir)
    gen = torch.Generator(device=dev).manual_seed(1)
    losses, step_ms, t0 = [], [], time.time()

    def one(b):
        b = to_device(b, dev)
        dev_batch = {"image": b["rgb"], "hint": (b["image"] + 1.0) * 0.5,
                     "input_ids": b["input_ids"]}
        _, m = step_fn(state, dev_batch, gen)
        return {k: float(v) for k, v in m.items()}

    with open(os.path.join(logdir, "metrics.jsonl"), "w") as f:
        it = iter(_loader(res, batch))
        for step in range(steps):
            row, ms = _timed(lambda: one(next(it)))
            row["step"] = step
            losses.append(row["loss"])
            step_ms.append(ms)
            f.write(json.dumps(row) + "\n")
            f.flush()
        it.close()
    ckpt_roundtrip(mgr, state, steps)
    it = iter(_loader(res, batch))
    for _ in range(2):
        row, ms = _timed(lambda: one(next(it)))
        losses.append(row["loss"])
        step_ms.append(ms)
    it.close()
    return _summary("control", batch, res, losses, step_ms, t0, dev)


def run_control(device=None, logdir: str = "logs/hw_control",
                res: int = CONTROL_RES, **modules) -> Dict:
    cldm, state = build_control(device, **modules)
    return train_control(cldm, state, logdir, res)


# --- joint two-factor training ------------------------------------------------

def build_joint(device=None, model: Optional[SeqTwoUNet] = None, vae=None,
                clip=None):
    """``(SeqTwoUNet, TrainState, vae, clip)``: the joint model
    (``image_adapter``, ``remat``; SD-1.4 width by default) seeded with its
    zero-init heads randomized, AdamW(``LR``) over ``unet1``'s adapter and
    the channel mapper; the VAE and CLIP seeded and frozen."""
    dev = resolve_device(device)
    dtype = torch.bfloat16
    model = (model if model is not None
             else SeqTwoUNet(dtype=dtype, image_adapter=True, remat=True,
                             device=dev))
    randomize_zero_heads(seeded_init_(model, 0))
    vae = seeded_init_(vae if vae is not None else sd_vae(dtype, dev), 2)
    clip = seeded_init_(clip if clip is not None else sd_clip(dtype, dev), 4)
    state = TrainState.create(model, make_adamw(LR),
                              trainable_filter=joint_image_adapter_filter())
    return model, state, vae.requires_grad_(False), clip.requires_grad_(False)


def train_joint(model: SeqTwoUNet, state: TrainState, vae, clip,
                logdir: str = "logs/hw_joint", res: int = JOINT_RES) -> Dict:
    """``FGDM_HW_STEPS + 2`` steps with the round trip after step
    ``FGDM_HW_STEPS - 1``; the summary."""
    steps, batch = _setting("FGDM_HW_STEPS", 12), _setting("FGDM_HW_BATCH", 4)
    dev = _device_of(model)
    sched = DiffusionSchedule.create(**SD_SCHEDULE).to(dev)
    step_fn = make_joint_train_step(model, sched)
    mgr = _prepare_logdir(logdir)
    gen = torch.Generator(device=dev).manual_seed(1)
    losses, step_ms, t0 = [], [], time.time()

    def one(b):
        b = to_device(b, dev)
        with torch.no_grad():
            z = [SCALE_FACTOR * vae.encode(b[k]).sample(generator=gen)
                 for k in ("rgb", "image")]
            ctx = clip(b["input_ids"])
        _, m = step_fn(state, {"latent": torch.cat(z, dim=1),
                               "context": ctx}, gen)
        return {k: float(v) for k, v in m.items()}

    with open(os.path.join(logdir, "metrics.jsonl"), "w") as f:
        it = iter(_loader(res, batch))
        for step in range(steps + 2):
            row, ms = _timed(lambda: one(next(it)))
            row["step"] = step
            losses.append(row["train/loss"])
            step_ms.append(ms)
            f.write(json.dumps(row) + "\n")
            f.flush()
            if step == steps - 1:
                ckpt_roundtrip(mgr, state, step)
        it.close()
    return _summary("joint", batch, res, losses, step_ms, t0, dev)


def run_joint(device=None, logdir: str = "logs/hw_joint",
              res: int = JOINT_RES, **modules) -> Dict:
    model, state, vae, clip = build_joint(device, **modules)
    return train_joint(model, state, vae, clip, logdir, res)


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description="FG-DM training recipes "
                                "(PyTorch)")
    p.add_argument("recipe", choices=("control", "joint"))
    p.add_argument("--device", type=str, default="cuda",
                   help="where the recipe trains (cpu for tests)")
    args = p.parse_args(argv)
    run = run_control if args.recipe == "control" else run_joint
    out = run(device=args.device, logdir=f"logs/hw_{args.recipe}")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
