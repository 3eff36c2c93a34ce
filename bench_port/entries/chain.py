"""Offline generation through ``ChainEngine.generate``: a closed loop of
full engine calls.

Set-up draws the seven models' weights from the seed on the device, builds
the port's modules through ``builders``' config builders on the ``meta``
device and loads the weights into them (``load_state_dict``), builds the
cell's CUDA sources, and lets the engine warm up (one full call).  The
window runs whole calls of ``batch`` prompts, each with its own slot seed,
until ``seconds`` have passed, and keeps every call's uint8 images and
condition maps.  The check, after the window, recomputes one whole call of
the window, drawn from the seed, with the plain float32 reference and
compares every image and map of it.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from bench_port import flops, gen, weights
from bench_port.program import build_kernels, load_modules
from bench_port.reference.chain import Chain

__all__ = ["MODELS", "REF_ROWS", "LIMITS", "setup", "window", "attempted",
           "end_to_end", "release", "check"]

# (name, kind) of each model, in the order their seeds are drawn
MODELS = (("clip1", "clip"), ("unet1", "unet_adapter"), ("vae1", "vae"),
          ("clip2", "clip"), ("unet2", "unet"), ("control", "control"),
          ("vae2", "vae"))
# slots the reference runs at once (its attention holds whole score maps)
REF_ROWS = 4
# the numbers compared and their limits (PERF.md gives the readings they
# were set from): the checked call's worst image's RMS difference from the
# reference, in uint8 levels, of the 512^2 image and of the 256^2 map
LIMITS = {"image_rms": 9.0, "map_rms": 5.5}


def program(cfg: Dict[str, Any], sds: Dict[str, dict], device,
            max_batch: int):
    """The port's engine over the drawn weights."""
    from fgdm_tpu_torch import builders
    from fgdm_tpu_torch.core.schedules import DiffusionSchedule
    from fgdm_tpu_torch.diffusion.control import ControlLDM
    from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion
    from fgdm_tpu_torch.models.clip import CLIPTokenizer
    from fgdm_tpu_torch.serving import ChainEngine

    dt = getattr(torch, cfg["dtype"])
    defs = {"unet1": builders.build_unet_from_config(dt, **cfg["unet"]),
            "unet2": builders.build_unet_from_config(dt, no_prompting=True,
                                                     **cfg["unet"]),
            "control": builders.build_controlnet(dt, **cfg["control"]),
            "vae1": builders.build_autoencoder(dt, **cfg["vae"]),
            "vae2": builders.build_autoencoder(dt, **cfg["vae"]),
            "clip1": builders.build_clip(dt), "clip2": builders.build_clip(dt)}
    mods = {k: m.eval() for k, m in load_modules(defs, sds).items()}
    s = cfg["schedule"]
    sched = DiffusionSchedule.create(timesteps=s["timesteps"],
                                     beta_schedule="linear",
                                     linear_start=s["linear_start"],
                                     linear_end=s["linear_end"])
    ld = LatentDiffusion(mods["unet1"], mods["vae1"], sched,
                         scale_factor=cfg["scale_factor"], clip=mods["clip1"])
    cldm = ControlLDM(mods["unet2"], mods["vae2"], sched,
                      scale_factor=cfg["scale_factor"], clip=mods["clip2"],
                      control=mods["control"])
    sp = cfg["sampler"]
    return ChainEngine(ld, cldm, tokenizer=CLIPTokenizer(),
                       max_batch=max_batch, cond_hw=tuple(sp["cond_hw"]),
                       image_hw=tuple(sp["image_hw"]),
                       f1_steps=sp["f1_steps"], f2_steps=sp["f2_steps"],
                       f1_scale=sp["f1_scale"], f2_scale=sp["f2_scale"],
                       f1_sampler=sp["f1_sampler"],
                       f2_sampler=sp["f2_sampler"], warmup=True)


def _weights(cfg, seed, device) -> Dict[str, dict]:
    return {name: weights.draw_model(kind, cfg, seed, i, device)
            for i, (name, kind) in enumerate(MODELS)}


def setup(cfg, traffic, seed: int, device, rec) -> Dict[str, Any]:
    os.environ.update(cfg.get("env", {}))   # read when the port is imported
    with rec.timed("import_port"):
        import fgdm_tpu_torch.builders  # noqa: F401
        import fgdm_tpu_torch.serving  # noqa: F401
    if device.type == "cuda":
        with rec.timed("build_kernels"):
            build_kernels(cfg["kernels"])
    with rec.timed("weights"):
        sds = _weights(cfg, seed, device)
    with rec.timed("engine"):
        engine = program(cfg, sds, device, traffic["batch"])
    del sds
    return {"cfg": cfg, "traffic": traffic, "seed": seed, "device": device,
            "engine": engine, "calls": gen.chain_calls(traffic, seed),
            "outputs": []}


def window(st, seconds: float, rec) -> None:
    """Whole engine calls until ``seconds`` have passed; the call in flight
    then ends the window."""
    engine, work = st["engine"], 0
    t0 = time.perf_counter()
    while True:
        prompts, seeds = next(st["calls"])
        s = time.perf_counter()
        out = engine.generate(prompts, seeds=seeds)   # ends on the host copy
        e = time.perf_counter()
        rec.span("generate", s, e)
        st["outputs"].append((prompts, seeds, out))
        work += len(prompts)
        if e - t0 >= seconds:
            break
    rec.window_s = e - t0
    rec.work = work
    rec.flops = rec.work * flops.chain_flops_per_image(st["cfg"])["total"]


def attempted(st) -> int:
    return sum(len(p) for p, _, _ in st["outputs"])


def end_to_end(st, rec) -> Dict[str, float]:
    return {"images_per_s": rec.work / rec.window_s}


def release(st) -> None:
    """Free the program's state: the reference runs in the memory it
    held."""
    st.pop("engine", None)
    gc.collect()
    if st["device"].type == "cuda":
        torch.cuda.empty_cache()


def sample(st) -> int:
    """The index of the windows' call the reference recomputes, drawn from
    the seed."""
    return int(gen.rng_for(st["seed"], 4).integers(len(st["outputs"])))


def reference_outputs(cfg, seed, device, prompts, seeds, fp8=False):
    """The reference chain's uint8 images and maps for ``prompts`` and
    ``seeds``, over weights drawn again from the seed, ``REF_ROWS`` slots
    at a time; TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = weights.reference_modules(MODELS, cfg, seed, device, fp8)
    sp = dict(cfg["sampler"], schedule=cfg["schedule"],
              scale_factor=cfg["scale_factor"])
    chain = Chain(mods, sp, device)
    outs = [chain(prompts[i:i + REF_ROWS], seeds[i:i + REF_ROWS])
            for i in range(0, len(prompts), REF_ROWS)]
    return {k: np.concatenate([o[k].cpu().numpy() for o in outs])
            for k in outs[0]}


def rms(a: np.ndarray, b: np.ndarray) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    return float(np.sqrt(np.mean(d * d)))


def compare(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]
            ) -> Dict[str, float]:
    """The worst slot's RMS difference of the image and of the map."""
    n = len(got["images"])
    return {"image_rms": max(rms(got["images"][i], ref["images"][i])
                             for i in range(n)),
            "map_rms": max(rms(got["conditions"][i], ref["conditions"][i])
                           for i in range(n))}


def check(st, rec) -> Dict[str, tuple]:
    """{number: (value, limit)} of the sampled call against the
    reference."""
    prompts, seeds, got = st["outputs"][sample(st)]
    with rec.timed("reference"):
        ref = reference_outputs(st["cfg"], st["seed"], st["device"], prompts,
                                seeds)
    return {k: (v, LIMITS[k]) for k, v in compare(got, ref).items()}
