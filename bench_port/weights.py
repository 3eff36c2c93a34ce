"""Seeded weights for a model, drawn on the device in one call.

The benchmark, not the program, makes the weights: for each model it reads
the names and shapes of the checkpoint schema from the reference module
(built on the ``meta`` device), draws every parameter of the model from one
``torch.randn`` over a flat float32 buffer on a generator seeded from the
run's seed, and scales each slice in place.  The program and the reference
load the same state dict (the program through ``load_state_dict``, its
modules keep the CompVis key schema); the reference draws it again after
the program's state is freed.

The scheme is the variance-scaling init that the port's own seeded builds
use (``1/sqrt(fan_in)`` for weights, norm scales 1, biases 0, the
zero-initialised heads of the UNet and ControlNet at 0), plus ``perturb``
times N(0, 1) on every parameter of a model that asks for it, so the
zero-initialised heads do work and pass gradients.
"""

from __future__ import annotations

import math
import re
from typing import Dict

import torch
from torch import nn

__all__ = ["ZERO_INIT", "model_seed", "draw_state_dict", "draw_model",
           "reference_modules"]

# leaves the CompVis code creates zeroed (``zero_module``): ResBlock output
# convs, transformer output projections, the UNet head, ControlNet's zero
# convs and the last conv of its hint pyramid
ZERO_INIT = re.compile(r"(out_layers\.3\.|\.proj_out\.|^out\.2\.|^zero_convs\."
                       r"|^middle_block_out\.|^input_hint_block\.14\.)")


def model_seed(seed: int, index: int) -> int:
    """The generator seed of model ``index`` of a run seeded with
    ``seed`` (any integer)."""
    return (int(seed) * 1_000_003 + 7919 * index) % (1 << 63)


def _std(name: str, shape, zero: bool) -> float:
    if len(shape) < 2:
        return 0.0
    if zero and ZERO_INIT.search(name):
        return 0.0
    if name.endswith("embedding.weight"):
        return 0.0 if "position" in name else shape[1] ** -0.5
    return 1.0 / math.sqrt(math.prod(shape[1:]))


def draw_state_dict(schema: nn.Module, seed: int, device,
                    perturb: float = 0.0, zero_heads: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """A float32 state dict for ``schema``'s keys and shapes, every tensor
    taken from one buffer drawn from ``torch.Generator(device).manual_seed(
    seed)``.  ``zero_heads`` applies ``ZERO_INIT``."""
    shapes = {k: tuple(v.shape) for k, v in schema.state_dict().items()}
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    with torch.no_grad():
        for name, shape in shapes.items():
            n = math.prod(shape)
            t = flat[at:at + n].view(shape)
            at += n
            std = math.sqrt(_std(name, shape, zero_heads) ** 2 + perturb ** 2)
            t.mul_(std)
            if len(shape) == 1 and name.endswith(".weight"):
                t.add_(1.0)   # a norm's scale
            # a storage (and a version counter) of its own, as a loaded
            # checkpoint's tensors have
            out[name] = t.clone()
    return out


# models whose every parameter takes the perturbation, and whose
# zero-initialised heads stay at it
_PERTURBED = ("unet_adapter", "unet", "control")


def draw_model(kind: str, cfg: dict, seed: int, index: int, device
               ) -> Dict[str, torch.Tensor]:
    """The state dict of model ``index`` of a run seeded with ``seed``: the
    reference module of ``kind`` gives the keys and shapes."""
    from bench_port.reference.models import build

    with torch.device("meta"):
        schema = build(kind, cfg)
    perturbed = kind in _PERTURBED
    return draw_state_dict(schema, model_seed(seed, index), device,
                           cfg["init"]["perturb"] if perturbed else 0.0,
                           zero_heads=perturbed)


def reference_modules(models, cfg: dict, seed: int, device, fp8=False):
    """``{name: module}``: the reference's module of each ``(name, kind)``
    of ``models`` (index = its seed's index), over weights drawn from the
    seed, float8 operands when ``fp8``."""
    from bench_port.reference.models import build, set_fp8

    mods = {}
    for i, (name, kind) in enumerate(models):
        with torch.device("meta"):
            m = build(kind, cfg)
        m.load_state_dict(draw_model(kind, cfg, seed, i, device),
                          strict=True, assign=True)
        mods[name] = set_fp8(m, fp8)
    return mods
