"""Condition targets synthesized on the fly for the non-seg factors.

Counterpart of ``fgdm_tpu/train/condition.py:1-141`` (the reference's
``ddpm.py:137-150,397-419``): a frozen annotator turns each batch's RGB
image into the factor's training target.

* ``use_depth``              -> MiDaS depth, min-max normalized per image
* ``use_depth + use_normal`` -> normals from MiDaS's depth gradients
* ``use_sketch``             -> PiDiNet edges (HED with ``use_hed``)
* ``sketch_to_normal``       -> the normal map and PiDiNet's sketch, 6
  channels (the joint factor; ``_encode_target`` encodes each half)

The annotators are frozen (``requires_grad_(False)``, ``eval()``) and
``target`` runs under ``torch.no_grad()``, where JAX stops the gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fgdm_tpu_torch import resolve_device

__all__ = ["VALID_KINDS", "ConditionSynth", "condition_kind",
           "build_condition_synth"]

VALID_KINDS = ("depth", "normal", "sketch", "sketch_hed", "sketch_to_normal")


class ConditionSynth:
    """``target(img)``: an RGB batch ``[B, 3, H, W]`` in [-1, 1] -> the
    factor's target in [-1, 1], NCHW.  ``model`` is the depth net for the
    depth kinds and ``sketch_to_normal``, else the sketch net; ``model2`` is
    ``sketch_to_normal``'s sketch net."""

    def __init__(self, kind: str, model: nn.Module,
                 model2: Optional[nn.Module] = None):
        self.kind, self.model, self.model2 = kind, model, model2
        # {"model" | "model2": (missing, unexpected)} of each net read from
        # a state dict by ``build_condition_synth``
        self.load_report = {}

    def _depth01(self, img):
        depth = self.model(img)
        dmin = depth.amin(dim=(1, 2), keepdim=True)
        dmax = depth.amax(dim=(1, 2), keepdim=True)
        return (depth - dmin) / (dmax - dmin + 1e-8)

    def _one(self, kind: str, model: nn.Module, img):
        if kind == "depth":
            return (self._depth01(img) * 2.0 - 1.0)[:, None].repeat(1, 3, 1,
                                                                    1)
        if kind == "normal":
            from fgdm_tpu_torch.annotators.midas import depth_to_normal

            return depth_to_normal(model(img))
        # the sketch nets already give [-1, 1] in 3 channels
        return model(img)

    @torch.no_grad()
    def target(self, img: torch.Tensor) -> torch.Tensor:
        if self.kind == "sketch_to_normal":
            # the reference: y = normal(x); x = sketch(x); cat([y, x])
            return torch.cat([self._one("normal", self.model, img),
                              self._one("sketch", self.model2, img)], dim=1)
        return self._one(self.kind, self.model, img)


def condition_kind(use_depth: bool = False, use_normal: bool = False,
                   use_sketch: bool = False, use_hed: bool = False,
                   sketch_to_normal: bool = False) -> Optional[str]:
    """The synthesis kind of the config's flags (``ddpm.py:137-150``).  A seg
    config sets none of them: its colourised label map is the target
    (None)."""
    if sketch_to_normal:
        return "sketch_to_normal"
    if use_sketch:
        return "sketch_hed" if use_hed else "sketch"
    if use_depth and use_normal:
        return "normal"
    if use_depth:
        return "depth"
    return None


def _sketch_net(kind: str, device):
    if kind == "sketch_hed":
        from fgdm_tpu_torch.annotators.hed import ControlNetHED

        return ControlNetHED(device=device)
    from fgdm_tpu_torch.annotators.pidinet import PiDiNet

    return PiDiNet(device=device)


def build_condition_synth(kind: str,
                          generator: Optional[torch.Generator] = None,
                          state_dict=None, state_dict2=None,
                          device=None) -> ConditionSynth:
    """The frozen annotators for ``kind`` (float32, on ``device``).

    ``state_dict`` is the annotator checkpoint's tensors (read through
    ``checkpoint/annotator_ingest.py``), ``state_dict2`` the sketch net's
    for ``sketch_to_normal``; ``load_report`` keeps what each reading
    missed.  A net without one is drawn from ``generator``: a smoke run's
    annotator, never a real training run's."""
    from fgdm_tpu_torch.annotators import seed_
    from fgdm_tpu_torch.checkpoint import annotator_ingest as ai

    if kind not in VALID_KINDS:
        raise ValueError(f"unknown condition kind {kind!r}; one of "
                         f"{VALID_KINDS}")
    dev = resolve_device(device)
    if kind in ("depth", "normal", "sketch_to_normal"):
        from fgdm_tpu_torch.annotators.midas import DPTHybrid

        model, ingest = DPTHybrid(device=dev), ai.ingest_midas
    else:
        model = _sketch_net(kind, dev)
        ingest = ai.ingest_hed if kind == "sketch_hed" else ai.ingest_pidinet
    model2 = (_sketch_net("sketch", dev) if kind == "sketch_to_normal"
              else None)
    synth = ConditionSynth(kind, model, model2)
    for net, sd, fn, what in ((model, state_dict, ingest, "model"),
                              (model2, state_dict2, ai.ingest_pidinet,
                               "model2")):
        if net is None:
            continue
        if sd is not None:
            synth.load_report[what] = fn(sd, net)
        elif generator is None:
            raise ValueError(
                f"condition synthesis {kind!r} needs the weights of its "
                f"{'sketch net' if what == 'model2' else 'annotator'} (pass "
                "a checkpoint's state dict, or a generator for a random-init "
                "smoke run)")
        else:
            seed_(net, generator)
        net.requires_grad_(False).eval()
    return synth
