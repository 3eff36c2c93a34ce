"""Annotator checkpoints -> the port's annotator modules.

Counterpart of ``fgdm_tpu/checkpoint/annotator_ingest.py:47-559`` for the
annotators the training, ``seg2image`` and evaluation paths use, and MLSD:

* ``ControlNetHED.pth``            -> ``annotators.hed.ControlNetHED``
* ``table5_pidinet.pth``           -> ``annotators.pidinet.PiDiNet``
* ``dpt_hybrid-midas-501f0c75.pt`` -> ``annotators.midas.DPTHybrid``
* ``upernet_global_small.pth``     -> ``annotators.uniformer.UniFormerSeg``
* ``body_pose_model.pth``          -> ``annotators.openpose.BodyPoseNet``
* ``hand_pose_model.pth``          -> ``annotators.openpose.HandPoseNet``
* ``mlsd_large_512_fp32.pth``      -> ``annotators.mlsd.MobileV2MLSDLarge``

The modules carry the reference's key names, so a file loads by name after
the normalization JAX's key mappers apply: PiDiNet's ``module.`` prefix is
stripped; OpenPose's bare conv names (``conv1_1.weight``,
``Mconv3_stage4_L2.weight``: the released files, which the reference
re-prefixes at load) take the torch module's prefix their name implies
(``model0.``, ``model4_2.``; the hand net's ``model1_0.``, ``model1_1.``,
``model{s}.``), a key already prefixed ``model*`` is placed by its conv name
the same way, as JAX's ``ingest_openpose``/``ingest_handpose`` do;
BatchNorm's ``num_batches_tracked``, UniFormer's
``auxiliary_head.*`` (training only), MiDaS's final ViT norm
(``pretrained.model.norm.*``, never read) and its deepest fusion block's
``resConfUnit1`` (that block takes one input; JAX's ingest drops the keys,
which its model lacks) are skipped.  A MiDaS position table of any grid
loads: the module resizes it to the input's grid in each forward.

Each ``ingest_*`` returns ``(missing, unexpected)`` (the module keeps its
values for the missing keys); a shape mismatch raises ``ValueError``
before anything is copied.  Each ``load_*`` builds the module, ingests a
file and raises ``ValueError`` on any missing or unexpected key, as JAX's
``load_pidinet``/``load_midas``/``load_uniformer``/``load_openpose`` do:
a part-random annotator would make plausible-looking targets.  A key of
the right form that names no conv of the module counts as unexpected here
(torch's ``load_state_dict``), for every annotator; JAX's mappers drop
such a key.
"""

from __future__ import annotations

import re
from typing import Callable, List, Tuple

import torch
from torch import nn

from fgdm_tpu_torch.checkpoint.torch_ingest import (TensorDict,
                                                    load_torch_state_dict)

__all__ = ["normalize_keys", "ingest_hed", "ingest_pidinet", "ingest_midas",
           "ingest_uniformer", "ingest_openpose", "ingest_handpose",
           "ingest_mlsd", "load_pidinet", "load_midas", "load_uniformer",
           "load_openpose", "load_mlsd"]

_POS_EMBED = "pretrained.model.pos_embed"
_SKIP = {
    "hed": (),
    "pidinet": (),
    "midas": ("pretrained.model.norm.", "scratch.refinenet4.resConfUnit1."),
    "uniformer": ("auxiliary_head.",),
    "openpose": (),
    "handpose": (),
    "mlsd": (),
}


def _openpose_key(k: str, hand: bool) -> str:
    """A body or hand file's key as the port's module names it; a key of
    another form stays as it is (and is unexpected)."""
    parts = k.split(".")
    if re.fullmatch(r"model\d(?:_\d)?", parts[0]):
        parts = parts[1:]
    if len(parts) != 2 or parts[1] not in ("weight", "bias"):
        return k
    conv = parts[0]
    if hand:
        m = re.fullmatch(r"Mconv\d+_stage(\d)", conv)
        prefix = (f"model{m.group(1)}" if m else
                  "model1_1" if conv.startswith("conv6_") else "model1_0")
    else:
        m = re.fullmatch(r"Mconv\d+_stage(\d)_L(\d)", conv)
        m1 = re.fullmatch(r"conv5_\d_CPM_L(\d)", conv)
        prefix = (f"model{m.group(1)}_{m.group(2)}" if m else
                  f"model1_{m1.group(1)}" if m1 else "model0")
    return f"{prefix}.{conv}.{parts[1]}"


def normalize_keys(sd: TensorDict, kind: str) -> TensorDict:
    """The file's keys as the port's ``kind`` module names them."""
    out = {}
    for k, v in sd.items():
        if kind == "pidinet":
            k = k.replace("module.", "")
        elif kind in ("openpose", "handpose"):
            k = _openpose_key(k, hand=kind == "handpose")
        if k.endswith("num_batches_tracked") or k.startswith(_SKIP[kind]):
            continue
        out[k] = v
    return out


def _ingest(sd: TensorDict, module: nn.Module, kind: str
            ) -> Tuple[List[str], List[str]]:
    sub = normalize_keys(sd, kind)
    own = module.state_dict()
    if kind == "midas" and _POS_EMBED in sub:
        pe = module.pretrained.model.pos_embed
        if pe.shape != sub[_POS_EMBED].shape:
            module.pretrained.model.pos_embed = nn.Parameter(
                pe.new_empty(sub[_POS_EMBED].shape))
            own = module.state_dict()
    for k, v in sub.items():
        if k in own and tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: ckpt {tuple(v.shape)} "
                             f"vs model {tuple(own[k].shape)}")
    result = module.load_state_dict(sub, strict=False)
    return list(result.missing_keys), list(result.unexpected_keys)


def ingest_hed(sd: TensorDict, module: nn.Module):
    return _ingest(sd, module, "hed")


def ingest_pidinet(sd: TensorDict, module: nn.Module):
    return _ingest(sd, module, "pidinet")


def ingest_midas(sd: TensorDict, module: nn.Module):
    return _ingest(sd, module, "midas")


def ingest_uniformer(sd: TensorDict, module: nn.Module):
    return _ingest(sd, module, "uniformer")


def ingest_openpose(sd: TensorDict, module: nn.Module):
    return _ingest(sd, module, "openpose")


def ingest_handpose(sd: TensorDict, module: nn.Module):
    return _ingest(sd, module, "handpose")


def ingest_mlsd(sd: TensorDict, module: nn.Module):
    return _ingest(sd, module, "mlsd")


def _load(name: str, path: str, module: nn.Module,
          ingest: Callable) -> nn.Module:
    missing, unexpected = ingest(load_torch_state_dict(path), module)
    if missing or unexpected:
        raise ValueError(
            f"{name} ingest from {path}: {len(missing)} missing (e.g. "
            f"{missing[:3]}), {len(unexpected)} unexpected (e.g. "
            f"{unexpected[:3]})")
    return module.requires_grad_(False).eval()


def load_pidinet(path: str, dtype=torch.float32, device=None):
    """``table5_pidinet.pth`` -> a frozen ``PiDiNet`` (JAX
    ``pidinet.py:213-230``)."""
    from fgdm_tpu_torch.annotators.pidinet import PiDiNet

    return _load("PiDiNet", path, PiDiNet(dtype=dtype, device=device),
                 ingest_pidinet)


def load_midas(path: str, dtype=torch.float32, device=None):
    """``dpt_hybrid-midas-501f0c75.pt`` -> a ``MidasDetector`` (JAX
    ``midas.py:374-391``)."""
    from fgdm_tpu_torch.annotators.midas import DPTHybrid, MidasDetector

    return MidasDetector(_load("MiDaS", path,
                               DPTHybrid(dtype=dtype, device=device),
                               ingest_midas))


def load_uniformer(path: str, input_size: int = 512, dtype=torch.float32,
                   device=None):
    """``upernet_global_small.pth`` -> a ``UniformerDetector`` (JAX
    ``uniformer.py:296-315``)."""
    from fgdm_tpu_torch.annotators.uniformer import (UniFormerSeg,
                                                     UniformerDetector)

    return UniformerDetector(
        _load("UniFormer", path, UniFormerSeg(dtype=dtype, device=device),
              ingest_uniformer), input_size=input_size)


def load_openpose(path: str, hand_ckpt_path: str = None,
                  dtype=torch.float32, device=None):
    """``body_pose_model.pth`` (and ``hand_pose_model.pth``) -> an
    ``OpenposeDetector`` (JAX ``openpose.py:450-485``)."""
    from fgdm_tpu_torch.annotators.openpose import (BodyPoseNet, HandPoseNet,
                                                    OpenposeDetector)

    body = _load("OpenPose", path, BodyPoseNet(dtype=dtype, device=device),
                 ingest_openpose)
    hand = None
    if hand_ckpt_path is not None:
        hand = _load("OpenPose hand", hand_ckpt_path,
                     HandPoseNet(dtype=dtype, device=device), ingest_handpose)
    return OpenposeDetector(body, hand)


def load_mlsd(path: str, input_size: int = 512, dtype=torch.float32,
              device=None):
    """``mlsd_large_512_fp32.pth`` -> an ``MLSDdetector`` (JAX
    ``mlsd.py:222``; its mapper is ``annotator_ingest.py:89``)."""
    from fgdm_tpu_torch.annotators.mlsd import MLSDdetector, MobileV2MLSDLarge

    return MLSDdetector(_load("MLSD", path,
                              MobileV2MLSDLarge(dtype=dtype, device=device),
                              ingest_mlsd), input_size=input_size)
