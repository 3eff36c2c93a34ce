"""Annotator checkpoints -> the port's annotator modules.

Counterpart of ``fgdm_tpu/checkpoint/annotator_ingest.py:47-559`` for the
four annotators the training and ``seg2image`` paths use:

* ``ControlNetHED.pth``            -> ``annotators.hed.ControlNetHED``
* ``table5_pidinet.pth``           -> ``annotators.pidinet.PiDiNet``
* ``dpt_hybrid-midas-501f0c75.pt`` -> ``annotators.midas.DPTHybrid``
* ``upernet_global_small.pth``     -> ``annotators.uniformer.UniFormerSeg``

The modules carry the reference's key names, so a file loads by name after
the normalization JAX's key mappers apply: PiDiNet's ``module.`` prefix is
stripped; BatchNorm's ``num_batches_tracked``, UniFormer's
``auxiliary_head.*`` (training only), MiDaS's final ViT norm
(``pretrained.model.norm.*``, never read) and its deepest fusion block's
``resConfUnit1`` (that block takes one input; JAX's ingest drops the keys,
which its model lacks) are skipped.  A MiDaS position table of any grid
loads: the module resizes it to the input's grid in each forward.

Each ``ingest_*`` returns ``(missing, unexpected)`` (the module keeps its
values for the missing keys); a shape mismatch raises ``ValueError``
before anything is copied.  Each ``load_*`` builds the module, ingests a
file and raises ``ValueError`` on any missing or unexpected key, as JAX's
``load_pidinet``/``load_midas``/``load_uniformer`` do: a part-random
annotator would make plausible-looking targets.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch
from torch import nn

from fgdm_tpu_torch.checkpoint.torch_ingest import (TensorDict,
                                                    load_torch_state_dict)

__all__ = ["normalize_keys", "ingest_hed", "ingest_pidinet", "ingest_midas",
           "ingest_uniformer", "load_pidinet", "load_midas", "load_uniformer"]

_POS_EMBED = "pretrained.model.pos_embed"
_SKIP = {
    "hed": (),
    "pidinet": (),
    "midas": ("pretrained.model.norm.", "scratch.refinenet4.resConfUnit1."),
    "uniformer": ("auxiliary_head.",),
}


def normalize_keys(sd: TensorDict, kind: str) -> TensorDict:
    """The file's keys as the port's ``kind`` module names them."""
    out = {}
    for k, v in sd.items():
        if kind == "pidinet":
            k = k.replace("module.", "")
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
