"""Shape- and name-guided fuzzy checkpoint matching.

Counterpart of ``fgdm_tpu/checkpoint/fuzzy_ingest.py:28-128``, which aligns
a torch state dict of unverified schema (the eval CLI's CLIP checkpoints,
OpenAI's or HF's) to a parameter tree by

1. leaf kind and shape: a ``weight`` may fill a kernel, a norm scale, a
   BatchNorm statistic or any ``*embedding`` table; a ``bias`` a bias;
   ``running_mean``/``running_var`` the statistics; another name its own
   leaf, or, across the ``*embedding`` name drift of the CLIP schemas
   (OpenAI's ``positional_embedding``), any embedding table of its shape;
2. name-token overlap among those candidates, the first free slot winning
   a tie, in the torch keys' order.

Both sides are torch here, so shapes compare as they stand (JAX transposes
a kernel first; the candidates are the same).  The slots are named as
JAX's flax tree names them (``expect``: ``{"layers_3/fc1/kernel": shape,
...}``), and enumerate in that tree's order, its keys sorted at every
level: the tie rule reads that order, so a checkpoint's tensors land in the
slots JAX gives them, tie for tie (``utils/clip_score.flax_paths`` names a
port module's parameters so).  Where JAX's tokens tie across slots the
order decides, also where it picks a slot the name does not mean (ROADMAP
Queue C: OpenAI's ``ln_1.bias`` and ``mlp.c_proj.bias``).
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import torch

__all__ = ["match_state_dict", "apply_mapping"]

_EMPTY = {"weight", "bias", "kernel", "scale", ""}


def _tokens(s: str) -> set:
    return set(re.split(r"[._/]+", s.lower())) - _EMPTY


def match_state_dict(sd: Mapping, expect: Mapping[str, Tuple[int, ...]]
                     ) -> Tuple[Dict[str, str], List[str], List[str]]:
    """``sd`` (``{torch key: tensor or array}``) against ``expect``
    (``{slot path: torch-orientation shape}``) -> (``{torch key: slot}``,
    the unmatched torch keys, the slots left free)."""
    # candidate slots grouped by (leaf kind, shape), in the flax tree's
    # order
    free: Dict[Tuple, List[str]] = {}
    for path in sorted(expect, key=lambda p: p.split("/")):
        leaf = path.rsplit("/", 1)[-1]
        free.setdefault((leaf, tuple(expect[path])), []).append(path)

    mapping: Dict[str, str] = {}
    unmatched: List[str] = []
    for tkey, v in sd.items():
        shape = tuple(v.shape)
        leaf_name = tkey.rsplit(".", 1)[-1]
        if leaf_name == "weight":
            emb = sorted({k[0] for k in free
                          if k[0].endswith("embedding") and free[k]})
            kinds = (["kernel"] if len(shape) in (2, 4) else []) + [
                "scale", "mean", "var", *emb]
        elif leaf_name == "bias":
            kinds = ["bias"]
        elif leaf_name in ("running_mean", "running_var"):
            kinds = ["mean" if leaf_name == "running_mean" else "var"]
        else:
            kinds = [leaf_name]
        candidates = [p for kind in kinds for p in free.get((kind, shape), [])]
        if not candidates and leaf_name not in ("weight", "bias") \
                and "embedding" in leaf_name:
            # OpenAI's bare ``positional_embedding`` <-> ``position_...``
            candidates = [p for (kind, s), slots in free.items()
                          if kind.endswith("embedding") and s == shape
                          for p in slots]
        if not candidates:
            unmatched.append(tkey)
            continue
        tt = _tokens(tkey)
        path = max(candidates, key=lambda p: len(tt & _tokens(p)))
        mapping[tkey] = path
        free[(path.rsplit("/", 1)[-1], tuple(expect[path]))].remove(path)
    return mapping, unmatched, [p for slots in free.values() for p in slots]


def apply_mapping(sd: Mapping, mapping: Dict[str, str],
                  port_key: Mapping[str, str]) -> Dict[str, torch.Tensor]:
    """``{port key: float32 tensor}`` of the mapped tensors; ``port_key``
    names each slot's key in the port module."""
    return {port_key[path]: torch.as_tensor(sd[tkey]).float()
            for tkey, path in mapping.items()}
