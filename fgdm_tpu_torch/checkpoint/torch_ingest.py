"""Reference checkpoints -> the port's modules.

Counterpart of ``fgdm_tpu/checkpoint/torch_ingest.py``.  The reference's
checkpoints (``fgdm_seg.pth``, ``fgdm_control_sd15_*.pth``, ``sd-v1-4.ckpt``)
hold one flat state dict whose prefixes name the four models:

* ``model.diffusion_model.*``        -> ``UNetModel`` (+ the FG-DM ``adapter.*``)
* ``control_model.*``                -> ``ControlNet``
* ``first_stage_model.*``            -> ``AutoencoderKL``
* ``cond_stage_model.transformer.*`` -> ``CLIPTextEncoder``

The port's module tree carries the reference's names and its OIHW layout
(``checkpoint/convert.py``), so a prefix's keys load with
``load_state_dict(strict=False)`` as they stand: none of JAX's layout rules
are needed.  That holds for the variants' keys too: a pixel-attention
block's conv1d ``qkv``/``proj_out`` ``[out, in, 1]`` and a ``num_classes``
UNet's ``label_emb.weight`` (which JAX's ``map_unet_key`` reads into a
dense kernel its ``nn.Embed`` lacks, so JAX keeps that table at its init).  Two spellings are normalized first, as JAX's key mappers accept
both: a plain ``Adapter`` block's conv written as
``adapter.body.N.in_layers.2`` (what ``fgdm_tpu``'s exporter writes) becomes
``adapter.body.N.in_conv`` (a ``TimeAdapter``'s blocks are ResBlocks, whose
``in_layers.2`` is their own conv, and keep the name), and a CLIP key
without the ``text_model.`` level gets it.  The multi-adapter UNet's extra
adapters are not read from a file, as JAX's schema maps no ``adapters.*``
key (``map_unet_key``): such keys are unexpected, and the extra adapters
keep their init and are counted as missing.

Each ``ingest_*`` returns ``(missing, unexpected)``: the module's keys the
file lacks (they keep the module's current values, the reference's
``strict=False``) and the file's keys the module lacks.  JAX counts a key
its schema maps but its model lacks (an adapter key meeting a UNet without
one) as neither and drops it; the port reports it as unexpected, as the
reference's ``load_state_dict(strict=False)`` does.  A shape mismatch raises
``ValueError`` before anything is copied, as JAX's ``_assemble`` does.
"""

from __future__ import annotations

import re
import zipfile
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from fgdm_tpu_torch.models.adapter import Adapter

__all__ = ["load_torch_state_dict", "apply_key_surgery", "ingest_unet",
           "ingest_controlnet", "ingest_vae", "ingest_clip", "UNET_PREFIX",
           "CONTROL_PREFIX", "VAE_PREFIX", "CLIP_PREFIX"]

TensorDict = Dict[str, torch.Tensor]

UNET_PREFIX = "model.diffusion_model."
CONTROL_PREFIX = "control_model."
VAE_PREFIX = "first_stage_model."
CLIP_PREFIX = "cond_stage_model.transformer."


def load_torch_state_dict(path: str) -> TensorDict:
    """A ``.pth``/``.ckpt`` (``torch.load`` on the CPU, memory-mapped where
    the file is a zip archive; the ``"state_dict"`` entry when there is
    one) or ``.safetensors`` file (the ``safetensors`` package, imported
    when such a file is read) -> ``{key: tensor}`` of its tensors."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    # reference .ckpt files pickle Lightning objects beside the weights
    sd = torch.load(path, map_location="cpu", weights_only=False,
                    mmap=zipfile.is_zipfile(path))
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def apply_key_surgery(sd: TensorDict, ignore_keys: Sequence[str] = (),
                      replace_keys: Sequence[Tuple[str, str]] = ()
                      ) -> TensorDict:
    """Drop keys under ``ignore_keys`` prefixes, then rename substrings
    (reference ``ddpm.py:244-263``)."""
    out = {}
    for k, v in sd.items():
        if any(k.startswith(ik) for ik in ignore_keys):
            continue
        for old, new in replace_keys:
            if old in k:
                k = k.replace(old, new)
        out[k] = v
    return out


_ADAPTER_IN_LAYERS = re.compile(r"^adapter\.body\.(\d+)\.in_layers\.2\.")


def _load(module: nn.Module, sub: TensorDict, dropped: Sequence[str] = ()
          ) -> Tuple[List[str], List[str]]:
    """Load ``sub`` into ``module``; ``dropped`` are file keys not read,
    reported as unexpected."""
    own = module.state_dict()
    for k, v in sub.items():
        if k in own and tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: ckpt {tuple(v.shape)} "
                             f"vs model {tuple(own[k].shape)}")
    result = module.load_state_dict(sub, strict=False)
    missing = list(result.missing_keys)
    unexpected = list(result.unexpected_keys) + list(dropped)
    if missing or unexpected:
        print(f"[torch_ingest] missing: {len(missing)} unexpected: "
              f"{len(unexpected)}")
    return missing, unexpected


def _strip(sd: TensorDict, prefix: str) -> TensorDict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def ingest_unet(sd: TensorDict, unet: nn.Module, prefix: str = UNET_PREFIX):
    sub = _strip(sd, prefix)
    if isinstance(getattr(unet, "adapter", None), Adapter):
        sub = {_ADAPTER_IN_LAYERS.sub(r"adapter.body.\1.in_conv.", k): v
               for k, v in sub.items()}
    dropped = [k for k in sub if k.startswith("adapters.")]
    if dropped:
        # a known gap kept for fidelity to JAX, whose schema maps no such
        # key (ROADMAP Queue C): trained extra adapters are not loaded
        print(f"[torch_ingest] {len(dropped)} adapters.* keys not read: "
              "the extra adapters keep their init")
    return _load(unet, {k: v for k, v in sub.items()
                        if not k.startswith("adapters.")}, dropped)


def ingest_controlnet(sd: TensorDict, control: nn.Module,
                      prefix: str = CONTROL_PREFIX):
    return _load(control, _strip(sd, prefix))


def ingest_vae(sd: TensorDict, vae: nn.Module, prefix: str = VAE_PREFIX):
    return _load(vae, _strip(sd, prefix))


def ingest_clip(sd: TensorDict, clip: nn.Module, prefix: str = CLIP_PREFIX):
    sub = {(k if k.startswith("text_model.") else "text_model." + k): v
           for k, v in _strip(sd, prefix).items()}
    return _load(clip, sub)
