"""JAX (flax) parameter trees -> the port's state dicts.

Takes a param tree as nested dicts of numpy arrays (``jax.tree.map(
np.asarray, params)``, with or without the ``"params"`` root) and returns
``{torch key: float32 tensor}`` for ``UNetModel``, ``ControlNet``,
``AutoencoderKL`` and ``CLIPTextEncoder``.  The port's own copy of the path
rules of ``fgdm_tpu/checkpoint/torch_export.py:18-171``, writing the
reference's CompVis / ControlNet / HF CLIP key schema in OIHW layout, with
one difference: an ``Adapter`` block's channel-changing conv is
``adapter.body.N.in_conv`` (the reference T2I-Adapter's name;
``torch_export`` writes the TimeAdapter ResBlock's ``in_layers.2``).

Every leaf must map to a key; an unknown path raises ``KeyError``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["flatten", "unet_state_dict", "controlnet_state_dict",
           "vae_state_dict", "clip_state_dict"]

_RES = {
    "in_norm": "in_layers.0",
    "in_conv": "in_layers.2",
    "emb_proj": "emb_layers.1",
    "out_norm": "out_layers.0",
    "out_conv": "out_layers.3",
    "skip_connection": "skip_connection",
}
_ADAPTER_LEAVES = ("in_conv", "block1", "block2", "skep", "down_opt")


def flatten(params: Mapping) -> Dict[Tuple[str, ...], np.ndarray]:
    """Nested dicts -> {path tuple: array}, dropping a ``"params"`` root."""
    if set(params) == {"params"}:
        params = params["params"]
    flat = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (str(k),))
        else:
            flat[path] = np.asarray(node)

    walk(params, ())
    return flat


def _leaf(leaf: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    if leaf == "kernel":
        # HWIO -> OIHW; [in, out] -> [out, in]
        return "weight", (np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4
                          else np.transpose(v))
    if leaf in ("scale", "embedding"):
        return "weight", v
    if leaf == "bias":
        return "bias", v
    raise KeyError(f"unknown leaf {leaf!r}")


def _transformer(parts) -> str:
    inner = ".".join(parts)
    m = re.match(r"transformer_blocks_(\d+)\.(.*)", inner)
    if not m:
        return inner  # norm / proj_in / proj_out
    d, rest = m.groups()
    rest = rest.replace("ff.net_0.proj", "ff.net.0.proj")
    rest = rest.replace("ff.net_2", "ff.net.2")
    rest = rest.replace("to_out", "to_out.0")
    return f"transformer_blocks.{d}.{rest}"


def _unet_path(path: Tuple[str, ...]) -> Optional[str]:
    head, rest = path[0], list(path[1:])
    m = re.match(r"time_embed_(\d+)$", head)
    if m:
        return f"time_embed.{m.group(1)}"
    if head == "out_norm":
        return "out.0"
    if head == "out_conv":
        return "out.2"
    if head == "adapter" and rest:
        if rest == ["conv_in"]:
            return "adapter.conv_in"
        m = re.match(r"body_(\d+)$", rest[0])
        if m and len(rest) == 2 and rest[1] in _ADAPTER_LEAVES:
            return f"adapter.body.{m.group(1)}.{rest[1]}"
        return None
    m = re.match(r"(input|output)_blocks_(\d+)_(\d+)$", head)
    if m:
        stage, i, j = m.groups()
        base = f"{stage}_blocks.{i}.{j}"
        if not rest:
            return base  # bare conv (input_blocks.0.0)
        if rest[0] in ("op", "conv"):
            return f"{base}.{rest[0]}"
        if rest[0] in _RES:
            return f"{base}.{_RES[rest[0]]}"
        return f"{base}.{_transformer(rest)}"
    m = re.match(r"middle_block_(\d+)$", head)
    if m:
        base = f"middle_block.{m.group(1)}"
        if rest and rest[0] in _RES:
            return f"{base}.{_RES[rest[0]]}"
        return f"{base}.{_transformer(rest)}"
    return None


def _controlnet_path(path: Tuple[str, ...]) -> Optional[str]:
    head = path[0]
    m = re.match(r"zero_convs_(\d+)$", head)
    if m:
        return f"zero_convs.{m.group(1)}.0"
    if head == "middle_block_out":
        return "middle_block_out.0"
    m = re.match(r"input_hint_block_(\d+)$", head)
    if m:
        return f"input_hint_block.{int(m.group(1)) * 2}"
    return _unet_path(path)


def _vae_path(path: Tuple[str, ...]) -> Optional[str]:
    head = path[0]
    if head in ("quant_conv", "post_quant_conv"):
        return head
    if head not in ("encoder", "decoder") or len(path) < 2:
        return None
    sub, inner = path[1], ".".join(path[2:])
    if sub in ("conv_in", "conv_out", "norm_out"):
        return f"{head}.{sub}"
    m = re.match(r"mid_(block_1|attn_1|block_2)$", sub)
    if m:
        return f"{head}.mid.{m.group(1)}.{inner}"
    m = re.match(r"(down|up)_(\d+)_(block|attn)_(\d+)$", sub)
    if m:
        way, lvl, kind, j = m.groups()
        return f"{head}.{way}.{lvl}.{kind}.{j}.{inner}"
    m = re.match(r"(down|up)_(\d+)_(downsample|upsample)$", sub)
    if m:
        return f"{head}.{m.group(1)}.{m.group(2)}.{m.group(3)}.conv"
    return None


def _clip_path(path: Tuple[str, ...]) -> Optional[str]:
    head = path[0]
    if head in ("token_embedding", "position_embedding"):
        return f"text_model.embeddings.{head}"
    if head == "final_layer_norm":
        return "text_model.final_layer_norm"
    m = re.match(r"layers_(\d+)$", head)
    if m and len(path) > 1:
        inner = list(path[1:])
        if inner[0] in ("fc1", "fc2"):
            inner = ["mlp"] + inner
        return f"text_model.encoder.layers.{m.group(1)}." + ".".join(inner)
    return None


def _convert(params, path_fn):
    out: Dict[str, torch.Tensor] = {}
    for path, v in flatten(params).items():
        tpath = path_fn(path[:-1]) if len(path) > 1 else None
        if tpath is None:
            raise KeyError(f"no port key for flax path {'/'.join(path)}")
        name, tv = _leaf(path[-1], v)
        out[f"{tpath}.{name}"] = torch.from_numpy(
            np.ascontiguousarray(tv, dtype=np.float32))
    return out


def unet_state_dict(params) -> Dict[str, torch.Tensor]:
    """``UNetModel`` state dict from a flax UNet (with or without adapter)."""
    return _convert(params, _unet_path)


def controlnet_state_dict(params) -> Dict[str, torch.Tensor]:
    return _convert(params, _controlnet_path)


def vae_state_dict(params) -> Dict[str, torch.Tensor]:
    """``AutoencoderKL`` state dict (encoder, ``quant_conv``,
    ``post_quant_conv``, decoder) from a flax AutoencoderKL."""
    return _convert(params, _vae_path)


def clip_state_dict(params) -> Dict[str, torch.Tensor]:
    """``CLIPTextEncoder`` state dict from a flax CLIPTextEncoder."""
    tree = dict(params.get("params", params))
    # the position table is a bare param at the root; give it the
    # embedding leaf name the token table has
    tree["position_embedding"] = {"embedding": tree["position_embedding"]}
    return _convert(tree, _clip_path)
