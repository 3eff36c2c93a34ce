"""JAX (flax) parameter trees -> the port's state dicts.

Takes a param tree as nested dicts of numpy arrays (``jax.tree.map(
np.asarray, params)``, with or without the ``"params"`` root) and returns
``{torch key: float32 tensor}`` for ``UNetModel``, ``ControlNet``,
``AutoencoderKL`` and ``CLIPTextEncoder``.  The port's own copy of the path
rules of ``fgdm_tpu/checkpoint/torch_export.py:18-171``, writing the
reference's CompVis / ControlNet / HF CLIP key schema in OIHW layout, with
two differences: an ``Adapter`` block's channel-changing conv is
``adapter.body.N.in_conv`` (the reference T2I-Adapter's name;
``torch_export`` writes the TimeAdapter ResBlock's ``in_layers.2``), and
the multi-adapter UNet's ``adapters_{k}`` become ``adapters.{k}.*``
(``torch_export`` drops them).  A ``TimeAdapter``'s blocks are ResBlocks
and take the ResBlock names.  A pixel-attention block's ``qkv`` and
``proj_out`` (flax ``Dense``) become the reference's conv1d weights
``[out, in, 1]``, and ``label_emb`` the class-embedding table.
``seq_two_state_dict`` carries a ``SeqTwoUNet``: both UNets by the UNet
rules, ``channel_mapper`` as a 1x1 OIHW conv.  ``hed_state_dict``,
``pidinet_state_dict``, ``midas_state_dict``, ``uniformer_state_dict``,
``openpose_state_dict``, ``handpose_state_dict`` and ``mlsd_state_dict``
invert the annotator key maps of ``fgdm_tpu/checkpoint/annotator_ingest.py``
(bare kernels, the HED input shift, frozen BatchNorms' statistics).
``vq_state_dict`` (taming's names), ``lpips_state_dict``,
``patch_discriminator_state_dict``, ``adapter_light_state_dict``,
``attention_pool_state_dict``, ``class_embedder_state_dict``,
``bert_state_dict``, ``spatial_rescaler_state_dict`` and
``clip_image_embedder_state_dict`` carry the library modules that no path
runs (``models/vq.py``, ``diffusion/perceptual_losses.py``,
``models/adapter.py``, ``nn/attention.py``, ``models/encoders.py``).

Every leaf must map to a key; an unknown path raises ``KeyError``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["flatten", "unet_state_dict", "controlnet_state_dict",
           "vae_state_dict", "clip_state_dict", "seq_two_state_dict",
           "hed_state_dict", "pidinet_state_dict", "midas_state_dict",
           "uniformer_state_dict", "openpose_state_dict",
           "handpose_state_dict", "mlsd_state_dict", "vq_state_dict",
           "lpips_state_dict", "patch_discriminator_state_dict",
           "adapter_light_state_dict", "attention_pool_state_dict",
           "class_embedder_state_dict", "bert_state_dict",
           "spatial_rescaler_state_dict", "clip_image_embedder_state_dict"]

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
    rest = re.sub(r"ff\.net_0$", "ff.net.0.0", rest)    # glu=False
    rest = rest.replace("ff.net_2", "ff.net.2")
    rest = rest.replace("to_out", "to_out.0")
    return f"transformer_blocks.{d}.{rest}"


def _adapter_path(name: str, rest, time_adapter: bool) -> Optional[str]:
    if rest == ["conv_in"]:
        return f"{name}.conv_in"
    m = re.match(r"body_(\d+)$", rest[0]) if rest else None
    if not m or len(rest) != 2:
        return None
    leaf = rest[1]
    if time_adapter:   # TimeAdapter blocks are ResBlocks
        leaf = _RES.get(leaf)
    elif leaf not in _ADAPTER_LEAVES:
        leaf = None
    return None if leaf is None else f"{name}.body.{m.group(1)}.{leaf}"


def _unet_path(path: Tuple[str, ...], time_adapter: bool = False
               ) -> Optional[str]:
    head, rest = path[0], list(path[1:])
    m = re.match(r"time_embed_(\d+)$", head)
    if m:
        return f"time_embed.{m.group(1)}"
    if head == "out_norm":
        return "out.0"
    if head == "out_conv":
        return "out.2"
    if head == "label_emb":
        return "label_emb"
    if head == "adapter":
        return _adapter_path("adapter", rest, time_adapter)
    m = re.match(r"adapters_(\d+)$", head)
    if m:
        return _adapter_path(f"adapters.{m.group(1)}", rest, False)
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


def _conv1d(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Pixel attention's dense ``qkv``/``proj_out`` as conv1d weights (a
    SpatialTransformer's ``proj_out`` is a 4-d conv and stays)."""
    return {k: v[..., None] if v.dim() == 2 and k.endswith(
        (".qkv.weight", ".proj_out.weight")) else v for k, v in sd.items()}


def unet_state_dict(params) -> Dict[str, torch.Tensor]:
    """``UNetModel`` state dict from a flax UNet (with or without adapter,
    a time adapter or extra adapters, pixel attention, a label
    embedding)."""
    time_adapter = any(p[:1] == ("adapter",) and "emb_proj" in p
                       for p in flatten(params))
    return _conv1d(_convert(params, lambda p: _unet_path(p, time_adapter)))


def _seq_two_path(path: Tuple[str, ...]) -> Optional[str]:
    head = path[0]
    if head == "channel_mapper" and len(path) == 1:
        return head
    if head in ("unet1", "unet2") and len(path) > 1:
        # unet1's adapter (image_adapter mode) is a plain Adapter
        sub = _unet_path(path[1:])
        return None if sub is None else f"{head}.{sub}"
    return None


def seq_two_state_dict(params) -> Dict[str, torch.Tensor]:
    """``SeqTwoUNet`` state dict from a flax SeqTwoUNet (concat or
    ``image_adapter`` mode)."""
    return _conv1d(_convert(params, _seq_two_path))


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


# --- annotators -------------------------------------------------------------

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _annotator(params, path_fn) -> Dict[str, torch.Tensor]:
    """``path_fn(path, value) -> (torch key, array)`` for each leaf."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in flatten(params).items():
        got = path_fn(path, v)
        if got is None:
            raise KeyError(f"no port key for flax path {'/'.join(path)}")
        key, tv = got
        out[key] = torch.from_numpy(np.ascontiguousarray(tv,
                                                         dtype=np.float32))
    return out


def _at(base: str, leaf: str, v: np.ndarray):
    name, tv = _leaf(leaf, v)
    return f"{base}.{name}", tv


def _bare(base: str, leaf: str, v: np.ndarray):
    """A bare ``{name}_kernel`` / ``{name}_bias`` param."""
    return _at(base, "kernel" if leaf.endswith("_kernel") else "bias", v)


def _hed_path(path, v):
    if path == ("norm",):
        return "norm", v.reshape(1, 3, 1, 1)
    if len(path) == 3 and re.match(r"block\d$", path[0]):
        m = re.match(r"convs_(\d+)$", path[1])
        sub = f"convs.{m.group(1)}" if m else path[1]
        return _at(f"{path[0]}.{sub}", path[2], v)
    return None


def hed_state_dict(params) -> Dict[str, torch.Tensor]:
    """``ControlNetHED`` state dict from flax ControlNetHED params."""
    return _annotator(params, _hed_path)


def _pidinet_path(path, v):
    head = path[0]
    if head == "classifier_kernel":
        return _at("classifier", "kernel", v)
    if head == "classifier_bias":
        return "classifier.bias", v
    if head == "init_block" or re.match(r"block\d_\d$", head):
        return _at(".".join(path[:-1]), path[-1], v)
    m = re.match(r"(dilations|attentions|conv_reduces)_(\d+)$", head)
    if not m:
        return None
    base = f"{m.group(1)}.{m.group(2)}"
    if m.group(1) == "conv_reduces":
        return _at(f"{base}.conv", path[-1], v)
    if path[1].startswith("conv2_") and path[1].endswith("_kernel"):
        return _at(f"{base}.{path[1][:-7]}", "kernel", v)
    return _at(f"{base}.{path[1]}", path[2], v)


def pidinet_state_dict(params) -> Dict[str, torch.Tensor]:
    """``PiDiNet`` state dict from flax PiDiNet params."""
    return _annotator(params, _pidinet_path)


_MIDAS_ROOT = {
    "cls_token": "pretrained.model.cls_token",
    "pos_embed": "pretrained.model.pos_embed",
    "patch_embed": "pretrained.model.patch_embed.proj",
    "readout3": "pretrained.act_postprocess3.0.project.0",
    "readout4": "pretrained.act_postprocess4.0.project.0",
    "act_postprocess3_proj": "pretrained.act_postprocess3.3",
    "act_postprocess4_proj": "pretrained.act_postprocess4.3",
    "act_postprocess4": "pretrained.act_postprocess4.4",
    "head_conv1": "scratch.output_conv.0",
    "head_conv2": "scratch.output_conv.2",
    "head_conv3": "scratch.output_conv.4",
}
_BIT = "pretrained.model.patch_embed.backbone"


def _midas_path(path, v):
    head, leaf = path[0], path[-1]
    if head in ("cls_token", "pos_embed"):
        return _MIDAS_ROOT[head], v
    if head in _MIDAS_ROOT:
        return _at(_MIDAS_ROOT[head], leaf, v)
    if head == "resnet":
        sub = path[1]
        if sub == "conv_stem":
            return _at(f"{_BIT}.stem.conv", leaf, v)
        if sub == "gn_stem":
            return _at(f"{_BIT}.stem.norm", leaf, v)
        m = re.match(r"stage(\d)_(\d+)$", sub)
        if not m:
            return None
        base = f"{_BIT}.stages.{int(m.group(1)) - 1}.blocks.{m.group(2)}"
        name = {"downsample": "downsample.conv",
                "downsample_norm": "downsample.norm"}.get(path[2], path[2])
        name = re.sub(r"^gn(\d)$", r"norm\1", name)
        return _at(f"{base}.{name}", leaf, v)
    m = re.match(r"blocks_(\d+)$", head)
    if m:
        sub = path[1]
        group = {"qkv": "attn.", "proj": "attn.", "fc1": "mlp.",
                 "fc2": "mlp."}.get(sub, "")
        return _at(f"pretrained.model.blocks.{m.group(1)}.{group}{sub}",
                   leaf, v)
    if re.match(r"layer\d_rn$", head):
        return _at(f"scratch.{head}", leaf, v)
    if head.startswith("refinenet"):
        return _at("scratch." + ".".join(path[:-1]), leaf, v)
    return None


def midas_state_dict(params) -> Dict[str, torch.Tensor]:
    """``DPTHybrid`` state dict from flax DPTHybrid params (the position
    table at the flax grid)."""
    return _annotator(params, _midas_path)


def _uniformer_path(path, v):
    head, leaf = path[0], path[-1]
    if head == "backbone":
        sub = path[1]
        if re.match(r"(patch_embed|norm)\d$", sub):
            return _at("backbone." + ".".join(path[1:-1]), leaf, v)
        m = re.match(r"blocks(\d)_(\d+)$", sub)
        if not m:
            return None
        base = f"backbone.blocks{m.group(1)}.{m.group(2)}"
        name = path[2]
        if len(path) == 3:                       # bare dw conv params
            return _bare(f"{base}.{name.rsplit('_', 1)[0]}", name, v)
        if name in ("norm1", "norm2") and int(m.group(1)) <= 2:
            return f"{base}.{name}.{_BN[leaf]}", v   # CBlock BatchNorm
        if name in ("qkv", "proj"):
            return _at(f"{base}.attn.{name}", leaf, v)
        if name.startswith("mlp_"):
            return _at(f"{base}.mlp.{name[4:]}", leaf, v)
        return _at(f"{base}.{name}", leaf, v)
    if head != "decode_head":
        return None
    sub = path[1]
    if sub == "conv_seg":
        return _at("decode_head.conv_seg", leaf, v)
    m = re.match(r"(ppm|lateral|fpn)_(\d+)$", sub)
    if m:
        base = {"ppm": f"psp_modules.{m.group(2)}.1",
                "lateral": f"lateral_convs.{m.group(2)}",
                "fpn": f"fpn_convs.{m.group(2)}"}[m.group(1)]
    elif sub in ("bottleneck", "fpn_bottleneck"):
        base = sub
    else:
        return None
    if path[2] == "bn":
        return f"decode_head.{base}.bn.{_BN[leaf]}", v
    return _at(f"decode_head.{base}.{path[2]}", leaf, v)


def uniformer_state_dict(params) -> Dict[str, torch.Tensor]:
    """``UniFormerSeg`` state dict from flax UniFormerSeg params."""
    return _annotator(params, _uniformer_path)


def _openpose_path(path, v):
    """BodyPoseNet: the stem at the top (``model0``), ``stage{s}_L{L}``'s
    convs under ``model{s}_{L}``."""
    if len(path) == 2:
        return _at(f"model0.{path[0]}", path[1], v)
    m = re.match(r"stage(\d)_L(\d)$", path[0])
    if len(path) == 3 and m:
        return _at(f"model{m.group(1)}_{m.group(2)}.{path[1]}", path[2], v)
    return None


def openpose_state_dict(params) -> Dict[str, torch.Tensor]:
    """``BodyPoseNet`` state dict from flax BodyPoseNet params."""
    return _annotator(params, _openpose_path)


def _handpose_path(path, v):
    """HandPoseNet: the stem (``model1_0``) and the conv6 head
    (``model1_1``) at the top, ``stage{s}``'s convs under ``model{s}``."""
    if len(path) == 2:
        head = "model1_1" if path[0].startswith("conv6_") else "model1_0"
        return _at(f"{head}.{path[0]}", path[1], v)
    m = re.match(r"stage(\d)$", path[0])
    if len(path) == 3 and m:
        return _at(f"model{m.group(1)}.{path[1]}", path[2], v)
    return None


def handpose_state_dict(params) -> Dict[str, torch.Tensor]:
    """``HandPoseNet`` state dict from flax HandPoseNet params."""
    return _annotator(params, _handpose_path)


def _mlsd_path(path, v):
    """The inverse of JAX's ``ingest_mlsd`` (``annotator_ingest.py:89``):
    the reference's ``backbone.features.N.conv.i`` and ``blockN.convC.S``
    names."""
    head, leaf = path[0], path[-1]
    if head == "backbone":
        n = int(re.fullmatch(r"features_(\d+)", path[1]).group(1))
        base = f"backbone.features.{n}"
        if n == 0:
            return (_at(f"{base}.0", leaf, v) if len(path) == 3
                    else (f"{base}.1.{_BN[leaf]}", v))
        stages = (("expand", "depthwise", "project", "project_bn") if n != 1
                  else ("depthwise", "project", "project_bn"))
        i = stages.index(path[2])
        if path[2] in ("expand", "depthwise"):
            return (_at(f"{base}.conv.{i}.0", leaf, v) if path[3] == "kernel"
                    else (f"{base}.conv.{i}.1.{_BN[leaf]}", v))
        if path[2] == "project":
            return _at(f"{base}.conv.{i}", leaf, v)
        return f"{base}.conv.{i}.{_BN[leaf]}", v
    m = re.fullmatch(r"block(\d+)", head)
    if not m:
        return None
    if len(path) == 2:                       # block23's bare dilated conv
        return _bare(f"{head}.conv1.0", leaf, v)
    sub = path[1]
    if sub == "conv3":
        return _at(f"{head}.conv3", leaf, v)
    m = re.fullmatch(r"(?:conv(\d)_(conv|bn)|(conv|bn)(\d))", sub)
    c = m.group(1) or m.group(4)
    is_bn = (m.group(2) or m.group(3)) == "bn"
    if is_bn:
        return f"{head}.conv{c}.1.{_BN[leaf]}", v
    return _at(f"{head}.conv{c}.0", leaf, v)


def mlsd_state_dict(params) -> Dict[str, torch.Tensor]:
    """``MobileV2MLSDLarge`` state dict from flax MobileV2MLSDLarge
    params."""
    return _annotator(params, _mlsd_path)


# --- library modules no path runs --------------------------------------------

def _vq_path(path, v):
    head = path[0]
    if head == "quantize":
        return "quantize.embedding.weight", v
    if head in ("encoder", "decoder"):
        return _at(_vae_path(path[:-1]), path[-1], v)
    return _at(head, path[-1], v)


def vq_state_dict(params) -> Dict[str, torch.Tensor]:
    """``VQModel`` state dict (taming's names) from flax VQModel params."""
    return _annotator(params, _vq_path)


def _dotted(path, v):
    """The flax path joined by dots, its ``body_N``/``layers_N`` list
    entries as torch's ``body.N``/``layers.N``."""
    base = ".".join(re.sub(r"^(body|layers)_(\d+)$", r"\1.\2", p)
                    for p in path[:-1])
    return _at(base, path[-1], v)


def lpips_state_dict(params) -> Dict[str, torch.Tensor]:
    """``LPIPS`` state dict (``vgg.conv1_1`` ..., ``lin0`` ...) from flax
    LPIPS params; each ``lin{i}`` is a bare HWIO kernel."""
    return _annotator(params, lambda p, v: (
        _at(p[0], "kernel", v) if len(p) == 1 else _dotted(p, v)))


def patch_discriminator_state_dict(params) -> Dict[str, torch.Tensor]:
    """``PatchDiscriminator`` state dict from flax PatchDiscriminator
    params (the GroupNorms' ``scale`` as ``weight``)."""
    return _annotator(params, _dotted)


def adapter_light_state_dict(params) -> Dict[str, torch.Tensor]:
    """``AdapterLight`` state dict (``body.i.in_conv``,
    ``body.i.body.j.block1`` ...) from flax AdapterLight params."""
    return _annotator(params, _dotted)


def attention_pool_state_dict(params) -> Dict[str, torch.Tensor]:
    """``AttentionPool2d`` state dict: the ``[C, N + 1]`` table as it
    stands, ``qkv_proj``/``c_proj`` as conv1d weights ``[out, in, 1]``."""
    def path_fn(path, v):
        if path == ("positional_embedding",):
            return path[0], v
        key, tv = _at(path[0], path[-1], v)
        return key, (tv[..., None] if path[-1] == "kernel" else tv)
    return _annotator(params, path_fn)


def class_embedder_state_dict(params) -> Dict[str, torch.Tensor]:
    return _annotator(params, _dotted)


def _bert_path(path, v):
    if path == ("pos_emb",):
        return "pos_emb", v
    inner = list(path)
    if len(inner) > 2 and inner[1] in ("fc1", "fc2"):
        inner.insert(1, "mlp")
    return _dotted(tuple(inner), v)


def bert_state_dict(params) -> Dict[str, torch.Tensor]:
    """``BERTEmbedder`` state dict (``token_emb``, ``pos_emb``,
    ``layers.N`` as ``CLIPEncoderLayer``, ``norm``) from flax params."""
    return _annotator(params, _bert_path)


def spatial_rescaler_state_dict(params) -> Dict[str, torch.Tensor]:
    return _annotator(params, _dotted)


def _clip_image_path(path, v):
    if path[0] != "visual":
        return None
    if len(path) == 2:       # class_embedding, position_embedding
        return f"visual.{path[1]}", v
    key, tv = _bert_path(path[1:], v)
    return f"visual.{key}", tv


def clip_image_embedder_state_dict(params) -> Dict[str, torch.Tensor]:
    """``FrozenClipImageEmbedder`` state dict (``visual.*``, the names of
    ``utils.clip_score.CLIPVisionEncoder``) from flax params."""
    return _annotator(params, _clip_image_path)
