"""SD-1.x UNet with the FG-DM adapter injection (NCHW).

Counterpart of ``fgdm_tpu/models/unet.py:41-295``: 12 input blocks (conv_in,
then per level ``num_res_blocks`` ResBlocks + SpatialTransformers and a
Downsample between levels), middle block (Res, Transformer, Res), 12 output
blocks with skip concatenation, GroupNorm -> SiLU -> zero-conv head.

* Adapter injection (``unet.py:223-229``): the adapter reads ``pcond`` if
  given, else the noisy latent itself, and its per-level feature is added
  after the last ResBlock of each level.  ``adapter_on=False`` is the
  frozen-SD path on the same weights.  ``use_time_adapter`` makes it a
  ``TimeAdapter`` fed the timestep embedding (``unet.py:121-125``).
* Multi-adapter composition (``num_prompts > 1``, ``unet.py:130-139``):
  ``num_prompts - 1`` more plain adapters, ``adapters.{k}``, each reading
  ``extra_pconds[k]``; their features are added to the main adapter's,
  level by level.  With ``extra_pconds=None`` they do not run.
* ControlNet residual injection (``unet.py:255-266``): the last residual
  goes into the middle output, the rest onto the encoder skips in reverse.

* Attention capture (``unet.py:170-200,293-295``): with ``capture`` set
  the forward also returns the maps of every SpatialTransformer, in two
  dicts keyed as the JAX package keys them (``"input_blocks.{i}.1"``,
  ``"middle_block.1"``, ``"output_blocks.{i}.1"``).
* Attention editing (``unet.py:91,185-196``): ``attn_editor`` reaches every
  attention layer with its block's place (prompt-to-prompt).
* Activation checkpointing (``remat``, the config's ``use_checkpoint``,
  ``unet.py:144-190``): ``torch.utils.checkpoint`` over each ResBlock, each
  pixel-attention block and each SpatialTransformer that neither captures
  nor edits.  The recompute runs the kernels' forwards again, so their
  launch counts include it.
* The config's variants (``unet.py:108-110,157-168,234-238,276-281``):
  ``use_spatial_transformer=False`` puts the legacy ``PixelAttentionBlock``
  (``use_new_attention_order`` picks its qkv layout) at the attention
  resolutions, self-attention only; ``resblock_updown`` resamples with
  ``ResBlock(down=True)``/``ResBlock(up=True)`` in place of
  ``Downsample``/``Upsample``; ``num_classes`` adds ``label_emb``, a class
  embedding added to the timestep embedding, read from ``forward(y=)``.

* Context parallelism (``seq_axis``, ``unet.py:100``): the forward runs
  on this rank's rows of the latent inside ``parallel.context.sharded``;
  the SpatialTransformers' self-attention goes around the ring.  A level
  whose rows do not divide over the group runs whole: its input is
  gathered before the downsampling into it (here and in the adapter) and
  the rows are cut again after the upsampling out of it
  (``parallel/context.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.models.adapter import Adapter, TimeAdapter
from fgdm_tpu_torch.nn.attention import PixelAttentionBlock, SpatialTransformer
from fgdm_tpu_torch.nn.blocks import Downsample, ResBlock, Upsample, silu
from fgdm_tpu_torch.nn.layers import (Conv2d, Dense, Embed, GroupNorm32,
                                      timestep_embedding)
from fgdm_tpu_torch.parallel import context as cp

__all__ = ["UNetModel", "build_encoder", "run_block", "time_embed",
           "down_levels", "up_levels"]


def _heads_for(ch: int, num_heads: int, num_head_channels: int):
    if num_head_channels == -1:
        return num_heads, ch // num_heads
    return ch // num_head_channels, num_head_channels


def time_embed(mc: int, dtype) -> nn.ModuleList:
    # reference indices: [Linear, SiLU, Linear]
    return nn.ModuleList([Dense(mc, 4 * mc, dtype=dtype), nn.Identity(),
                          Dense(4 * mc, 4 * mc, dtype=dtype)])


def embed_timesteps(te: nn.ModuleList, timesteps, mc: int):
    return te[2](silu(te[0](timestep_embedding(timesteps, mc))))


def _recompute(layer, *args):
    # the blocks draw no random numbers: no RNG state to save and restore
    return checkpoint(layer, *args, use_reentrant=False,
                      preserve_rng_state=False)


def run_block(block: nn.ModuleList, h, emb, context, capture=False,
              maps=None, name: str = "", attn_editor=None,
              remat: bool = False):
    """Apply one TimestepEmbedSequential-style block.  With ``capture`` its
    SpatialTransformer's self and cross maps go into ``maps = (selfattn,
    crossattn)`` under ``"{name}.{index in the block}"``.  ``attn_editor``
    ``(probs, is_cross, place)`` reaches every attention layer of the block
    with the block's place, ``"down"``, ``"mid"`` or ``"up"`` by the first
    letter of ``name`` (``unet.py:185-196``).  ``remat`` recomputes the
    ResBlocks, and the SpatialTransformers unless they capture or edit, in
    the backward instead of keeping their activations (``unet.py:144-190``);
    it acts only where autograd records."""
    editor = None
    if attn_editor is not None:
        place = {"i": "down", "m": "mid", "o": "up"}[name[0]]

        def editor(p, is_cross):
            return attn_editor(p, is_cross, place)
    remat = remat and torch.is_grad_enabled()
    for j, layer in enumerate(block):
        if isinstance(layer, ResBlock):
            h = _recompute(layer, h, emb) if remat else layer(h, emb)
        elif isinstance(layer, PixelAttentionBlock):
            if capture or editor is not None:
                raise ValueError("attention capture and editing need "
                                 "use_spatial_transformer=True (the "
                                 "reference's AttentionBlock exposes no "
                                 "maps)")
            h = _recompute(layer, h) if remat else layer(h)
        elif isinstance(layer, SpatialTransformer):
            if not capture:
                if remat and editor is None:
                    h = _recompute(layer, h, context)
                else:
                    h = layer(h, context=context, attn_editor=editor)
                continue
            h, probs = layer(h, context=context, capture=capture,
                             attn_editor=editor)
            for store, m in zip(maps, probs):
                if m is not None:
                    store[f"{name}.{j}"] = m
        else:
            h = layer(h)
    return h


def _attention(ch, num_heads, num_head_channels, transformer_depth,
               context_dim, use_spatial_transformer, use_new_attention_order,
               dtype, seq_axis=None):
    n_heads, d_head = _heads_for(ch, num_heads, num_head_channels)
    if not use_spatial_transformer:
        return PixelAttentionBlock(
            ch, n_heads, use_new_attention_order=use_new_attention_order,
            dtype=dtype)
    return SpatialTransformer(ch, n_heads, d_head, depth=transformer_depth,
                              context_dim=context_dim, dtype=dtype,
                              seq_axis=seq_axis)


def down_levels(blocks) -> dict:
    """``{input block index: the level it downsamples into}``."""
    out, level = {}, 0
    for i, blk in enumerate(blocks):
        if isinstance(blk[0], Downsample) or (isinstance(blk[0], ResBlock)
                                              and blk[0].down):
            level += 1
            out[i] = level
    return out


def up_levels(blocks, n_levels: int) -> dict:
    """``{output block index: the level it upsamples into}``."""
    out, level = {}, n_levels - 1
    for i, blk in enumerate(blocks):
        if isinstance(blk[-1], Upsample) or (isinstance(blk[-1], ResBlock)
                                             and blk[-1].up):
            level -= 1
            out[i] = level
    return out


def build_encoder(in_channels, mc, num_res_blocks, attention_resolutions,
                  channel_mult, num_heads, num_head_channels,
                  transformer_depth, context_dim, use_scale_shift_norm,
                  conv_resample, fused_norm, dtype,
                  use_spatial_transformer: bool = True,
                  use_new_attention_order: bool = False,
                  resblock_updown: bool = False, seq_axis=None):
    """The SD encoder shared by the UNet and ControlNet.

    Returns ``(input_blocks, middle_block, input_block_chans, level_ends,
    ds)``: ``level_ends`` are the input-block indices after the last
    ResBlock of each level (where adapter features land), ``ds`` the final
    downsampling factor."""
    emb_ch = 4 * mc

    def res(cin, cout, down=False):
        return ResBlock(cin, emb_ch, cout,
                        use_scale_shift_norm=use_scale_shift_norm,
                        down=down, fused_norm=fused_norm, dtype=dtype)

    def attn(ch):
        return _attention(ch, num_heads, num_head_channels,
                          transformer_depth, context_dim,
                          use_spatial_transformer, use_new_attention_order,
                          dtype, seq_axis)

    blocks = [nn.ModuleList([Conv2d(in_channels, mc, 3, dtype=dtype)])]
    chans, level_ends = [mc], []
    ch, ds = mc, 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            layers = [res(ch, mult * mc)]
            ch = mult * mc
            if ds in attention_resolutions:
                layers.append(attn(ch))
            blocks.append(nn.ModuleList(layers))
            chans.append(ch)
        level_ends.append(len(blocks) - 1)
        if level != len(channel_mult) - 1:
            blocks.append(nn.ModuleList([
                res(ch, ch, down=True) if resblock_updown
                else Downsample(ch, conv_resample, dtype=dtype)]))
            chans.append(ch)
            ds *= 2
    middle = nn.ModuleList([res(ch, ch), attn(ch), res(ch, ch)])
    return nn.ModuleList(blocks), middle, chans, level_ends, ds


class UNetModel(nn.Module):
    def __init__(self, in_channels: int = 4, model_channels: int = 320,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_heads: int = 8, num_head_channels: int = -1,
                 transformer_depth: int = 1,
                 context_dim: Optional[int] = 768,
                 use_scale_shift_norm: bool = False,
                 conv_resample: bool = True, use_adapter: bool = True,
                 adapter_channels: Optional[int] = None,
                 use_time_adapter: bool = False, num_prompts: int = 1,
                 use_spatial_transformer: bool = True,
                 use_new_attention_order: bool = False,
                 resblock_updown: bool = False,
                 num_classes: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 fused_norm_silu: bool = False,
                 seq_axis: Optional[str] = None, remat: bool = False,
                 device=None):
        super().__init__()
        mc = model_channels
        self.model_channels, self.dtype = mc, dtype
        self.remat = remat
        self.in_channels = in_channels
        self.channel_mult = tuple(channel_mult)
        self.attention_resolutions = tuple(attention_resolutions)
        self.seq_axis = seq_axis
        with torch.device(resolve_device(device)):
            self.time_embed = time_embed(mc, dtype)
            self.label_emb = (Embed(num_classes, 4 * mc)
                              if num_classes is not None else None)
            self.adapter = None
            ad = dict(channels=tuple(m * mc for m in channel_mult),
                      nums_rb=2, cin=adapter_channels or in_channels,
                      ksize=1, sk=True, use_conv=False, dtype=dtype)
            if use_adapter:
                self.adapter = (TimeAdapter(emb_ch=4 * mc, **ad)
                                if use_time_adapter else Adapter(**ad))
            self.adapters = nn.ModuleList(
                Adapter(**ad) for _ in range(num_prompts - 1 if use_adapter
                                             else 0))
            (self.input_blocks, self.middle_block, chans, level_ends,
             ds) = build_encoder(
                in_channels, mc, num_res_blocks, attention_resolutions,
                channel_mult, num_heads, num_head_channels, transformer_depth,
                context_dim, use_scale_shift_norm, conv_resample,
                fused_norm_silu, dtype, use_spatial_transformer,
                use_new_attention_order, resblock_updown, seq_axis)
            self._adapter_at = tuple(level_ends)
            ch = chans[-1]
            out_blocks = []
            def res(cin, cout, up=False):
                return ResBlock(cin, 4 * mc, cout,
                                use_scale_shift_norm=use_scale_shift_norm,
                                up=up, fused_norm=fused_norm_silu,
                                dtype=dtype)

            for level, mult in reversed(list(enumerate(channel_mult))):
                for i in range(num_res_blocks + 1):
                    layers = [res(ch + chans.pop(), mult * mc)]
                    ch = mult * mc
                    if ds in attention_resolutions:
                        layers.append(_attention(
                            ch, num_heads, num_head_channels,
                            transformer_depth, context_dim,
                            use_spatial_transformer, use_new_attention_order,
                            dtype, seq_axis))
                    if level and i == num_res_blocks:
                        layers.append(
                            res(ch, ch, up=True) if resblock_updown
                            else Upsample(ch, conv_resample, dtype=dtype))
                        ds //= 2
                    out_blocks.append(nn.ModuleList(layers))
            self.output_blocks = nn.ModuleList(out_blocks)
            self._down_at = down_levels(self.input_blocks)
            self._up_at = up_levels(self.output_blocks, len(channel_mult))
            # reference indices: [GroupNorm, SiLU, conv]
            self.out = nn.ModuleList([
                GroupNorm32(ch), nn.Identity(),
                Conv2d(mc, out_channels, 3, zero_init=True, dtype=dtype)])

    def forward(self, x, timesteps, context=None, pcond=None,
                adapter_on: bool = True, control=None,
                only_mid_control: bool = False, capture=False,
                extra_pconds=None, attn_editor=None, y=None):
        """x ``[B, C, H, W]``, timesteps ``[B]``, context ``[B, 77, D]``;
        ``control`` holds ControlNet's 13 residuals; ``extra_pconds`` the
        extra adapters' prompts (the first ``num_prompts - 1`` are read);
        ``y`` ``[B]`` the class labels of a ``num_classes`` UNet.
        Returns float32 eps; with ``capture`` (``nn.attention.
        CrossAttention``'s modes) ``(eps, selfattn, crossattn)``.
        ``attn_editor`` ``(probs, is_cross, place) -> probs`` edits every
        attention layer's probabilities (prompt-to-prompt,
        ``utils/ptp.py``).  With ``seq_axis`` every map (x, ``pcond``,
        ``control``) holds this rank's rows."""
        with cp.sharded(self.seq_axis, x.shape[2], len(self.channel_mult)):
            return self._forward(x, timesteps, context, pcond, adapter_on,
                                 control, only_mid_control, capture,
                                 extra_pconds, attn_editor, y)

    def _forward(self, x, timesteps, context, pcond, adapter_on, control,
                 only_mid_control, capture, extra_pconds, attn_editor, y):
        emb = embed_timesteps(self.time_embed, timesteps, self.model_channels)
        if self.label_emb is not None:
            if y is None:
                raise ValueError("a num_classes UNet needs the labels y")
            emb = emb + self.label_emb(y).to(emb.dtype)
        h = x.to(self.dtype)
        feats = None
        if self.adapter is not None and adapter_on:
            # each pyramid walks the levels on its own (cp.sharded restores)
            with cp.sharded(self.seq_axis):
                feats = self.adapter(h if pcond is None
                                     else pcond.to(self.dtype), emb)
            if extra_pconds is not None:
                for ad, ep in zip(self.adapters, extra_pconds):
                    with cp.sharded(self.seq_axis):
                        extra = ad(ep.to(self.dtype))
                    feats = [a + b for a, b in zip(feats, extra)]
            feats = list(feats)
        maps = ({}, {})

        def block(blk, h, name):
            return run_block(blk, h, emb, context, capture, maps, name,
                             attn_editor, self.remat)

        hs = []
        for i, blk in enumerate(self.input_blocks):
            if i in self._down_at:
                h = cp.enter_down(h, self._down_at[i])
            h = block(blk, h, f"input_blocks.{i}")
            if feats is not None and i in self._adapter_at:
                h = h + feats.pop(0).to(h.dtype)
            hs.append(h)
        h = block(self.middle_block, h, "middle_block")
        ctrl = list(control) if control is not None else None
        if ctrl is not None:
            h = h + ctrl.pop().to(h.dtype)
        for i, blk in enumerate(self.output_blocks):
            skip = hs.pop()
            if ctrl is not None and not only_mid_control:
                skip = skip + ctrl.pop().to(h.dtype)
            h = block(blk, torch.cat([h, skip], dim=1), f"output_blocks.{i}")
            if i in self._up_at:
                h = cp.leave_up(h, self._up_at[i])
        h = silu(self.out[0](h))
        eps = self.out[2](h).float()
        return (eps, *maps) if capture else eps
