"""Spatial transformer stack (self + cross attention) with map capture.

Counterpart of ``fgdm_tpu/nn/attention.py:38-268``: ``CrossAttention`` with
bias-free q/k/v projections and ``scale = d_head ** -0.5``; ``GEGLU`` with
the tanh GELU that ``jax.nn.gelu`` defaults to; ``BasicTransformerBlock``
(pre-LayerNorm self-attn, cross-attn, GEGLU feed-forward); and
``SpatialTransformer`` (GroupNorm eps 1e-6, 1x1 proj_in, blocks, zero-init
1x1 proj_out, residual).  Tensors are NCHW outside the transformer and
``[B, N, C]`` inside.

``capture`` (``False``, ``True``/``"sim"``, ``"probs"`` or a
``CaptureSpec``) returns attention maps beside the output, as the JAX
package's static flag does: the head-averaged pre-softmax scores through
``attention_with_scores`` (the distillation loss's maps), or the per-head
probabilities of an explicit f32 softmax (the guided sampler's).  With
``capture`` falsy each module returns its output alone and runs exactly
the no-capture path.  ``adapt_q`` adds the attention of an external query
over the same keys and values.  ``attn_editor`` ``(probs, is_cross) ->
probs`` (prompt-to-prompt, ``utils/ptp.py``) rewrites the probabilities of
the explicit f32 softmax in every layer it is given, as JAX's
``attention.py:111-127`` does; K1 then runs nowhere.

``seq_axis`` (context parallelism, ``parallel/context.py``; JAX's
``attention.py:144,247``) on ``CrossAttention``, ``BasicTransformerBlock``
and ``SpatialTransformer``: inside a sharded forward the self-attention
runs around the ring over the registered group
(``parallel/ring_attention.py``); cross-attention stays local.  Capture
and editing read whole maps and are refused there.

``FeedForward(glu=False)`` (``BasicTransformerBlock(gated_ff=False)``) is
Dense -> tanh GELU in float32 -> Dense (``attention.py:173-183``).

``PixelAttentionBlock`` (``attention.py:271-318``) is the legacy pixel-space
self-attention of ``use_spatial_transformer=False`` UNets: GroupNorm, a
fused ``qkv`` projection held as the reference's conv1d weight, the split
``ch ** -0.25`` scaling of q and k, an f32 softmax, a zero-init
``proj_out`` and the residual.  Its math is torch ops, as JAX's is XLA's:
no kernel of this port runs it.  ``AttentionPool2d`` (``:321-370``) pools
a feature map to one vector the same way: a mean token prepended, the
reference's ``[C, N + 1]`` positional table, a fused ``qkv_proj`` read q/k/v
outermost, ``ch ** -0.25`` on q and k, an f32 softmax and ``c_proj`` of
token 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch.kernels.attention import (attention_with_scores,
                                              multihead_attention)
from fgdm_tpu_torch.nn.layers import (Conv1d, Conv2d, Dense, GroupNorm32,
                                      LayerNorm32)
from fgdm_tpu_torch.parallel import context as cp
from fgdm_tpu_torch.parallel.ring_attention import ring_attention

__all__ = ["CaptureSpec", "CrossAttention", "GEGLU", "FeedForward",
           "BasicTransformerBlock", "SpatialTransformer",
           "PixelAttentionBlock", "AttentionPool2d"]


@dataclasses.dataclass(frozen=True)
class CaptureSpec:
    """A capture filter (``attention.py:39-59``): which maps to emit, at
    what pooling.

    ``self_n``: emit self-attention maps only for layers with this many
    tokens (None: every layer); a self layer with another count runs the
    plain path and emits nothing.  ``self_pool``: the flat-window pooling
    factor of the emitted self maps (``attention_with_scores(pool_kq=)``).
    Cross-attention maps are always emitted, never pooled."""

    mode: str = "sim"          # "sim" | "probs"
    self_n: Optional[int] = None
    self_pool: int = 1


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64,
                 dtype: torch.dtype = torch.float32,
                 seq_axis: Optional[str] = None):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.seq_axis = seq_axis
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(ctx_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(ctx_dim, inner, bias=False, dtype=dtype)
        # index 1 of the reference's to_out is a Dropout
        self.to_out = nn.ModuleList([Dense(inner, query_dim, dtype=dtype)])

    def forward(self, x, context=None, adapt_q=None, capture=False,
                attn_editor=None):
        """The attention output ``[B, N, query_dim]``; with ``capture`` set,
        ``(output, maps)``: ``[B, N, M]`` f32 head-averaged scores
        (``True``/``"sim"``), ``[B, h, N, M]`` f32 probabilities
        (``"probs"``, after the editor), or None for a self layer a
        ``CaptureSpec`` filters out.  With ``attn_editor`` every capture
        mode but ``"probs"`` gives the head-averaged scores, unfiltered and
        unpooled, as in JAX."""
        is_cross = context is not None
        ctx = x if context is None else context
        scale = self.dim_head ** -0.5

        def split(t):
            b, n, _ = t.shape
            return t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = (split(self.to_q(x)), split(self.to_k(ctx)),
                   split(self.to_v(ctx)))
        spec = capture if isinstance(capture, CaptureSpec) else None
        mode = spec.mode if spec is not None else capture
        probs = None
        ring = (self.seq_axis is not None and not is_cross
                and cp.sharded_group() is not None)
        if ring and (capture or attn_editor is not None):
            raise ValueError("attention capture and editing read whole maps:"
                             " not under context parallelism")
        if ring:
            out = ring_attention(q, k, v, cp.sharded_group(), scale)
        elif mode == "probs" or attn_editor is not None:
            # the explicit f32 path: every layer, K1's shapes included
            sim = torch.matmul(q.float(),
                               k.float().transpose(-1, -2)).mul_(scale)
            attn = torch.softmax(sim, dim=-1)
            if capture and mode != "probs":
                probs = sim.mean(dim=1)
            del sim   # f32 [B, h, N, M]: 2 GiB a self layer at 64^2, CFG 4
            if attn_editor is not None:
                attn = attn_editor(attn, is_cross)
            out = torch.matmul(attn.to(v.dtype), v)
            if mode == "probs":
                probs = attn
        elif (spec is not None and not is_cross and spec.self_n is not None
              and x.shape[1] != spec.self_n):
            out = multihead_attention(q, k, v, scale)
        elif capture:
            pool = spec.self_pool if spec is not None and not is_cross else 1
            out, probs = attention_with_scores(q, k, v, scale, pool_kq=pool)
        else:
            out = multihead_attention(q, k, v, scale)
        if adapt_q is not None:
            out = out + multihead_attention(split(adapt_q), k, v, scale)
        b, h, n, d = out.shape
        out = self.to_out[0](out.transpose(1, 2).reshape(b, n, h * d))
        return (out, probs) if capture else out


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Dense(dim_in, 2 * dim_out, dtype=dtype)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate.float(), approximate="tanh").to(x.dtype)


class _DenseGELU(nn.Module):
    """The reference's ``project_in = Sequential(Linear, GELU)`` of an
    ungated feed-forward (key ``net.0.0``), with ``jax.nn.gelu``'s tanh
    form in float32, cast back (``attention.py:180-181``)."""

    def __init__(self, dim_in: int, dim_out: int, dtype: torch.dtype):
        super().__init__()
        self.add_module("0", Dense(dim_in, dim_out, dtype=dtype))

    def forward(self, x):
        h = self._modules["0"](x)
        return F.gelu(h.float(), approximate="tanh").to(h.dtype)


class FeedForward(nn.Module):
    """GEGLU -> Dense (the gated form every SD transformer uses), or with
    ``glu=False`` Dense -> tanh GELU -> Dense."""

    def __init__(self, dim: int, mult: int = 4, glu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = dim * mult
        first = (GEGLU(dim, inner, dtype=dtype) if glu
                 else _DenseGELU(dim, inner, dtype))
        # index 1 of the reference's net is a Dropout
        self.net = nn.ModuleList([first, nn.Identity(),
                                  Dense(inner, dim, dtype=dtype)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None, gated_ff: bool = True,
                 dtype: torch.dtype = torch.float32,
                 seq_axis: Optional[str] = None):
        super().__init__()
        self.seq_axis = seq_axis
        self.attn1 = CrossAttention(dim, heads=n_heads, dim_head=d_head,
                                    dtype=dtype, seq_axis=seq_axis)
        self.attn2 = CrossAttention(dim, context_dim=context_dim,
                                    heads=n_heads, dim_head=d_head,
                                    dtype=dtype, seq_axis=seq_axis)
        self.ff = FeedForward(dim, glu=gated_ff, dtype=dtype)
        self.norm1 = LayerNorm32(dim)
        self.norm2 = LayerNorm32(dim)
        self.norm3 = LayerNorm32(dim)

    def forward(self, x, context=None, adapt_q=None, capture=False,
                attn_editor=None):
        """x ``[B, N, dim]``; with ``capture`` set, ``(x, (self_maps,
        cross_maps))``.  ``attn_editor`` edits both layers' maps."""
        def attend(attn, h, **kw):
            out = attn(h, capture=capture, attn_editor=attn_editor, **kw)
            return out if capture else (out, None)

        y, self_maps = attend(self.attn1, self.norm1(x))
        x = y + x
        y, cross_maps = attend(self.attn2, self.norm2(x), context=context,
                               adapt_q=adapt_q)
        x = y + x
        x = self.ff(self.norm3(x)) + x
        return (x, (self_maps, cross_maps)) if capture else x


class SpatialTransformer(nn.Module):
    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, context_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 seq_axis: Optional[str] = None):
        super().__init__()
        inner = n_heads * d_head
        self.seq_axis = seq_axis
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        self.proj_in = Conv2d(in_channels, inner, 1, padding=0, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, n_heads, d_head,
                                  context_dim=context_dim, dtype=dtype,
                                  seq_axis=seq_axis)
            for _ in range(depth)])
        self.proj_out = Conv2d(inner, in_channels, 1, padding=0,
                               zero_init=True, dtype=dtype)

    def forward(self, x, context=None, adapt_q=None, capture=False,
                attn_editor=None):
        """x ``[B, C, H, W]``; with ``capture`` set, ``(x, maps)`` with the
        last block's ``(self_maps, cross_maps)``."""
        b, _, hh, ww = x.shape
        h = self.proj_in(self.norm(x))
        c = h.shape[1]
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        maps = None
        for blk in self.transformer_blocks:
            if capture:
                h, maps = blk(h, context=context, adapt_q=adapt_q,
                              capture=capture, attn_editor=attn_editor)
            else:
                h = blk(h, context=context, adapt_q=adapt_q,
                        attn_editor=attn_editor)
        h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2).contiguous()
        out = self.proj_out(h) + x
        return (out, maps) if capture else out


class PixelAttentionBlock(nn.Module):
    """Self-attention over a feature map's pixels (reference
    ``AttentionBlock`` with ``QKVAttentionLegacy``/``QKVAttention``,
    ``openaimodel.py:304-434``).  ``use_new_attention_order`` reads the qkv
    channels as ``[3, heads, ch]``; the legacy order as ``[heads, 3, ch]``.
    Self-attention only: no context, capture or editor."""

    def __init__(self, channels: int, num_heads: int = 1,
                 use_new_attention_order: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels over {num_heads} heads")
        self.num_heads = num_heads
        self.new_order = use_new_attention_order
        self.norm = GroupNorm32(channels)
        self.qkv = Conv1d(channels, 3 * channels, dtype=dtype)
        self.proj_out = Conv1d(channels, channels, zero_init=True,
                               dtype=dtype)

    def forward(self, x):
        """x ``[B, C, H, W]`` -> the same shape."""
        if cp.sharded_group() is not None:
            raise ValueError("PixelAttentionBlock has no context-parallel "
                             "path (JAX's takes no seq_axis)")
        b, c, hh, ww = x.shape
        nh, n = self.num_heads, hh * ww
        ch = c // nh
        tokens = x.reshape(b, c, n).transpose(1, 2)
        qkv = self.qkv(self.norm(x).reshape(b, c, n).transpose(1, 2))
        if self.new_order:
            q, k, v = qkv.reshape(b, n, 3, nh, ch).unbind(2)
        else:
            q, k, v = qkv.reshape(b, n, nh, 3, ch).unbind(3)
        # the reference's f16-stable form: ch ** -0.25 on q and on k
        scale = float(ch) ** -0.25
        q, k, v = (q.transpose(1, 2) * scale, k.transpose(1, 2) * scale,
                   v.transpose(1, 2))
        w = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)),
                          dim=-1).to(v.dtype)
        a = torch.matmul(w, v).transpose(1, 2).reshape(b, n, c)
        out = tokens + self.proj_out(a)
        return out.transpose(1, 2).reshape(b, c, hh, ww).contiguous()


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling (reference ``AttentionPool2d``,
    ``openaimodel.py:37-64``): ``[B, C, H, W]`` with ``H * W ==
    spacial_dim ** 2`` -> ``[B, output_dim or C]``."""

    def __init__(self, spacial_dim: int, embed_dim: int,
                 num_heads_channels: int, output_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if embed_dim % num_heads_channels:
            raise ValueError(f"{embed_dim} channels in heads of "
                             f"{num_heads_channels}")
        self.spacial_dim, self.ch = spacial_dim, num_heads_channels
        self.positional_embedding = nn.Parameter(
            torch.empty(embed_dim, spacial_dim ** 2 + 1))
        self.qkv_proj = Conv1d(embed_dim, 3 * embed_dim, dtype=dtype)
        self.c_proj = Conv1d(embed_dim, output_dim or embed_dim, dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        c = self.positional_embedding.shape[0]
        nn.init.normal_(self.positional_embedding, std=c ** -0.5,
                        generator=generator)

    def forward(self, x):
        b, c, hh, ww = x.shape
        if hh * ww != self.spacial_dim ** 2:
            raise ValueError(f"{hh}x{ww} map for spacial_dim "
                             f"{self.spacial_dim}")
        ch = self.ch
        nh = c // ch
        tok = x.reshape(b, c, hh * ww).transpose(1, 2)
        tok = torch.cat([tok.mean(dim=1, keepdim=True), tok], dim=1)
        t = tok.shape[1]
        tok = tok + self.positional_embedding.t()[None].to(tok.dtype)
        q, k, v = (u.reshape(b, t, nh, ch).transpose(1, 2)
                   for u in self.qkv_proj(tok).chunk(3, dim=-1))
        scale = float(ch) ** -0.25
        w = torch.softmax(torch.matmul((q * scale).float(),
                                       (k * scale).float().transpose(-1, -2)),
                          dim=-1).to(v.dtype)
        a = torch.matmul(w, v).transpose(1, 2).reshape(b, t, c)
        return self.c_proj(a[:, 0])
