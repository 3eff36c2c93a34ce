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
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch.kernels.attention import (attention_with_scores,
                                              multihead_attention)
from fgdm_tpu_torch.nn.layers import Conv2d, Dense, GroupNorm32, LayerNorm32

__all__ = ["CaptureSpec", "CrossAttention", "GEGLU", "FeedForward",
           "BasicTransformerBlock", "SpatialTransformer"]


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
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
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
        if mode == "probs" or attn_editor is not None:
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


class FeedForward(nn.Module):
    """GEGLU -> Dense (the gated form every SD transformer uses)."""

    def __init__(self, dim: int, mult: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = dim * mult
        # index 1 of the reference's net is a Dropout
        self.net = nn.ModuleList([GEGLU(dim, inner, dtype=dtype), nn.Identity(),
                                  Dense(inner, dim, dtype=dtype)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads=n_heads, dim_head=d_head,
                                    dtype=dtype)
        self.attn2 = CrossAttention(dim, context_dim=context_dim,
                                    heads=n_heads, dim_head=d_head,
                                    dtype=dtype)
        self.ff = FeedForward(dim, dtype=dtype)
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
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        self.proj_in = Conv2d(in_channels, inner, 1, padding=0, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, n_heads, d_head,
                                  context_dim=context_dim, dtype=dtype)
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
