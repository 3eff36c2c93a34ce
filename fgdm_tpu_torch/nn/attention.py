"""Spatial transformer stack (self + cross attention), no-capture path.

Counterpart of ``fgdm_tpu/nn/attention.py:62-268``: ``CrossAttention`` with
bias-free q/k/v projections and ``scale = d_head ** -0.5``; ``GEGLU`` with
the tanh GELU that ``jax.nn.gelu`` defaults to; ``BasicTransformerBlock``
(pre-LayerNorm self-attn, cross-attn, GEGLU feed-forward); and
``SpatialTransformer`` (GroupNorm eps 1e-6, 1x1 proj_in, blocks, zero-init
1x1 proj_out, residual).  Tensors are NCHW outside the transformer and
``[B, N, C]`` inside.  Attention-map capture and ``adapt_q`` are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch.kernels.attention import multihead_attention
from fgdm_tpu_torch.nn.layers import Conv2d, Dense, GroupNorm32, LayerNorm32

__all__ = ["CrossAttention", "GEGLU", "FeedForward", "BasicTransformerBlock",
           "SpatialTransformer"]


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

    def forward(self, x, context=None):
        ctx = x if context is None else context

        def split(t):
            b, n, _ = t.shape
            return t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

        out = multihead_attention(split(self.to_q(x)), split(self.to_k(ctx)),
                                  split(self.to_v(ctx)), self.dim_head ** -0.5)
        b, h, n, d = out.shape
        return self.to_out[0](out.transpose(1, 2).reshape(b, n, h * d))


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

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


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

    def forward(self, x, context=None):
        b, _, hh, ww = x.shape
        h = self.proj_in(self.norm(x))
        c = h.shape[1]
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        for blk in self.transformer_blocks:
            h = blk(h, context=context)
        h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2).contiguous()
        return self.proj_out(h) + x
