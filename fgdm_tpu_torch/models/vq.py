"""VQ-GAN first stage (taming-transformers style).

Counterpart of ``fgdm_tpu/models/vq.py:25-118``: ``VectorQuantizer`` (the
nearest codebook entry by ``|z|^2 + |e|^2 - 2 z.e`` and ``argmin``, the
loss ``beta * mean((sg(z_q) - z)^2) + mean((z_q - sg(z))^2)`` and the
straight-through output) and ``VQModel`` (the KL VAE's ``Encoder`` with
``double_z=False`` and its ``Decoder``, ``quant_conv`` and
``post_quant_conv``), with ``encode``, ``encode_pre_quant``, ``decode`` and
``decode_pre_quant(force_not_quantize)``; ``quantize.lookup`` reads codes.
The module tree carries taming's names (``encoder.*``, ``decoder.*``,
``quantize.embedding.weight``, ``quant_conv``, ``post_quant_conv``).

The Encoder and Decoder keep ``fused_norm`` off, as JAX's ``VQModel`` does.
The distance product runs with TF32 off (``full_f32``): TF32 would flip
``argmin`` between near-equidistant codes.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from fgdm_tpu_torch import full_f32, resolve_device
from fgdm_tpu_torch.models.autoencoder import Decoder, Encoder
from fgdm_tpu_torch.nn.layers import Conv2d

__all__ = ["VectorQuantizer", "VQModel"]


class _Codebook(nn.Module):
    """``[n_embed, embed_dim]`` float32 entries, uniform in [0, 2/n_embed)
    at init (flax ``uniform(scale=2/n_embed)``)."""

    def __init__(self, n_embed: int, embed_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_embed, embed_dim))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        nn.init.uniform_(self.weight, 0.0, 2.0 / self.weight.shape[0],
                         generator=generator)


class VectorQuantizer(nn.Module):
    """Nearest-neighbour codebook with straight-through gradients."""

    def __init__(self, n_embed: int = 16384, embed_dim: int = 4,
                 beta: float = 0.25):
        super().__init__()
        self.embed_dim, self.beta = embed_dim, beta
        self.embedding = _Codebook(n_embed, embed_dim)

    def forward(self, z):
        """z ``[B, D, H, W]`` -> ``(z_q, loss, indices [B, H, W])``; z_q in
        z's dtype, the loss a float32 scalar."""
        zf = z.float().permute(0, 2, 3, 1)
        codebook = self.embedding.weight
        flat = zf.reshape(-1, self.embed_dim)
        with torch.no_grad(), full_f32():
            d = (flat.pow(2).sum(dim=1, keepdim=True)
                 + codebook.pow(2).sum(dim=1)[None]
                 - 2.0 * flat @ codebook.t())
            idx = torch.argmin(d, dim=1)
        z_q = codebook[idx].reshape(zf.shape)
        loss = (self.beta * torch.mean((z_q.detach() - zf) ** 2)
                + torch.mean((z_q - zf.detach()) ** 2))
        z_q = zf + (z_q - zf).detach()
        return (z_q.permute(0, 3, 1, 2).to(z.dtype), loss,
                idx.reshape(zf.shape[:-1]))

    def lookup(self, indices):
        """The codebook entries of ``indices``, on a new last axis (JAX's
        ``lookup``: ``codebook[indices]``)."""
        return self.embedding.weight[indices]


class VQModel(nn.Module):
    def __init__(self, n_embed: int = 16384, embed_dim: int = 4,
                 ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (), in_channels: int = 3,
                 out_ch: int = 3, resolution: int = 256, z_channels: int = 4,
                 beta: float = 0.25, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.encoder = Encoder(ch, ch_mult, num_res_blocks,
                                   attn_resolutions, in_channels, resolution,
                                   z_channels, double_z=False, dtype=dtype)
            self.decoder = Decoder(ch, ch_mult, num_res_blocks,
                                   attn_resolutions, out_ch, resolution,
                                   z_channels, dtype=dtype)
            self.quantize = VectorQuantizer(n_embed, embed_dim, beta)
            self.quant_conv = Conv2d(z_channels, embed_dim, 1, padding=0,
                                     dtype=dtype)
            self.post_quant_conv = Conv2d(embed_dim, z_channels, 1,
                                          padding=0, dtype=dtype)

    def encode(self, x):
        """x ``[B, 3, H, W]`` -> ``(z_q, emb_loss, indices)``."""
        return self.quantize(self.encode_pre_quant(x))

    def encode_pre_quant(self, x):
        """``VQModelInterface.encode``: the continuous latents."""
        return self.quant_conv(self.encoder(x))

    def decode(self, z_q):
        return self.decoder(self.post_quant_conv(z_q))

    def decode_pre_quant(self, h, force_not_quantize: bool = False):
        """``VQModelInterface.decode``: quantize, then decode."""
        if force_not_quantize:
            return self.decode(h)
        return self.decode(self.quantize(h)[0])

    def forward(self, x):
        z_q, emb_loss, _ = self.encode(x)
        return self.decode(z_q), emb_loss
