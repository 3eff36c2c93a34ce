"""First-stage VAE (AutoencoderKL), SD-1.x compatible.

Counterpart of ``fgdm_tpu/models/autoencoder.py``: ``VaeResnetBlock``,
``VaeAttnBlock`` (``:74-115``), ``VaeDownsample`` (``:118``), ``VaeUpsample``
(both with JAX's ``with_conv``), ``Encoder`` (``:144``), ``Decoder``
(``:193-240``, with ``tanh_out``), ``DiagonalGaussian``
(``:244``) and ``AutoencoderKL`` (``:277``) with ``quant_conv`` /
``post_quant_conv``, and ``NpleAutoencoderKL`` (``:328-343``), which
encodes and decodes N latents stacked along the channels.  All GroupNorms
use eps 1e-6.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.kernels.attention import multihead_attention
from fgdm_tpu_torch.nn.blocks import silu
from fgdm_tpu_torch.nn.layers import (Conv2d, FusedGroupNormSiLU, GroupNorm32,
                                      nearest_upsample_2x)

__all__ = ["VaeResnetBlock", "VaeAttnBlock", "VaeDownsample", "VaeUpsample",
           "Encoder", "Decoder", "DiagonalGaussian", "AutoencoderKL",
           "NpleAutoencoderKL"]


class VaeResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 conv_shortcut: bool = False, fused_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = out_channels or in_channels
        norm = FusedGroupNormSiLU if fused_norm else GroupNorm32
        self.fused_norm = fused_norm
        self.norm1 = norm(in_channels, eps=1e-6)
        self.conv1 = Conv2d(in_channels, out, 3, dtype=dtype)
        self.norm2 = norm(out, eps=1e-6)
        self.conv2 = Conv2d(out, out, 3, dtype=dtype)
        self.shortcut = None   # the reference names it by its kernel size
        if in_channels != out:
            self.shortcut = "conv_shortcut" if conv_shortcut else "nin_shortcut"
            k = 3 if conv_shortcut else 1
            self.add_module(self.shortcut, Conv2d(in_channels, out, k,
                                                  padding=k // 2, dtype=dtype))

    def _norm_act(self, norm, h):
        return norm(h) if self.fused_norm else silu(norm(h))

    def forward(self, x):
        h = self.conv1(self._norm_act(self.norm1, x))
        h = self.conv2(self._norm_act(self.norm2, h))
        if self.shortcut is not None:
            x = getattr(self, self.shortcut)(x)
        return x + h


class VaeAttnBlock(nn.Module):
    """Single-head spatial self-attention with 1x1-conv projections; the
    d=512 head runs the flash kernel where the gate allows."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = in_channels
        self.norm = GroupNorm32(c, eps=1e-6)
        self.q = Conv2d(c, c, 1, padding=0, dtype=dtype)
        self.k = Conv2d(c, c, 1, padding=0, dtype=dtype)
        self.v = Conv2d(c, c, 1, padding=0, dtype=dtype)
        self.proj_out = Conv2d(c, c, 1, padding=0, dtype=dtype)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)

        def tokens(t):  # [B, C, H, W] -> [B, 1, HW, C]
            return t.reshape(b, c, hh * ww).transpose(1, 2)[:, None]

        a = multihead_attention(tokens(self.q(h)), tokens(self.k(h)),
                                tokens(self.v(h)), scale=c ** -0.5)
        a = a[:, 0].transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(a)


class VaeDownsample(nn.Module):
    """The reference's asymmetric (0, 1, 0, 1) pad, then a stride-2 VALID
    3x3 conv, so checkpoints match; with ``with_conv=False`` a 2x2 average
    pool of stride 2."""

    def __init__(self, channels: int, with_conv: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = (Conv2d(channels, channels, 3, stride=2, padding=0,
                            dtype=dtype) if with_conv else None)

    def forward(self, x):
        if self.conv is None:
            return F.avg_pool2d(x, 2)
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class VaeUpsample(nn.Module):
    """Nearest 2x, then a 3x3 conv unless ``with_conv=False``."""

    def __init__(self, channels: int, with_conv: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = (Conv2d(channels, channels, 3, dtype=dtype) if with_conv
                     else None)

    def forward(self, x):
        x = nearest_upsample_2x(x)
        return x if self.conv is None else self.conv(x)


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (), in_channels: int = 3,
                 resolution: int = 256, z_channels: int = 4,
                 double_z: bool = True, fused_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n_levels = len(ch_mult)
        in_ch_mult = (1,) + tuple(ch_mult)
        curr_res = resolution

        def resnet(cin, cout=None):
            return VaeResnetBlock(cin, cout, fused_norm=fused_norm,
                                  dtype=dtype)

        self.conv_in = Conv2d(in_channels, ch, 3, dtype=dtype)
        downs = []
        for i_level in range(n_levels):
            down = nn.Module()
            block_in = ch * in_ch_mult[i_level]
            block_out = ch * ch_mult[i_level]
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(resnet(block_in, block_out))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(VaeAttnBlock(block_in, dtype=dtype))
            down.block = nn.ModuleList(blocks)
            down.attn = nn.ModuleList(attns)
            if i_level != n_levels - 1:
                down.downsample = VaeDownsample(block_in, dtype=dtype)
                curr_res //= 2
            downs.append(down)
        self.down = nn.ModuleList(downs)
        self.mid = nn.Module()
        self.mid.block_1 = resnet(block_in)
        self.mid.attn_1 = VaeAttnBlock(block_in, dtype=dtype)
        self.mid.block_2 = resnet(block_in)
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = Conv2d(block_in,
                               2 * z_channels if double_z else z_channels, 3,
                               dtype=dtype)

    def forward(self, x):
        h = self.conv_in(x)
        for down in self.down:
            for j, blk in enumerate(down.block):
                h = blk(h)
                if len(down.attn):
                    h = down.attn[j](h)
            if hasattr(down, "downsample"):
                h = down.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (), out_ch: int = 3,
                 resolution: int = 256, z_channels: int = 4,
                 fused_norm: bool = False, tanh_out: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.tanh_out = tanh_out
        n_levels = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (n_levels - 1)

        def resnet(cin, cout=None):
            return VaeResnetBlock(cin, cout, fused_norm=fused_norm,
                                  dtype=dtype)

        self.conv_in = Conv2d(z_channels, block_in, 3, dtype=dtype)
        self.mid = nn.Module()
        self.mid.block_1 = resnet(block_in)
        self.mid.attn_1 = VaeAttnBlock(block_in, dtype=dtype)
        self.mid.block_2 = resnet(block_in)
        ups = [None] * n_levels
        for i_level in reversed(range(n_levels)):
            up = nn.Module()
            block_out = ch * ch_mult[i_level]
            blocks, attns = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(resnet(block_in, block_out))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(VaeAttnBlock(block_in, dtype=dtype))
            up.block = nn.ModuleList(blocks)
            up.attn = nn.ModuleList(attns)
            if i_level != 0:
                up.upsample = VaeUpsample(block_in, dtype=dtype)
                curr_res *= 2
            ups[i_level] = up
        self.up = nn.ModuleList(ups)
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = Conv2d(block_in, out_ch, 3, dtype=dtype)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for up in reversed(self.up):
            for j, blk in enumerate(up.block):
                h = blk(h)
                if len(up.attn):
                    h = up.attn[j](h)
            if hasattr(up, "upsample"):
                h = up.upsample(h)
        h = self.conv_out(silu(self.norm_out(h)))
        return torch.tanh(h) if self.tanh_out else h


@dataclasses.dataclass
class DiagonalGaussian:
    """Diagonal Gaussian over latents (reference ``distributions.py:24-62``);
    ``from_moments`` splits the encoder's mean/logvar channels."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @staticmethod
    def from_moments(moments: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = moments.chunk(2, dim=1)
        return DiagonalGaussian(mean, logvar.clamp(-30.0, 20.0))

    @property
    def std(self):
        return torch.exp(0.5 * self.logvar)

    def sample(self, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mean + std * eps, with eps injected or drawn from ``generator``."""
        if eps is None:
            eps = torch.randn(self.mean.shape, generator=generator,
                              device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + self.std * eps.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        return 0.5 * torch.sum(self.mean ** 2 + torch.exp(self.logvar) - 1.0
                               - self.logvar,
                               dim=tuple(range(1, self.mean.dim())))


class AutoencoderKL(nn.Module):
    """The SD-1.x first stage: encoder and ``quant_conv``, then
    ``post_quant_conv`` and the decoder."""

    def __init__(self, embed_dim: int = 4, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (), in_channels: int = 3,
                 out_ch: int = 3, resolution: int = 256, z_channels: int = 4,
                 double_z: bool = True, fused_norm: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.encoder = Encoder(ch, ch_mult, num_res_blocks,
                                   attn_resolutions, in_channels, resolution,
                                   z_channels, double_z, fused_norm, dtype)
            self.decoder = Decoder(ch, ch_mult, num_res_blocks,
                                   attn_resolutions, out_ch, resolution,
                                   z_channels, fused_norm, dtype=dtype)
            self.quant_conv = Conv2d(2 * z_channels if double_z
                                     else z_channels, 2 * embed_dim, 1,
                                     padding=0, dtype=dtype)
            self.post_quant_conv = Conv2d(embed_dim, z_channels, 1, padding=0,
                                          dtype=dtype)

    def encode(self, x) -> DiagonalGaussian:
        """x ``[B, 3, H, W]`` in [-1, 1] -> the posterior over latents."""
        return DiagonalGaussian.from_moments(self.quant_conv(self.encoder(x)))

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


class NpleAutoencoderKL(AutoencoderKL):
    """The VAE of joint factor latents (reference ``autoencoder.py:
    426-483``): ``nple`` latents stacked along the channels, e.g. an
    8-channel latent holding two 4-channel factors.  The weights are
    ``AutoencoderKL``'s."""

    def __init__(self, *args, nple: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        self.nple = nple

    def encode_nple(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Each image's posterior mode, concatenated along the channels."""
        return torch.cat([self.encode(x).mode() for x in xs], dim=1)

    def decode_nple(self, z: torch.Tensor):
        """``nple`` equal channel chunks of ``z``, each decoded."""
        if z.shape[1] % self.nple:
            raise ValueError(f"{z.shape[1]} latent channels do not split "
                             f"into {self.nple} equal chunks")
        return tuple(self.decode(c) for c in z.chunk(self.nple, dim=1))
