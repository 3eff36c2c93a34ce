"""Primitive layers (NCHW, float32 params, compute in a chosen dtype).

Counterpart of ``fgdm_tpu/nn/layers.py:50-225``.  Parameters stay float32;
``Conv2d`` and ``Dense`` cast weight and input to the module's compute
``dtype`` (bf16 on the card) as the JAX layers do, rather than through
``torch.autocast``, whose casting rules differ.  Normalizations compute in
float32 and cast back to the input dtype.

``_PALLAS_CONV`` / ``_PALLAS_CONV_VAE`` (``FGDM_PALLAS_CONV=1`` /
``FGDM_PALLAS_CONV_VAE=1``, default off, as ``layers.py:23-32``) send the
3x3 stride-1 pad-1 convs with a bias that ``kernels/conv.py``'s gates accept
to the direct conv kernel K7.  The gates admit bf16 compute only, so a
float32 ``Conv2d`` keeps ``F.conv2d`` with a flag on; with
``FGDM_DISABLE_PALLAS_CONV=1`` they admit nothing, as JAX's do.  The Winograd branch
is not ported.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch.kernels import conv as kconv
from fgdm_tpu_torch.kernels.groupnorm import (group_norm_silu,
                                              group_norm_silu_ref)

__all__ = ["timestep_embedding", "GroupNorm32", "FusedGroupNormSiLU",
           "LayerNorm32", "Conv2d", "Dense", "Conv1d", "Embed", "nearest_upsample_2x",
           "avg_pool_2x2", "init_params_"]

# The direct 3x3 conv kernel for 16^2-64^2 planes (kernels/conv.py), and for
# the VAE decoder's >= 512^2 128-channel planes; read at call time, so tests
# set them by attribute.
_PALLAS_CONV = os.environ.get("FGDM_PALLAS_CONV", "0") == "1"
_PALLAS_CONV_VAE = os.environ.get("FGDM_PALLAS_CONV_VAE", "0") == "1"

# JAX's truncated-normal variance scaling divides by the std of a standard
# normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding, cos first then sin (reference util.py:160-180)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(nn.Module):
    """GroupNorm in float32, cast back (torch ``GroupNorm(32, ch)``; eps 1e-5,
    the VAE and transformers use 1e-6)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm_silu_ref(x, self.weight, self.bias, self.num_groups,
                                   self.eps, apply_silu=False)


class FusedGroupNormSiLU(GroupNorm32):
    """GroupNorm+SiLU with GroupNorm32's parameters, through the fused
    kernel where its gate allows (``kernels/groupnorm.py``).  SiLU runs
    before the single cast back, as in the TPU kernel."""

    def forward(self, x):
        return group_norm_silu(x, self.weight, self.bias, self.num_groups,
                               self.eps, apply_silu=True)


class LayerNorm32(nn.Module):
    """LayerNorm over the last dim in float32, cast back."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                            self.eps).to(x.dtype)


class Conv2d(nn.Module):
    """NCHW conv with float32 OIHW params, computed in ``dtype``.

    ``padding`` is an int or "same" (k // 2, for stride 1).  ``zero_init``
    reproduces the reference's ``zero_module`` convs."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding="same",
                 bias: bool = True, zero_init: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if padding == "same":
            if stride != 1:
                raise ValueError("padding='same' needs stride 1")
            padding = kernel_size // 2
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _init_weight(self.weight, self.zero_init, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        if ((_PALLAS_CONV or _PALLAS_CONV_VAE) and self.stride == 1
                and self.padding == 1 and self.bias is not None
                and self.weight.shape[2:] == (3, 3)):
            xk = x.to(self.dtype)
            shapes = (xk.shape, self.weight.shape, xk.dtype)
            if ((_PALLAS_CONV and kconv.conv3x3_ok(*shapes))
                    or (_PALLAS_CONV_VAE and kconv.conv3x3_vae_ok(*shapes))):
                # K7 reads a contiguous NCHW plane (an input permuted from
                # HWC, e.g. a hint read from an image, is strided); the
                # weight is cast to xk's dtype inside; the bias stays f32
                return kconv.conv3x3(xk.contiguous(), self.weight, self.bias)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), b,
                        self.stride, self.padding)


class Dense(nn.Module):
    """Linear layer with float32 ``[out, in]`` params, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 zero_init: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.zero_init = dtype, zero_init
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _init_weight(self.weight, self.zero_init, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class Conv1d(Dense):
    """A kernel-size-1 conv1d over tokens: ``Dense`` on ``[..., in]`` with the
    reference's ``[out, in, 1]`` weight (pixel attention's ``qkv`` and
    ``proj_out``, ``openaimodel.py:331,339``), so its keys load as they
    stand."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 zero_init: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias, zero_init, dtype)
        self.weight = nn.Parameter(torch.empty(out_features, in_features, 1))
        self.reset_parameters()

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight[..., 0].to(self.dtype),
                        b)


class Embed(nn.Module):
    """Lookup table with float32 ``[num, features]`` params (flax
    ``nn.Embed``: N(0, 1/features) init; ``zero_init`` for learned position
    tables)."""

    def __init__(self, num_embeddings: int, features: int,
                 zero_init: bool = False):
        super().__init__()
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        if self.zero_init:
            nn.init.zeros_(self.weight)
        else:
            nn.init.normal_(self.weight, std=self.weight.shape[1] ** -0.5,
                            generator=generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


def _init_weight(w: torch.Tensor, zero: bool, generator=None):
    """JAX's default: truncated normal with variance 1/fan_in (lecun)."""
    if zero:
        nn.init.zeros_(w)
        return
    std = 1.0 / math.sqrt(w[0].numel()) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def init_params_(module: nn.Module, generator: torch.Generator,
                 perturb: float = 0.0) -> nn.Module:
    """Re-draw every Conv2d/Dense/Embed weight from ``generator``, then add
    ``perturb`` * N(0, 1) to every parameter (so zero-init heads work)."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Dense, Embed)):
            m.reset_parameters(generator)
    if perturb:
        with torch.no_grad():
            for p in module.parameters():
                p.add_(torch.randn(p.shape, generator=generator,
                                   device=p.device) * perturb)
    return module


def nearest_upsample_2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def avg_pool_2x2(x):
    return F.avg_pool2d(x, 2)
