"""Autoencoder training losses: LPIPS perceptual + PatchGAN adversarial.

Counterpart of ``fgdm_tpu/diffusion/perceptual_losses.py:33-150``:
``VGG16Features`` (relu taps after each of the five stages, 2x2 max pool
between them), ``LPIPS`` (each tap normalised over its channels by
``|.| + 1e-10``, the squared difference weighted by a per-layer 1x1
``lin{i}`` in float32, averaged over space and summed), the 70x70
``PatchDiscriminator`` (4x4 convs with padding 1, flax ``nn.GroupNorm``
with eps 1e-6 and ``min(32, nf)`` groups, leaky ReLU 0.2),
``hinge_d_loss``, ``vanilla_d_loss`` and ``generator_loss``.  Tensors are
NCHW; everything is differentiable with autograd.

The module trees carry JAX's names (``vgg.conv1_1``, ``lin0``, ``conv0``,
``norm1``, ``conv_out``): no released file is read.  The VGG's 3x3 convs are
the ``nn/layers.py`` ``Conv2d``, so in bf16 with ``FGDM_PALLAS_CONV=1`` the
ones its gate admits run the conv kernel, as JAX's do.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.nn.layers import Conv2d

__all__ = ["VGG_MEAN", "VGG_STD", "VGG_PLAN", "VGG16Features", "LPIPS",
           "PatchDiscriminator", "hinge_d_loss", "vanilla_d_loss",
           "generator_loss"]

VGG_MEAN = (0.485, 0.456, 0.406)
VGG_STD = (0.229, 0.224, 0.225)
# VGG16 feature taps (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)
VGG_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16Features(nn.Module):
    """x01 ``[B, 3, H, W]`` in [0, 1] -> the five relu taps."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        cin = 3
        for si, (ch, n) in enumerate(VGG_PLAN):
            for ci in range(n):
                self.add_module(f"conv{si + 1}_{ci + 1}",
                                Conv2d(cin, ch, 3, dtype=dtype))
                cin = ch
        self.register_buffer("mean", torch.tensor(VGG_MEAN).reshape(3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(VGG_STD).reshape(3, 1, 1),
                             persistent=False)

    def forward(self, x01) -> Tuple[torch.Tensor, ...]:
        h = (x01 - self.mean) / self.std
        taps = []
        for si, (_, n) in enumerate(VGG_PLAN):
            for ci in range(n):
                h = F.relu(getattr(self, f"conv{si + 1}_{ci + 1}")(h))
            taps.append(h)
            if si < len(VGG_PLAN) - 1:
                h = F.max_pool2d(h, 2)
        return tuple(taps)


class _Lin(Conv2d):
    """A bias-free float32 1x1 calibration head, 0.1 at init (JAX's
    ``constant(0.1)``: a distance before any weights are read)."""

    def __init__(self, channels: int):
        super().__init__(channels, 1, 1, padding=0, bias=False)

    def reset_parameters(self, generator=None):
        nn.init.constant_(self.weight, 0.1)


class LPIPS(nn.Module):
    """Perceptual distance: x, y ``[B, 3, H, W]`` in [-1, 1] -> ``[B]``."""

    def __init__(self, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.vgg = VGG16Features(dtype)
            for i, (ch, _) in enumerate(VGG_PLAN):
                self.add_module(f"lin{i}", _Lin(ch))

    def forward(self, x, y):
        fx, fy = self.vgg((x + 1) / 2), self.vgg((y + 1) / 2)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            wd = getattr(self, f"lin{i}")(((a - b) ** 2).float())
            total = total + wd.mean(dim=(1, 2, 3))
        return total


class _GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, eps=1e-6)`` as JAX's discriminator
    uses it: statistics in float32, a float32 result."""

    def __init__(self, channels: int, num_groups: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, eps=1e-6)


class PatchDiscriminator(nn.Module):
    """70x70 PatchGAN (``n_layers=3``), as in taming-transformers:
    ``[B, in_channels, H, W]`` -> patch logits ``[B, 1, h, w]``."""

    def __init__(self, ndf: int = 64, n_layers: int = 3,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.n_layers = n_layers
        with torch.device(resolve_device(device)):
            self.conv0 = Conv2d(in_channels, ndf, 4, stride=2, padding=1,
                                dtype=dtype)
            nf = ndf
            for i in range(1, n_layers + 1):
                prev, nf = nf, min(ndf * 2 ** i, ndf * 8)
                self.add_module(f"conv{i}", Conv2d(
                    prev, nf, 4, stride=2 if i < n_layers else 1, padding=1,
                    bias=False, dtype=dtype))
                self.add_module(f"norm{i}", _GroupNorm(nf, min(32, nf)))
            self.conv_out = Conv2d(nf, 1, 4, padding=1, dtype=dtype)

    def forward(self, x):
        h = F.leaky_relu(self.conv0(x), 0.2)
        for i in range(1, self.n_layers + 1):
            h = getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(h))
            h = F.leaky_relu(h, 0.2)
        return self.conv_out(h)


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real))
                  + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.softplus(-logits_real))
                  + torch.mean(F.softplus(logits_fake)))


def generator_loss(
    x: torch.Tensor,
    recon: torch.Tensor,
    lpips_fn: Callable,
    disc_fn: Optional[Callable] = None,
    kl: Optional[torch.Tensor] = None,
    codebook_loss: Optional[torch.Tensor] = None,
    kl_weight: float = 1e-6,
    codebook_weight: float = 1.0,
    perceptual_weight: float = 1.0,
    disc_weight: float = 0.5,
    disc_active: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The first-stage generator objective: ``|x - recon|`` + LPIPS + the
    KL or codebook term + the adversarial term; ``(loss, log)``."""
    loss = torch.mean(torch.abs(x - recon))
    log = {"rec_loss": loss}
    if perceptual_weight > 0:
        p = torch.mean(lpips_fn(x, recon))
        log["p_loss"] = p
        loss = loss + perceptual_weight * p
    if kl is not None:
        klm = torch.mean(kl)
        log["kl_loss"] = klm
        loss = loss + kl_weight * klm
    if codebook_loss is not None:
        log["codebook_loss"] = codebook_loss
        loss = loss + codebook_weight * codebook_loss
    if disc_fn is not None and disc_active:
        g = -torch.mean(disc_fn(recon))
        log["g_loss"] = g
        loss = loss + disc_weight * g
    log["total_loss"] = loss
    return loss, log
