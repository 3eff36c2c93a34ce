"""The FG-DM adapter training step in plain PyTorch float32.

What a step of ``models/config.yaml``'s adapter fine-tuning computes,
written out again from the CompVis / FG-DM recipe: the frozen VAE's
posterior sample (scaled by 0.18215), the frozen CLIP context, the noised
latent, the eps-prediction MSE, and on a distillation step (every
``distill_every_n_step``-th, from step 0) 0.1 x KL(teacher || student)
over attention maps: the student's (the UNet with adapter, on the first
``tb = min(max(2, B // 10), 8)`` rows, self maps at the latent's
resolution and every cross map resized to it) against the frozen
teacher's (the same UNet with the adapter off, on the 2x
nearest-upsampled latent and noise, self maps at 2x pooled 4x4 over
tokens, cross maps resized to 2x and pooled 2x2); then AdamW on the
adapter's parameters.  The cubic resize is JAX's ``jax.image.resize
("cubic")``: the Keys kernel with a = -0.5, half-pixel centres, widened by
the scale when shrinking, each output's weights renormalised, taps
outside the input dropped.

Rows run in blocks with the gradients summed, so a batch of any size fits.
This file imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["cubic_weights", "Step", "adamw", "lambda_linear"]


def _keys(x: torch.Tensor) -> torch.Tensor:
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x >= 2.0, torch.zeros_like(x),
                       torch.where(x >= 1.0, far, near))


def cubic_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``[n_in, n_out]`` weights of a cubic resize of one axis."""
    inv = n_in / n_out
    ks = max(inv, 1.0)
    at = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv - 0.5
    dist = (at[None, :] - torch.arange(n_in, dtype=torch.float32,
                                       device=device)[:, None]).abs()
    w = _keys(dist / ks)
    tot = w.sum(dim=0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (at >= -0.5) & (at <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_grid(m: torch.Tensor, out: int) -> torch.Tensor:
    """``[B, r*r, K]`` maps -> ``[B, out, out, K]`` over the query grid."""
    b, n, k = m.shape
    r = int(round(math.sqrt(n)))
    m = m.reshape(b, r, r, k)
    if r == out:
        return m
    w = cubic_weights(r, out, m.device)
    return torch.einsum("ay,cx,back->byxk", w, w, m)


def _token_maps(maps, resn: int, self_tokens: int):
    """Layer-averaged self maps over ``self_tokens`` query tokens and cross
    maps resized to ``resn``."""
    selfs = [s for s, _ in maps if s is not None and s.shape[1] == self_tokens]
    cross = [_resize_grid(c, resn) for _, c in maps]
    return sum(selfs) / len(selfs), sum(cross) / len(cross)


def _kl(t: torch.Tensor, s: torch.Tensor, eps: float = 1e-6):
    b = t.shape[0]
    t = t.reshape(b, -1) + eps
    s = s.reshape(b, -1) + eps
    log_p, log_q = F.log_softmax(t, -1), F.log_softmax(s, -1)
    return (log_p.exp() * (log_p - log_q)).sum() / b


class Step:
    """One training step's loss and the adapter's gradient, over reference
    modules ``unet`` (with adapter), ``vae``, ``clip``."""

    def __init__(self, unet, vae, clip, cfg: dict, block: int = 8):
        self.unet, self.vae, self.clip = unet, vae, clip
        self.cfg, self.block = cfg, block
        betas = np.linspace(cfg["linear_start"] ** 0.5,
                            cfg["linear_end"] ** 0.5, cfg["timesteps"],
                            dtype=np.float64) ** 2
        acp = np.cumprod(1.0 - betas)
        dev = next(unet.parameters()).device
        self.sa = torch.tensor(np.sqrt(acp), dtype=torch.float32, device=dev)
        self.s1a = torch.tensor(np.sqrt(1.0 - acp), dtype=torch.float32,
                                device=dev)
        # the variational bound's weight of each timestep (eps
        # parameterization; t = 0's, whose posterior variance is 0, is t = 1's)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        with np.errstate(divide="ignore"):
            lvlb = betas ** 2 / (2 * post_var * (1.0 - betas) * (1.0 - acp))
        lvlb[0] = lvlb[1]
        self.lvlb = torch.tensor(lvlb, dtype=torch.float32, device=dev)

    def _q(self, x0, t, noise):
        return (self.sa[t][:, None, None, None] * x0
                + self.s1a[t][:, None, None, None] * noise)

    def __call__(self, image, ids, t, noise, post_eps, distill: bool
                 ) -> float:
        """Accumulates the gradient of the step's loss into the adapter's
        ``.grad``; returns the loss.  Leaves in ``self.vlb`` the rows'
        squared errors weighted by the variational bound's weights of
        their timesteps, averaged (the ``loss_vlb`` a step reports)."""
        b = image.shape[0]
        tb = min(max(2, b // 10), 8, b)
        total, self.vlb = 0.0, 0.0
        for lo in range(0, b, self.block):
            rows = slice(lo, min(lo + self.block, b))
            with torch.no_grad():
                mean, logvar = self.vae.encode_moments(image[rows])
                x0 = self.cfg["scale_factor"] * (
                    mean + torch.exp(0.5 * logvar) * post_eps[rows])
                ctx = self.clip(ids[rows])
            xn = self._q(x0, t[rows], noise[rows])
            head = distill and lo == 0
            if head:
                k = slice(0, tb)
                out_h, maps = self.unet(xn[k], t[rows][k], ctx[k],
                                        capture=(x0.shape[2] ** 2, 1))
                out = torch.cat([out_h, self.unet(xn[tb:], t[rows][tb:],
                                                  ctx[tb:])]) \
                    if xn.shape[0] > tb else out_h
            else:
                out = self.unet(xn, t[rows], ctx)
            per_row = ((out - noise[rows]) ** 2).mean(dim=(1, 2, 3))
            self.vlb += float((self.lvlb[t[rows]]
                               * per_row.detach()).sum()) / b
            loss = per_row.sum() / b
            if head:
                r = x0.shape[2]
                s_self, s_cross = _token_maps(maps, r, r * r)
                with torch.no_grad():
                    up = lambda z: F.interpolate(z, scale_factor=2,  # noqa
                                                 mode="nearest")
                    x2 = self._q(up(x0[k]), t[rows][k], up(noise[rows][k]))
                    _, tmaps = self.unet(x2, t[rows][k], ctx[k],
                                         adapter_on=False,
                                         capture=(4 * r * r, 4))
                    t_self = sum(s for s, _ in tmaps if s is not None
                                 and s.shape[1] == r * r) / sum(
                        1 for s, _ in tmaps if s is not None
                        and s.shape[1] == r * r)
                    t_cross = sum(
                        _resize_grid(c, 2 * r).reshape(
                            tb, r, 2, r, 2, -1).mean(dim=(2, 4))
                        for _, c in tmaps) / len(tmaps)
                loss = loss + self.cfg.get("distill_weight", 0.1) * (
                    _kl(t_self, s_self) + _kl(t_cross, s_cross))
            loss.backward()
            total += float(loss.detach())
        return total


def lambda_linear(warm_up_steps, f_start, f_max, f_min, cycle_lengths):
    """LDM's ``LambdaLinearScheduler`` over its first cycle: the multiplier
    of the base learning rate at step ``n``, rising linearly from
    ``f_start`` to ``f_max`` over the warm-up, then falling linearly toward
    ``f_min`` at the cycle's end.  Each argument is the config's list of
    one value a cycle."""
    w, f0, f1, fm, c = (x[0] for x in (warm_up_steps, f_start, f_max, f_min,
                                       cycle_lengths))

    def multiplier(n: int) -> float:
        if n < w:
            return f0 + (f1 - f0) / w * n
        return fm + (f1 - fm) * (c - n) / c

    return multiplier


def adamw(params: Sequence[torch.Tensor], state: List[Dict], step: int,
          lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.01) -> None:
    """One AdamW update (decoupled decay, bias-corrected moments) of each
    parameter from its ``.grad``; ``step`` counts from 1."""
    b1, b2 = betas
    with torch.no_grad():
        for p, s in zip(params, state):
            g = p.grad
            s["m"].mul_(b1).add_(g, alpha=1 - b1)
            s["v"].mul_(b2).add_(g * g, alpha=1 - b2)
            p.mul_(1 - lr * weight_decay)
            denom = (s["v"] / (1 - b2 ** step)).sqrt_().add_(eps)
            p.sub_(lr / (1 - b1 ** step) * s["m"] / denom)
            p.grad = None
