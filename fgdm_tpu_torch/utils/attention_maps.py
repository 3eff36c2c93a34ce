"""Attention-map aggregation for the distillation loss.

Counterpart of ``fgdm_tpu/utils/attention_maps.py:25-107`` (reference
``utils/attention_utils.py:152-263 get_token_maps``): the UNet returns its
maps (``capture``), and these functions aggregate them on the device.

* Self-attention: only the maps at the loss resolution ``resn`` are used,
  layer-averaged.
* Cross-attention: every layer's map is resized over its query grid to
  ``resn x resn`` and layer-averaged.

The resize is ``jax.image.resize(method="cubic")``'s, not
``F.interpolate(mode="bicubic")``'s: the Keys cubic with a = -0.5 at
half-pixel centres, taps outside the input dropped and each output's
weights renormalised to sum 1, and the kernel widened by 1/scale when
downsampling (antialias).  ``_cubic_weights`` builds that separable weight
matrix.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["get_token_maps", "avg_pool_map_2x", "kl_distill_loss"]


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel with a = -0.5 at distances ``x >= 0``."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x >= 2.0, torch.zeros_like(x),
                       torch.where(x >= 1.0, far, near))


def _cubic_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``[n_in, n_out]`` f32 weights of a cubic resize from ``n_in`` to
    ``n_out`` samples (``jax._src.image.scale.compute_weight_mat``)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                           device=device)[:, None]).abs()
    w = _keys_cubic(dist / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_query_grid(m: torch.Tensor, r: int, resn: int) -> torch.Tensor:
    """``[B, r^2, K]`` -> cubic resize of the ``r x r`` query grid ->
    ``[B, resn^2, K]`` (float32 for a float32 map)."""
    if r == resn:
        return m
    b, _, k = m.shape
    w = _cubic_weights(r, resn, m.device).to(m.dtype)
    out = torch.einsum("ay,cx,back->byxk", w, w, m.reshape(b, r, r, k))
    return out.reshape(b, resn * resn, k)


def get_token_maps(selfattn: Dict[str, torch.Tensor],
                   crossattn: Dict[str, torch.Tensor], resn: int = 32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(self_maps [B, resn^2, resn^2], cross_maps [B, resn, resn, 77])``
    from the captured ``[B, N, M]`` maps."""
    self_sum, n_self = None, 0
    for m in selfattn.values():
        r = int(round(m.shape[1] ** 0.5))
        if r != resn:
            continue
        self_sum = m if self_sum is None else self_sum + m
        n_self += 1
    if self_sum is None:
        raise ValueError(f"no self-attention maps at resolution {resn}")
    cross_sum, n_cross = None, 0
    for m in crossattn.values():
        r = int(round(m.shape[1] ** 0.5))
        m = _resize_query_grid(m, r, resn).reshape(m.shape[0], resn, resn,
                                                   -1)
        cross_sum = m if cross_sum is None else cross_sum + m
        n_cross += 1
    return self_sum / n_self, cross_sum / n_cross


def avg_pool_map_2x(m: torch.Tensor, times: int = 1) -> torch.Tensor:
    """``2^times``-fold average pool over both token axes of ``[B, N, M]``
    maps (the reference's ``downsample1``, ``ddpm.py:130,1813``), summed in
    f32 and cast back."""
    w = 2 ** times
    b, n, k = m.shape
    s = m.float().reshape(b, n // w, w, k // w, w).sum(dim=(2, 4))
    return (s / (w * w)).to(m.dtype)


def kl_distill_loss(teacher_self: torch.Tensor, teacher_cross: torch.Tensor,
                    student_self: torch.Tensor, student_cross: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """KL(teacher || student) over the softmaxed flattened maps, summed and
    divided by the batch (reference ``compute_attn_distill_loss``,
    ``ddpm.py:1785-1797``), self term plus cross term."""

    def kl(t, s):
        b = t.shape[0]
        t = t.reshape(b, -1) + eps
        s = s.reshape(b, -1) + eps
        p = torch.softmax(t, dim=-1)
        log_p, log_q = torch.log_softmax(t, dim=-1), torch.log_softmax(s, -1)
        return (p * (log_p - log_q)).sum() / b

    return kl(teacher_self, student_self) + kl(teacher_cross, student_cross)
