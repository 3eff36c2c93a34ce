"""Training-free attention-alignment guidance inside the DDIM loop.

Counterpart of ``fgdm_tpu/sampling/guidance.py`` (reference
``ddim.py:288-376 update_align_loss_self_cross`` and the losses of
``ldm/models/diffusion/loss.py``).  At scheduled steps the sampler runs a
gradient-descent inner loop on the model input, ``x <- x - grad_x(loss)``,
where the loss aligns the self- and cross-attention maps at 16^2 across
batch chunks; the maps are the UNet's per-head probabilities
(``capture="probs"``).

JAX's masked ``fori_loop`` becomes a Python loop of at most ``MAX_ITERS``
iterations.  An iteration runs while the step is active, ``i < max_iter``
and either ``index1 >= 10`` or the previous iteration's loss exceeds
``LOSS_THRESHOLD`` (the first compares 1e4); the threshold reads the loss
on the host, so a step with ``index1 < 10`` syncs once an iteration.  The
gradient is ``torch.autograd.grad`` under ``torch.enable_grad()``, so the
sampler around it runs under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from fgdm_tpu_torch.sampling.ddim import cfg_inputs

__all__ = ["MAX_ITERS", "LOSS_THRESHOLD", "self_alignment_loss",
           "cross_alignment_loss", "alignment_loss", "guided_update",
           "guided_cfg_eps"]

MAX_ITERS = 6          # the schedule's largest max_iter (ddim.py:295-296)
LOSS_THRESHOLD = 0.1   # ddim.py:309

Maps = Dict[str, torch.Tensor]


def _schedule(index1: int) -> Tuple[float, int]:
    """``(loss_scale, max_iter)`` at sampling step ``index1``
    (``ddim.py:291-305``)."""
    for bound, scale, iters in ((2, 4.0, 2), (5, 4.0, 6), (10, 3.0, 3),
                                (20, 3.0, 2)):
        if index1 < bound:
            return scale, iters
    return 1.0, 2


def _active(index1: int) -> bool:
    """Guidance runs at steps 0-9, then every 5th up to 35
    (``ddim.py:318,349-351``)."""
    return index1 < 10 or (index1 % 5 == 0 and index1 <= 35)


def _flat_maps(m: torch.Tensor) -> torch.Tensor:
    """``[B, h, N, M]`` per-head maps -> ``[B*h, N, M]``."""
    return m.reshape(-1, *m.shape[2:]) if m.dim() == 4 else m


def _chunk_align_mse(maps: torch.Tensor, num: int) -> torch.Tensor:
    """Cyclic chunk-pair MSE, sum_i MSE(chunk_i, chunk_(i+1) % num), over
    ``num`` equal chunks of dim 0 truncated to a multiple of ``num``
    (``loss.py:113-124``)."""
    n = (maps.shape[0] // num) * num
    chunks = maps[:n].reshape(num, n // num, *maps.shape[1:])
    return ((chunks - chunks.roll(-1, dims=0)) ** 2).mean() * num


def self_alignment_loss(selfattn: Maps, num: int,
                        res_tokens: int = 256) -> torch.Tensor:
    """Chunk-pair MSE of each self map at ``res_tokens``, averaged over the
    maps (``loss.py:126-137``); 0 without such maps."""
    maps = [_flat_maps(m) for m in selfattn.values()]
    terms = [_chunk_align_mse(m.float(), num) for m in maps
             if m.shape[1] == res_tokens]
    if not terms:
        return torch.zeros(())
    return sum(terms) / len(terms)


def cross_alignment_loss(crossattn: Maps, num: int,
                         res_tokens: int = 256) -> torch.Tensor:
    """The cross maps at ``res_tokens`` averaged over layers, batch and
    heads, the first and last tokens dropped, x100, softmax over tokens,
    chunk-pair MSE over the spatial rows, / num (``loss.py:272-292``)."""
    maps = [_flat_maps(m) for m in crossattn.values()]
    mats = [m.float() for m in maps if m.shape[1] == res_tokens]
    if not mats:
        return torch.zeros(())
    agg = torch.cat(mats)
    agg = agg.sum(dim=0) / agg.shape[0]
    t = torch.softmax(agg[:, 1:-1] * 100.0, dim=-1)
    return _chunk_align_mse(t, num) / num


def alignment_loss(selfattn: Maps, crossattn: Maps, num: int,
                   loss_scale: float, res_tokens: int = 256) -> torch.Tensor:
    """``scale * self_align + scale * cross_align`` (``ddim.py:323-333``)."""
    return loss_scale * (self_alignment_loss(selfattn, num, res_tokens)
                         + cross_alignment_loss(crossattn, num, res_tokens))


def guided_update(apply_model_capture: Callable, x_in: torch.Tensor,
                  t_in: torch.Tensor, cond: Any, index1: int,
                  num: int = 2) -> torch.Tensor:
    """One guidance pass at sampling step ``index1``: up to ``MAX_ITERS``
    gradient-descent iterations on ``x_in``.  The loss threshold gates only
    the early steps (``index1 < 10``); later active steps iterate up to
    ``max_iter`` (``ddim.py:319,349-351``)."""
    if not _active(index1):
        return x_in
    loss_scale, max_iter = _schedule(index1)
    x, prev_loss = x_in, 1e4
    for i in range(MAX_ITERS):
        if i >= max_iter or (index1 < 10 and not prev_loss > LOSS_THRESHOLD):
            break
        x = x.detach().requires_grad_()
        with torch.enable_grad():
            _, sa, ca = apply_model_capture(x, t_in, cond)
            loss = alignment_loss(sa, ca, num, loss_scale)
            grad = (torch.autograd.grad(loss, x)[0] if loss.requires_grad
                    else torch.zeros_like(x))
        x = (x - grad).detach()
        if index1 < 10:
            prev_loss = loss.item()
    return x


def guided_cfg_eps(apply_model_capture: Callable, x: torch.Tensor,
                   t: torch.Tensor, cond: Dict[str, Any], uncond, scale,
                   index1: int) -> torch.Tensor:
    """CFG eps after the guidance pass on the doubled model input
    (reference ``p_sample_ddim`` with ``inference_loss=True``,
    ``ddim.py:228-231``: the model input is nudged, the carried latent is
    not)."""
    b = x.shape[0]
    if uncond is None:
        x_g = guided_update(apply_model_capture, x, t, cond, index1, num=b)
        return apply_model_capture(x_g, t, cond)[0]
    x_in, t_in, c_in = cfg_inputs(x, t, cond, uncond)
    x_in = guided_update(apply_model_capture, x_in, t_in, c_in, index1,
                         num=b)
    e_uc, e_c = apply_model_capture(x_in, t_in, c_in)[0].chunk(2, dim=0)
    return e_uc + scale * (e_c - e_uc)
