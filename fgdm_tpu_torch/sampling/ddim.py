"""DDIM sampling with classifier-free guidance.

Counterpart of ``fgdm_tpu/sampling/ddim.py:47-207``: ``ddim_step`` is the
update of reference ``ddim.py:248-273``; ``cfg_eps`` batches the [uncond,
cond] branches into one model call; ``ddim_sample`` walks the sub-schedule
from the noisiest step, with x_T injection and eta.  The JAX ``lax.scan``
becomes a Python loop.  ``guidance_fn`` (a capture-mode ``apply_model``)
turns on the attention-alignment inner loop of ``sampling/guidance.py``
(reference ``inference_loss=True``, ``ddim.py:190-191,228-231``).
img2img is ``stochastic_encode`` then ``ddim_decode`` (``ddim.py:210-246``,
reference ``ddim.py:378-413``); ``augmented_cfg_eps`` and
``composable_cfg_eps`` are the three-way and composable guidance of
``ddim.py:249-289``.  ``ddim_sample`` also takes JAX's ``log_every_t``
(the x and x0-hat intermediates), ``mask``/``x0``/``schedule`` inpainting
and ``ucg_schedule`` (``ddim.py:122-187``), as ``log_images`` uses them.

Noise comes from explicit ``torch.Generator``s.  With ``slot_seeds`` every
draw is per slot (``slot_noise``): slot b's stream depends only on its own
seed, never on the batch it runs in.  Torch cannot reproduce ``jax.random``
bits; the tests inject x_T instead.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fgdm_tpu_torch.core.schedules import DDIMSchedule
from fgdm_tpu_torch.sampling import step_graph
from fgdm_tpu_torch.utils.profiling import span

__all__ = ["derive_seed", "slot_noise", "initial_noise", "ddim_step",
           "cfg_inputs", "cfg_eps", "ddim_sample", "stochastic_encode",
           "ddim_decode", "augmented_cfg_eps", "composable_cfg_eps"]

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]

# tags separating a slot's noise streams
SLOT_INIT_TAG = 0   # x_T
SLOT_STEP_TAG = 1   # per-step sigma noise (eta > 0)
SLOT_MASK_TAG = 2   # inpainting's re-noise of x0


def derive_seed(*parts: int) -> int:
    """A 63-bit seed determined by the integers ``parts`` alone."""
    if any(int(p) < 0 for p in parts):
        raise ValueError(f"seeds must be non-negative, got {parts}")
    state = np.random.SeedSequence([int(p) for p in parts]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31 | int(state[1])) & ((1 << 63) - 1)


def slot_noise(slot_seeds: Sequence[int], shape: Tuple[int, ...], tag: int,
               device, step: Optional[int] = None) -> torch.Tensor:
    """Per-slot standard normal ``[len(slot_seeds), *shape[1:]]``: slot b
    is drawn from its own generator seeded by (seed_b, tag[, step])."""
    parts = (tag,) if step is None else (tag, step)
    draws = []
    for s in slot_seeds:
        g = torch.Generator(device=device).manual_seed(derive_seed(s, *parts))
        draws.append(torch.randn(tuple(shape[1:]), generator=g, device=device))
    return torch.stack(draws)


def initial_noise(shape: Tuple[int, ...], x_T: Optional[torch.Tensor],
                  generator: Optional[torch.Generator],
                  slot_seeds: Optional[Sequence[int]], device):
    """``(x_T, device)`` for a sampler: ``x_T`` if given, else per-slot
    streams from ``slot_seeds`` (tag ``SLOT_INIT_TAG``), else ``generator``.
    ``device`` defaults to x_T's, else ``generator``'s."""
    if device is None:
        if x_T is None and generator is None:
            raise ValueError("a sampler needs device= with slot_seeds")
        device = x_T.device if x_T is not None else generator.device
    if slot_seeds is not None and len(slot_seeds) != shape[0]:
        raise ValueError(f"{len(slot_seeds)} slot seeds for batch {shape[0]}")
    if x_T is not None:
        x = x_T.to(device=device, dtype=torch.float32)
    elif slot_seeds is not None:
        x = slot_noise(slot_seeds, shape, SLOT_INIT_TAG, device)
    else:
        x = torch.randn(shape, generator=generator, device=device)
    return x, device


def ddim_step(x, e_t, index: int, sched: DDIMSchedule,
              noise: Optional[torch.Tensor] = None,
              temperature: float = 1.0):
    """One DDIM update from the model's eps; returns (x_prev, pred_x0).
    ``temperature`` scales the eta noise term alone (``ddim.py:86``)."""
    a_t = sched.alphas[index]
    a_prev = sched.alphas_prev[index]
    sigma_t = sched.sigmas[index]
    pred_x0 = (x - sched.sqrt_one_minus_alphas[index] * e_t) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(1.0 - a_prev - sigma_t ** 2) * e_t
    x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt
    if noise is not None:
        x_prev = x_prev + sigma_t * noise * temperature
    return x_prev, pred_x0


def _cat(u, c):
    """[u, c] along the batch, leaf by leaf through lists and tuples (the
    ``extra_pconds`` of the N-factor chain), as ``jax.tree.map`` does."""
    if u is None and c is None:
        return None
    if isinstance(c, (list, tuple)):
        if not isinstance(u, (list, tuple)) or len(u) != len(c):
            raise ValueError("cond and uncond lists differ in length")
        return type(c)(_cat(a, b) for a, b in zip(u, c))
    return torch.cat([u, c], dim=0)


def _cat_conds(*conds: Dict[str, Any]) -> Dict[str, Any]:
    """The conds concatenated along the batch, key by key and leaf by
    leaf, in order."""
    keys = set(conds[0])
    if any(set(c) != keys for c in conds):
        raise ValueError("cond keys differ: "
                         + " != ".join(str(sorted(c)) for c in conds))
    out = {}
    for k in conds[0]:
        v = conds[0][k]
        for c in conds[1:]:
            v = _cat(v, c[k])
        out[k] = v
    return out


def cfg_inputs(x, t, cond: Dict[str, Any], uncond: Dict[str, Any]):
    """The doubled model input ``(x_in, t_in, c_in)`` of CFG, [uncond,
    cond] along the batch."""
    return torch.cat([x, x]), torch.cat([t, t]), _cat_conds(uncond, cond)


def cfg_eps(denoise_fn: DenoiseFn, x, t, cond: Dict[str, Any],
            uncond: Optional[Dict[str, Any]], scale: float):
    """Classifier-free guidance with one batched forward, [uncond, cond]."""
    if uncond is None or scale == 1.0:
        return denoise_fn(x, t, cond)
    e_uc, e_c = denoise_fn(*cfg_inputs(x, t, cond, uncond)).chunk(2, dim=0)
    return e_uc + scale * (e_c - e_uc)


def ddim_sample(denoise_fn: DenoiseFn, shape: Tuple[int, ...],
                sched: DDIMSchedule, cond: Dict[str, Any],
                uncond: Optional[Dict[str, Any]] = None,
                cfg_scale: float = 7.5, x_T: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                slot_seeds: Optional[Sequence[int]] = None,
                device=None,
                guidance_fn: Optional[Callable] = None,
                log_every_t: int = 0,
                mask: Optional[torch.Tensor] = None,
                x0: Optional[torch.Tensor] = None,
                schedule=None,
                mask_noise: Union[None, torch.Tensor,
                                  Callable[[int], torch.Tensor]] = None,
                ucg_schedule: Optional[Sequence[float]] = None,
                temperature: float = 1.0,
                callback: Optional[Callable] = None,
                step_noise: Union[None, torch.Tensor,
                                  Callable[[int], torch.Tensor]] = None):
    """Full DDIM loop; returns x_0 (float32, ``shape``), or ``(x_0,
    intermediates)`` when ``log_every_t`` is set: ``"x_inter"`` and
    ``"pred_x0"`` stack x and x0-hat after every ``log_every_t``-th step
    (from the first), ``[S', *shape]``.

    Noise: see ``initial_noise``; with eta > 0 the step noise comes from the
    same source (per slot, or ``generator``).  ``guidance_fn`` ``(x, t,
    cond) -> (eps, selfattn, crossattn)`` replaces ``denoise_fn`` with the
    guided CFG of ``guidance.guided_cfg_eps`` at sampling step ``i`` (0 at
    the noisiest step); the loop then runs under ``torch.no_grad()``, since
    the guidance differentiates through the UNet, else under
    ``torch.inference_mode()``.

    Inpainting (``ddim.py:150-155`` of the reference): with ``mask`` (1
    marks kept regions, ``[B, 1, h, w]``), ``x0`` and the DDPM ``schedule``
    every step first sets ``x = q_sample(x0, t, n) * mask + (1 - mask) * x``;
    ``mask_noise`` gives n for step i (a ``[S, *shape]`` tensor or a
    callable of i), else it is drawn per slot or from ``generator`` before
    that step's eta noise.  ``ucg_schedule[i]`` replaces ``cfg_scale`` at
    step i (cldm's ``ddim_hacked``).  ``temperature`` scales each step's
    eta noise (``ddim_step``); ``step_noise`` gives that noise for step i
    (a ``[S, *shape]`` tensor or a callable of i), as ``mask_noise``
    does.  ``callback`` is accepted and never called,
    as in JAX (``ddim.py:123``).

    On a CUDA device, with eta 0, none of ``guidance_fn``, ``mask``,
    ``log_every_t`` and ``ucg_schedule``, and a ``denoise_fn`` that
    declares ``graph_parts`` (``LatentDiffusion.denoise_fn``), every step
    replays one CUDA graph of the eager step (``step_graph``), with the
    eager loop's numbers."""
    del callback
    if mask is not None and (x0 is None or schedule is None):
        raise ValueError("inpainting needs x0 and the DDPM schedule")
    mode = torch.inference_mode()
    if guidance_fn is not None:
        from fgdm_tpu_torch.sampling.guidance import guided_cfg_eps

        mode = torch.no_grad()
    inter = {"x_inter": [], "pred_x0": []}
    with mode:
        x, device = initial_noise(shape, x_T, generator, slot_seeds, device)
        graph = None
        if (sched.eta == 0.0 and guidance_fn is None and mask is None
                and not log_every_t and ucg_schedule is None):
            graph = step_graph.key(denoise_fn, x, cond, uncond, cfg_scale,
                                   sched)
        if graph is not None:
            def step(xs, idx, sch, c, uc):
                t = sch.timesteps[idx].expand(shape[0])
                e_t = cfg_eps(denoise_fn, xs, t, c, uc, cfg_scale)
                return ddim_step(xs, e_t, idx, sch)[0]

            return step_graph.sample(graph, step, x, sched, cond, uncond)
        sched = sched.to(device)
        if mask is not None:
            schedule = schedule.to(device)
        per_slot = slot_seeds is not None
        steps = sched.num_steps
        for i in range(steps):
            step_graph.STATS["eager_steps"] += 1
            with span("sampler.step", graph=False):
                index = steps - 1 - i
                t = sched.timesteps[index].expand(shape[0])
                if mask is not None:
                    if mask_noise is None:
                        n = (slot_noise(slot_seeds, shape, SLOT_MASK_TAG,
                                        device, i)
                             if per_slot else
                             torch.randn(shape, generator=generator,
                                         device=device))
                    else:
                        n = mask_noise(i) if callable(mask_noise) else \
                            mask_noise[i]
                    x = (schedule.q_sample(x0, t, n.to(device)) * mask
                         + (1.0 - mask) * x)
                scale = (cfg_scale if ucg_schedule is None
                         else ucg_schedule[i])
                if guidance_fn is not None:
                    e_t = guided_cfg_eps(guidance_fn, x, t, cond, uncond,
                                         scale, i)
                else:
                    e_t = cfg_eps(denoise_fn, x, t, cond, uncond, scale)
                noise = None
                if sched.eta != 0.0 and step_noise is not None:
                    noise = (step_noise(i) if callable(step_noise)
                             else step_noise[i]).to(device)
                elif sched.eta != 0.0:
                    noise = (slot_noise(slot_seeds, shape, SLOT_STEP_TAG,
                                        device, i)
                             if per_slot else
                             torch.randn(shape, generator=generator,
                                         device=device))
                x, pred_x0 = ddim_step(x, e_t, index, sched, noise,
                                       temperature)
                if log_every_t and i % log_every_t == 0:
                    inter["x_inter"].append(x)
                    inter["pred_x0"].append(pred_x0)
    if not log_every_t:
        return x
    return x, {k: torch.stack(v) for k, v in inter.items()}


def _bshape(v, x):
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


def stochastic_encode(schedule, sched: DDIMSchedule, x0, t_index, noise):
    """img2img's forward encode of x0 to DDIM step ``t_index`` (an int or
    ``[B]``): ``sqrt(a) x0 + sqrt(1 - a) noise`` with a the step's
    alpha_cumprod, as JAX reads it (``ddim.py:210``).  ``schedule`` (the
    DDPM one) is unused, as in JAX."""
    del schedule
    idx = torch.as_tensor(t_index, device=x0.device)
    sqrt_alphas = torch.sqrt(sched.alphas.to(x0.device))
    sqrt_one_minus = sched.sqrt_one_minus_alphas.to(x0.device)
    return (_bshape(sqrt_alphas[idx], x0) * x0
            + _bshape(sqrt_one_minus[idx], x0) * noise)


def ddim_decode(denoise_fn: DenoiseFn, x_latent, sched: DDIMSchedule,
                t_start: int, cond: Dict[str, Any],
                uncond: Optional[Dict[str, Any]] = None,
                cfg_scale: float = 1.0) -> torch.Tensor:
    """img2img's partial denoise from DDIM step ``t_start`` down to x_0
    (``ddim.py:226``), eta-free steps, under ``torch.inference_mode()``."""
    with torch.inference_mode():
        sched = sched.to(x_latent.device)
        b = x_latent.shape[0]
        x = x_latent
        for i in range(t_start):
            index = t_start - 1 - i
            t = sched.timesteps[index].expand(b)
            e_t = cfg_eps(denoise_fn, x, t, cond, uncond, cfg_scale)
            x, _ = ddim_step(x, e_t, index, sched)
    return x


def augmented_cfg_eps(denoise_fn: DenoiseFn, x, t, cond: Dict[str, Any],
                      aug_cond: Dict[str, Any], uncond: Dict[str, Any],
                      scale: float) -> torch.Tensor:
    """Augmented-conditioning guidance (``ddim.py:249``): one forward over
    [uncond, cond, aug]; ``e = uc + s((ac + s(c - ac)) - uc)``."""
    e = denoise_fn(torch.cat([x, x, x]), torch.cat([t, t, t]),
                   _cat_conds(uncond, cond, aug_cond))
    e_uc, e_c, e_ac = e.chunk(3, dim=0)
    e_t = e_ac + scale * (e_c - e_ac)
    return e_uc + scale * (e_t - e_uc)


def composable_cfg_eps(denoise_fn: DenoiseFn, x, t, conds: Dict[str, Any],
                       uncond: Dict[str, Any],
                       num_prompts: int) -> torch.Tensor:
    """Composable-diffusion guidance (``ddim.py:272``): x of batch 1, conds
    stacked ``[num_prompts, ...]``; ``e = uc + sum_p (c_p - uc)``."""
    n = num_prompts + 1
    e = denoise_fn(torch.cat([x] * n), torch.cat([t] * n),
                   _cat_conds(uncond, conds))
    e_uc, e_cs = e[:1], e[1:]
    return e_uc + (e_cs - e_uc).sum(dim=0, keepdim=True)
