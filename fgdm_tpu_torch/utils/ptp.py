"""Prompt-to-prompt attention control: editors passed through the UNet.

Counterpart of ``fgdm_tpu/utils/ptp.py`` (the reference's
``utils/ptp_utils.py:333-675``, which monkeypatches ``CrossAttention`` and
mutates a controller object per call).  Here ``EditController.editor(step)``
returns a function ``(probs, is_cross, place) -> probs`` that the UNet hands
every attention layer (``attn_editor``):

* replace, refine and reweight edit the conditional half of the CFG batch
  with the mappers of ``utils/seq_aligner.py``; batch item 0 is the base
  prompt (``ptp_utils.py:512-520, 596-614``).  Self maps are replaced by the
  base's at ``N <= self_edit_max_res`` within ``[self_replace_lo,
  self_replace_hi)``;
* ``store``, when a list, collects the cross maps at ``store_res`` tokens
  (16^2) for ``LocalBlend``, which blends the edited latents toward the base
  where the selected words attend (``ptp_utils.py:437-471``);
* ``get_equalizer`` builds token reweighting vectors
  (``ptp_utils.py:478-489``).

The tables are built on the host (numpy, then float32 tensors on the CPU);
``to(device)`` moves them to where the sampler runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from fgdm_tpu_torch.utils import seq_aligner

__all__ = ["get_time_words_attention_alpha", "get_equalizer",
           "EditController", "make_controller", "LocalBlend"]


def get_time_words_attention_alpha(
        prompts: Sequence[str], num_steps: int,
        cross_replace_steps: Union[float, Tuple[float, float],
                                   Dict[str, Any]],
        tokenizer, max_len: int = 77) -> np.ndarray:
    """``[num_steps+1, P-1, 1, 1, max_len]``: 1 where the cross map is
    replaced at a step.  A dict spec maps words to their own (lo, hi)
    fractions beside ``"default_"`` (added to the caller's dict when
    absent, as the JAX package does)."""
    if not isinstance(cross_replace_steps, dict):
        cross_replace_steps = {"default_": cross_replace_steps}
    if "default_" not in cross_replace_steps:
        cross_replace_steps["default_"] = (0.0, 1.0)

    def bounds(spec):
        if isinstance(spec, (float, int)):
            return 0.0, float(spec)
        return float(spec[0]), float(spec[1])

    lo, hi = bounds(cross_replace_steps["default_"])
    alphas = np.zeros((num_steps + 1, len(prompts) - 1, max_len), np.float32)
    steps = np.arange(num_steps + 1) / num_steps
    alphas[:] = ((steps >= lo) & (steps < hi)).astype(np.float32)[:, None,
                                                                   None]
    for word, spec in cross_replace_steps.items():
        if word == "default_":
            continue
        wlo, whi = bounds(spec)
        on = ((steps >= wlo) & (steps < whi)).astype(np.float32)
        for p_idx, prompt in enumerate(prompts[1:]):
            inds = seq_aligner.get_word_inds(prompt, word, tokenizer)
            for t in range(num_steps + 1):
                alphas[t, p_idx, inds] = on[t]
    return alphas.reshape(num_steps + 1, len(prompts) - 1, 1, 1, max_len)


def get_equalizer(text: str, word_select: Union[str, Sequence[str]],
                  values: Sequence[float], tokenizer,
                  max_len: int = 77) -> np.ndarray:
    """``[len(values), max_len]`` token weights: ``values[i]`` at the
    selected words' tokens, 1 elsewhere."""
    if isinstance(word_select, str):
        word_select = (word_select,)
    eq = np.ones((len(values), max_len), np.float32)
    for word in word_select:
        inds = seq_aligner.get_word_inds(text, word, tokenizer)
        for vi, v in enumerate(values):
            eq[vi, inds] = v
    return eq


def _moved(obj, device):
    """A copy of the dataclass ``obj`` with its tensors (and an ``inner``
    controller's) on ``device``."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif isinstance(v, EditController):
            changes[f.name] = v.to(device)
    return dataclasses.replace(obj, **changes)


@dataclasses.dataclass
class EditController:
    """A static editing recipe; ``editor(step)`` is the attention transform
    at sampling step ``step`` (0 at the noisiest)."""

    kind: str                                    # replace | refine | reweight
    num_steps: int
    batch_size: int                              # number of prompts P
    cross_replace_alpha: torch.Tensor            # [S+1, P-1, 1, 1, 77]
    self_replace_lo: int
    self_replace_hi: int
    mapper_matrix: Optional[torch.Tensor] = None   # replace [P-1, 77, 77]
    mapper_idx: Optional[torch.Tensor] = None      # refine  [P-1, 77]
    alphas: Optional[torch.Tensor] = None          # refine  [P-1, 1, 1, 77]
    equalizer: Optional[torch.Tensor] = None       # reweight [P-1, 77]
    inner: Optional["EditController"] = None       # reweight chaining
    self_edit_max_res: int = 256                   # 16^2 (ptp_utils.py:592)
    cfg_doubled: bool = True
    store: Optional[List] = None                   # cross maps for LocalBlend
    store_res: int = 256                           # collect the 16^2 maps

    def to(self, device) -> "EditController":
        return _moved(self, device)

    def replace_cross(self, base, edits):
        """base ``[h, N, 77]``, edits ``[P-1, h, N, 77]`` -> the edited
        cross probabilities."""
        if self.kind == "replace":
            return torch.einsum("hpw,bwn->bhpn", base, self.mapper_matrix)
        if self.kind == "refine":
            # negative indices (tokens with no source) wrap, as jnp.take's
            # do; their alpha is 0
            perm = base[:, :, self.mapper_idx].movedim(2, 0)
            return perm * self.alphas + edits * (1 - self.alphas)
        if self.kind == "reweight":
            if self.inner is not None:
                b = self.inner.replace_cross(base, edits)
                return b * self.equalizer[:, None, None, :]
            return base[None] * self.equalizer[:, None, None, :]
        raise ValueError(self.kind)

    def editor(self, step: int):
        """``(probs [B, h, N, M], is_cross, place) -> probs`` at ``step``.
        A layer the editor leaves as it is (a self layer above
        ``self_edit_max_res`` tokens, or outside the self-replace steps)
        gets its input back, where the JAX package concatenates the same
        values into a copy."""

        def edit(probs, is_cross, place):
            del place
            if (self.store is not None and is_cross
                    and probs.shape[2] == self.store_res):
                self.store.append(probs)
            if not is_cross and not (
                    probs.shape[2] <= self.self_edit_max_res
                    and self.self_replace_lo <= step < self.self_replace_hi):
                return probs
            if self.cfg_doubled:
                uncond, cond = probs.chunk(2, dim=0)
            else:
                uncond, cond = None, probs
            base, edits = cond[:1], cond[1:]
            if is_cross:
                alpha = self.cross_replace_alpha[step]
                new = self.replace_cross(base[0], edits)
                edits = new * alpha + (1 - alpha) * edits
            else:
                edits = base.expand_as(edits)
            cond = torch.cat([base, edits], dim=0)
            return cond if uncond is None else torch.cat([uncond, cond])

        return edit


def make_controller(
        prompts: Sequence[str], tokenizer, num_steps: int,
        kind: str = "refine",
        cross_replace_steps: Union[float, Dict[str, Any]] = 0.8,
        self_replace_steps: Union[float, Tuple[float, float]] = 0.4,
        equalizer: Optional[np.ndarray] = None,
        inner: Optional[EditController] = None,
        cfg_doubled: bool = True) -> EditController:
    """The controller of ``kind`` for ``prompts`` (base first) over
    ``num_steps`` sampling steps; ``equalizer`` ``[P-1, 77]`` for
    reweight, ``inner`` a controller whose edit reweight scales."""
    alpha = get_time_words_attention_alpha(prompts, num_steps,
                                           cross_replace_steps, tokenizer)
    if isinstance(self_replace_steps, (int, float)):
        self_replace_steps = (0.0, float(self_replace_steps))
    ctl = EditController(
        kind=kind, num_steps=num_steps, batch_size=len(prompts),
        cross_replace_alpha=torch.from_numpy(alpha),
        self_replace_lo=int(num_steps * self_replace_steps[0]),
        self_replace_hi=int(num_steps * self_replace_steps[1]),
        inner=inner, cfg_doubled=cfg_doubled)
    if kind == "replace":
        ctl.mapper_matrix = torch.from_numpy(
            seq_aligner.get_replacement_mapper(prompts, tokenizer))
    elif kind == "refine":
        m, a = seq_aligner.get_refinement_mapper(prompts, tokenizer)
        ctl.mapper_idx = torch.from_numpy(m)
        ctl.alphas = torch.from_numpy(a).reshape(len(prompts) - 1, 1, 1, -1)
    elif kind == "reweight":
        if equalizer is None:
            raise ValueError("a reweight controller needs an equalizer")
        ctl.equalizer = torch.as_tensor(np.asarray(equalizer, np.float32))
    else:
        raise ValueError(kind)
    return ctl


@dataclasses.dataclass
class LocalBlend:
    """Blend the edited latents toward the base only where the selected
    words attend (``ptp_utils.py:437-471``)."""

    alpha_layers: torch.Tensor     # [P, 1, 1, 1, 1, 77] word-select mask
    threshold: float = 0.3

    @staticmethod
    def create(prompts: Sequence[str], words: Sequence, tokenizer,
               max_len: int = 77, threshold: float = 0.3) -> "LocalBlend":
        """``words[i]``: the word (or words) of ``prompts[i]`` to blend."""
        alpha = np.zeros((len(prompts), 1, 1, 1, 1, max_len), np.float32)
        for i, (prompt, ws) in enumerate(zip(prompts, words)):
            if isinstance(ws, str):
                ws = [ws]
            for w in ws:
                inds = seq_aligner.get_word_inds(prompt, w, tokenizer)
                alpha[i, ..., inds] = 1.0
        return LocalBlend(torch.from_numpy(alpha), threshold)

    def to(self, device) -> "LocalBlend":
        return _moved(self, device)

    def mask(self, shape, maps: Sequence[torch.Tensor]) -> torch.Tensor:
        """The blend weights ``[P, 1, H, W]`` for latents of ``shape`` from
        cross probabilities ``[P (or 2P), h, 256, 77]``, before the
        threshold, normalised to a maximum of 1 per item."""
        P, res = shape[0], 16
        stack = []
        for m in maps:
            if m.shape[0] == 2 * P:          # drop the uncond half
                m = m[P:]
            stack.append(m.reshape(P, -1, 1, res, res, m.shape[-1]))
        mm = torch.cat(stack, dim=1).float()
        mm = (mm * self.alpha_layers).sum(-1).mean(1)       # [P, 1, 16, 16]
        # half-pixel centres, as jax.image.resize's "nearest"
        mask = F.interpolate(mm, size=tuple(shape[2:]), mode="nearest-exact")
        return mask / (mask.amax(dim=(1, 2, 3), keepdim=True) + 1e-8)

    def __call__(self, x_t: torch.Tensor, maps: Sequence[torch.Tensor]
                 ) -> torch.Tensor:
        """x_t ``[P, C, H, W]``: item 0 where the mask is at most the
        threshold, x_t elsewhere."""
        mask = (self.mask(x_t.shape, maps) > self.threshold).to(x_t.dtype)
        return x_t[:1] + mask * (x_t - x_t[:1])
