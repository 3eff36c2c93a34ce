"""Batched serving engine for the FG-DM chain.

Counterpart of ``fgdm_tpu/serving.py``: one engine owns the two pipelines and
runs every request batch at a fixed geometry: prompts are padded to
``max_batch``, so the kernels see the same shapes whatever the request mix.
PyTorch runs eagerly, so nothing compiles; the warmup still runs one full
``generate()`` (tokenize, CLIP, the chain, uint8 postprocess, transfer to the
host), so the first request does not pay for kernel builds, and
``compile_seconds`` is its wall time.

``staged`` is kept for signature parity with the JAX engine, where it splits
the chain into four separately compiled stage functions.  Eager PyTorch has
no compile to split, so both settings run the same ``fgdm_chain`` calls.

RNG contract: each slot's noise comes from its own seed, so a (prompt,
seed) pair gives the same image solo or coalesced into any slot of any
batch.  ``slot_seeds_from_seeds`` accepts every seed ``jax.random.PRNGKey``
accepts, [-2**63, 2**63), and maps it to a non-negative slot seed.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from fgdm_tpu_torch.diffusion.control import ControlLDM
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion
from fgdm_tpu_torch.models.clip import CLIPTokenizer
from fgdm_tpu_torch.sampling.chain import A_PROMPT, N_PROMPT, fgdm_chain

__all__ = ["slot_seeds_from_seeds", "ChainEngine"]


def slot_seeds_from_seeds(seeds: Sequence[int]) -> list:
    """Per-slot seeds from request seeds: each int in [-2**63, 2**63) (the
    range of ``serving.py:65-68``), taken mod 2**64."""
    out = []
    for s in seeds:
        s = int(s)
        if not -2 ** 63 <= s < 2 ** 63:
            raise ValueError(f"seed {s} is outside [-2**63, 2**63)")
        out.append(s % 2 ** 64)
    return out


class ChainEngine:
    def __init__(self, ld: LatentDiffusion, cldm: ControlLDM,
                 tokenizer: Optional[CLIPTokenizer] = None,
                 max_batch: int = 4, cond_hw=(256, 256), image_hw=(512, 512),
                 f1_steps: int = 50, f2_steps: int = 20,
                 f1_scale: float = 7.5, f2_scale: float = 9.0,
                 f1_sampler: str = "ddim", f2_sampler: str = "ddim",
                 warmup: bool = True, mesh=None, staged: bool = False):
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving is not ported yet (ROADMAP Queue A item 15)")
        self.ld, self.cldm = ld, cldm
        self.tok = tokenizer or CLIPTokenizer()
        self.max_batch = max_batch
        self.cond_hw, self.image_hw = tuple(cond_hw), tuple(image_hw)
        self.staged = staged
        self.device = next(ld.unet.parameters()).device
        self._cfg = dict(f1_steps=f1_steps, f2_steps=f2_steps,
                         f1_scale=f1_scale, f2_scale=f2_scale,
                         f1_sampler=f1_sampler, f2_sampler=f2_sampler)
        self.compile_seconds = None
        if warmup:
            t0 = time.perf_counter()
            self.generate(["warmup"])
            self.compile_seconds = time.perf_counter() - t0

    def _contexts(self, prompts: Sequence[str]):
        """The four CLIP contexts of ``serving.py:202-210``, padded."""
        b = self.max_batch
        padded = list(prompts) + [""] * (b - len(prompts))

        def embed(pipe, texts):
            return pipe.get_learned_conditioning(
                self.tok(texts).to(self.device))

        return (embed(self.ld, padded), embed(self.ld, [""] * b),
                embed(self.cldm, [p + ", " + A_PROMPT for p in padded]),
                embed(self.cldm, [N_PROMPT] * b))

    def _run(self, slot_seeds, p_ctx, e_ctx, cnp_ctx, cnn_ctx):
        return fgdm_chain(self.ld, self.cldm, p_ctx, e_ctx, cnp_ctx, cnn_ctx,
                          cond_hw=self.cond_hw, image_hw=self.image_hw,
                          slot_seeds=slot_seeds, **self._cfg)

    def generate(self, prompts: Sequence[str], seed: int = 0,
                 seeds: Optional[Sequence[int]] = None
                 ) -> Dict[str, np.ndarray]:
        """1..max_batch prompts -> uint8 NHWC ``images`` and ``conditions``.

        Slot b's noise depends only on its seed (``seeds[b]``, or the shared
        ``seed``).  Runs under ``torch.inference_mode`` itself: a batcher
        calls it from its own thread, and the mode is thread-local."""
        n = len(prompts)
        if n == 0 or n > self.max_batch:
            raise ValueError(
                f"got {n} prompts; engine built for 1..{self.max_batch}")
        if seeds is None:
            seeds = [seed] * n
        elif len(seeds) != n:
            raise ValueError(f"{len(seeds)} seeds for {n} prompts")
        slots = slot_seeds_from_seeds(list(seeds)
                                      + [0] * (self.max_batch - n))
        with torch.inference_mode():
            out = self._run(slots, *self._contexts(prompts))
            img = ((out["image"] + 1.0) / 2.0).clamp(0.0, 1.0) * 255
            cond = out["condition"].clamp(0.0, 1.0) * 255
            imgs, conds = (a[:n].to(torch.uint8).permute(0, 2, 3, 1).cpu()
                           for a in (img, cond))
        return {"images": imgs.numpy(), "conditions": conds.numpy()}
