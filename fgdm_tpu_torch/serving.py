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

``mesh`` (``parallel/mesh.create_mesh``) serves data-parallel, as
``serving.py:139-176`` does: ``max_batch`` divides over the ``data`` dim,
each rank runs the chain on its rows of the padded batch (their slot
seeds), and the images are all-gathered, so every rank returns the whole
batch.  By the slot contract below the outputs are the single-device
engine's for the same seeds.  JAX refuses multi-host serving; the port
refuses a group whose ranks sit on more than one host, in the same words.
Every rank calls ``generate`` with the same arguments.

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
from fgdm_tpu_torch.utils.profiling import span

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
        self.mesh = mesh
        self._rows = slice(0, max_batch)
        if mesh is not None:
            from fgdm_tpu_torch.parallel.mesh import replicate

            self._rows = self._mesh_rows(mesh, max_batch)
            # every rank serves the same weights (JAX's replicate)
            parts = (ld.unet, ld.vae, ld.clip, cldm.unet, cldm.vae,
                     cldm.clip, cldm.control)
            for m in {id(m): m for m in parts if m is not None}.values():
                replicate(mesh, m)
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

    @staticmethod
    def _mesh_rows(mesh, max_batch: int) -> slice:
        """This rank's rows of the padded batch; the checks of
        ``serving.py:142-152``."""
        import socket

        import torch.distributed as dist

        from fgdm_tpu_torch.parallel.mesh import data_rank, data_size

        n_data = data_size(mesh)
        if max_batch % n_data:
            raise ValueError(
                f"max_batch={max_batch} must divide over the "
                f"data axis ({n_data} devices)")
        hosts = [None] * dist.get_world_size()
        dist.all_gather_object(hosts, socket.gethostname())
        if len(set(hosts)) > 1:
            raise NotImplementedError(
                "multi-host serving is deliberately unsupported: run "
                "one engine per host behind a balancer (serving is "
                "embarrassingly parallel; a cross-host mesh would add "
                "DCN hops to every request for nothing)")
        k = max_batch // n_data
        return slice(data_rank(mesh) * k, (data_rank(mesh) + 1) * k)

    def _contexts(self, prompts: Sequence[str]):
        """The four CLIP contexts of ``serving.py:202-210``, padded (this
        rank's rows of them on a mesh)."""
        b = self.max_batch
        padded = (list(prompts) + [""] * (b - len(prompts)))[self._rows]
        b = len(padded)

        def embed(pipe, texts):
            return pipe.get_learned_conditioning(
                self.tok(texts).to(self.device))

        with span("engine.contexts"):
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
        with torch.inference_mode(), span("engine.generate"):
            out = self._run(slots[self._rows], *self._contexts(prompts))
            with span("engine.to_host"):
                img = ((out["image"] + 1.0) / 2.0).clamp(0.0, 1.0) * 255
                cond = out["condition"].clamp(0.0, 1.0) * 255
                img, cond = (a.to(torch.uint8) for a in (img, cond))
                if self.mesh is not None:
                    from fgdm_tpu_torch.parallel.mesh import (
                        all_gather_rows, data_group)

                    img, cond = (all_gather_rows(a, data_group(self.mesh))
                                 for a in (img, cond))
                imgs, conds = (a[:n].permute(0, 2, 3, 1).cpu().numpy()
                               for a in (img, cond))
        return {"images": imgs, "conditions": conds}
