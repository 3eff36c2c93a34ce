"""The text -> segmentation map -> image chain in plain PyTorch float32.

What ``ChainEngine.generate`` computes for one slot, written out again from
the FG-DM chain's published recipe (run_inference.sh, the CompVis DDIM
sampler, ControlNet's ``cldm``): the four CLIP contexts, factor 1 (UNet with
the adapter, DDIM with classifier-free guidance at 7.5) on a 32^2 latent,
the VAE decode to the 256^2 map, the uint8 round trip and bilinear resize
to the 512^2 hint, factor 2 (ControlNet + UNet, DDIM with guidance at 9.0)
on a 64^2 latent and the final decode.  The per-slot noise is worked out
from the slot seed as the engine's contract states it (numpy
``SeedSequence`` of (seed, factor) and then (seed, tag), each seeding a
``torch.Generator`` on the device).  The tokenizer is the hash fallback of
CLIP's byte-level pre-tokenizer.

This file imports nothing of the program.
"""

from __future__ import annotations

import html
import re
import zlib
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["A_PROMPT", "N_PROMPT", "tokenize", "ddpm_alphas_cumprod",
           "ddim_table", "derive_seed", "slot_noise", "Chain"]

A_PROMPT = "best quality, extremely detailed"
N_PROMPT = ("longbody, lowres, bad anatomy, bad hands, missing fingers, "
            "extra digit, fewer digits, cropped, worst quality, low quality")

BOT, EOT = 49406, 49407
# CLIP's pre-tokenization, with ``\p{L}`` as ``[^\W\d_]`` and ``\p{N}`` as
# ``\d``: equal on the prompts the benchmark draws
_PAT = re.compile(r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll"""
                  r"""|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""", re.IGNORECASE)


def _byte_encoder() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTES = _byte_encoder()


def tokenize(texts: Sequence[str], max_length: int = 77) -> torch.Tensor:
    """``[B, max_length]`` ids: BOT, the crc32 hash of each pre-token into
    [1, 49000], EOT, then EOT padding."""
    out = torch.full((len(texts), max_length), EOT, dtype=torch.int64)
    for i, t in enumerate(texts):
        t = re.sub(r"\s+", " ", html.unescape(html.unescape(t)).strip())
        ids: List[int] = []
        for tok in _PAT.findall(t.lower()):
            tok = "".join(_BYTES[b] for b in tok.encode("utf-8"))
            ids.append(zlib.crc32(tok.encode("utf-8")) % 49000 + 1)
        ids = [BOT] + ids[:max_length - 2] + [EOT]
        out[i, :len(ids)] = torch.tensor(ids)
    return out


def ddpm_alphas_cumprod(timesteps=1000, linear_start=0.00085,
                        linear_end=0.012) -> np.ndarray:
    """The SD "linear" schedule (linear in sqrt(beta)), float64."""
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def ddim_table(acp: np.ndarray, steps: int):
    """``(timesteps, alphas, alphas_prev)`` of the uniform DDIM
    sub-schedule, timesteps ascending (the CompVis table, +1 offset)."""
    n = len(acp)
    ts = np.minimum(np.arange(0, n, n // steps) + 1, n - 1)
    alphas = acp[ts]
    prev = np.concatenate([[acp[0]], acp[ts[:-1]]])
    return ts, alphas, prev


def derive_seed(*parts: int) -> int:
    """The engine's 63-bit seed of a tuple of non-negative integers."""
    st = np.random.SeedSequence([int(p) for p in parts]).generate_state(
        2, np.uint32)
    return (int(st[0]) << 31 | int(st[1])) & ((1 << 63) - 1)


def slot_noise(slot_seed: int, factor: int, shape, device) -> torch.Tensor:
    """x_T of one slot for one factor: N(0, 1) of ``shape`` from a
    generator seeded by derive_seed(derive_seed(seed, factor), 0)."""
    g = torch.Generator(device=device).manual_seed(
        derive_seed(derive_seed(slot_seed, factor), 0))
    return torch.randn(tuple(shape), generator=g, device=device)


class Chain:
    """The chain over reference modules: ``clip1``, ``unet1`` (with
    adapter), ``vae1`` for factor 1; ``clip2``, ``unet2``, ``control``,
    ``vae2`` for factor 2; ``cfg`` the sampler settings."""

    def __init__(self, mods: Dict[str, torch.nn.Module], cfg: dict,
                 device):
        self.m, self.cfg, self.device = mods, cfg, device
        self.acp = ddpm_alphas_cumprod(**cfg["schedule"])
        self.scale_factor = cfg["scale_factor"]

    def _ctx(self, clip, texts):
        return clip(tokenize(texts).to(self.device))

    def _ddim(self, eps_fn, x, steps: int, scale: float, cond, uncond):
        ts, alphas, prev = ddim_table(self.acp, steps)
        for i in reversed(range(len(ts))):
            t = torch.full((x.shape[0],), int(ts[i]), device=self.device)
            e_uc, e_c = eps_fn(torch.cat([x, x]), torch.cat([t, t]),
                               torch.cat([uncond, cond])).chunk(2)
            e = e_uc + scale * (e_c - e_uc)
            a, ap = float(alphas[i]), float(prev[i])
            x0 = (x - (1 - a) ** 0.5 * e) / a ** 0.5
            x = ap ** 0.5 * x0 + (1 - ap) ** 0.5 * e
        return x

    @torch.no_grad()
    def __call__(self, prompts: Sequence[str], slot_seeds: Sequence[int]
                 ) -> Dict[str, torch.Tensor]:
        """The engine's uint8 NHWC ``images`` and ``conditions`` for these
        prompts and slot seeds, on the device."""
        m, c, dev = self.m, self.cfg, self.device
        b = len(prompts)
        p_ctx = self._ctx(m["clip1"], list(prompts))
        e_ctx = self._ctx(m["clip1"], [""] * b)
        cp_ctx = self._ctx(m["clip2"], [p + ", " + A_PROMPT for p in prompts])
        cn_ctx = self._ctx(m["clip2"], [N_PROMPT] * b)
        lh, lw = (s // 8 for s in c["cond_hw"])
        x = torch.stack([slot_noise(s, 1, (4, lh, lw), dev)
                         for s in slot_seeds])

        def eps1(x_, t_, ctx_):
            return m["unet1"](x_, t_, ctx_)

        z = self._ddim(eps1, x, c["f1_steps"], c["f1_scale"], p_ctx, e_ctx)
        cond = ((m["vae1"].decode(z / self.scale_factor) + 1) / 2).clamp(0, 1)
        hint = torch.round(cond * 255.0) / 255.0
        hint = F.interpolate(hint, size=tuple(c["image_hw"]), mode="bilinear",
                             align_corners=False)
        hint_emb = m["control"].encode_hint(hint)
        ih, iw = (s // 8 for s in c["image_hw"])
        x = torch.stack([slot_noise(s, 2, (4, ih, iw), dev)
                         for s in slot_seeds])
        he2 = torch.cat([hint_emb, hint_emb])

        def eps2(x_, t_, ctx_):
            ctrl = m["control"](x_, he2, t_, ctx_)
            return m["unet2"](x_, t_, ctx_, control=ctrl)

        z = self._ddim(eps2, x, c["f2_steps"], c["f2_scale"], cp_ctx, cn_ctx)
        img = m["vae2"].decode(z / self.scale_factor)
        img = (((img + 1) / 2).clamp(0, 1) * 255).to(torch.uint8)
        cond = (cond.clamp(0, 1) * 255).to(torch.uint8)
        return {"images": img.permute(0, 2, 3, 1),
                "conditions": cond.permute(0, 2, 3, 1)}
