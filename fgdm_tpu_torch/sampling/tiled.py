"""Tiled (patch-split) inference for inputs larger than a model's size.

Counterpart of ``fgdm_tpu/sampling/tiled.py:27-123`` (the reference's
``split_input_params`` fold/unfold with border-weighted stitching,
``ddpm.py:697-763,841-989``): the input is cut into overlapping square
tiles, all tiles go through the model as one batch, and the outputs are
blended back by a separable window that falls off toward the tile's border.
NCHW throughout.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

__all__ = ["tiled_apply", "tiled_decode", "tiled_encode"]


def _tile_starts(size: int, tile: int, stride: int) -> List[int]:
    """Tile offsets every ``stride``, plus one flush with the far edge."""
    starts = list(range(0, max(size - tile, 0) + 1, stride))
    if starts[-1] != size - tile:
        starts.append(size - tile)
    return starts


def _smooth_window(tile: int, clip_min: float = 0.01) -> np.ndarray:
    """The float64 1-D window ``exp(-8 u^2)``, u the offset from the centre
    over the tile, clipped below at ``clip_min`` (the reference's
    ``get_weighting``, ``ddpm.py:697-712``)."""
    x = (np.arange(tile) - (tile - 1) / 2) / tile
    return np.clip(np.exp(-8.0 * x * x), clip_min, None)


def tiled_apply(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                tile: int, stride: int, out_scale=1) -> torch.Tensor:
    """``fn`` (``[B, Cin, tile, tile] -> [B, Cout, tile*s, tile*s]``) over
    the overlapping tiles of x ``[B, Cin, H, W]``, blended.

    The tiles go through ``fn`` in one batch (tile-major, batch-minor); the
    blend accumulates in float32 and casts to ``fn``'s dtype at the end.
    The scale s is read from the output's shape; ``out_scale``, unless 1,
    must equal it."""
    b, _, h, w = x.shape
    ys = _tile_starts(h, tile, stride)
    xs = _tile_starts(w, tile, stride)
    outs = fn(torch.cat([x[:, :, y0:y0 + tile, x0:x0 + tile]
                         for y0 in ys for x0 in xs]))
    ot = outs.shape[-1]
    s = ot / tile
    if not (abs(s - out_scale) < 1e-6 or out_scale == 1):
        raise ValueError(f"fn scales {tile} to {ot}, not by {out_scale}")
    win1d = _smooth_window(ot)
    win = torch.as_tensor(np.outer(win1d, win1d), dtype=torch.float32,
                          device=outs.device)[None, None]
    acc = torch.zeros(b, outs.shape[1], int(round(h * s)), int(round(w * s)),
                      dtype=torch.float32, device=outs.device)
    norm = torch.zeros(b, 1, acc.shape[2], acc.shape[3], dtype=torch.float32,
                       device=outs.device)
    idx = 0
    for y0 in ys:
        for x0 in xs:
            oy, ox = int(round(y0 * s)), int(round(x0 * s))
            acc[:, :, oy:oy + ot, ox:ox + ot] += (
                outs[idx * b:(idx + 1) * b].float() * win)
            norm[:, :, oy:oy + ot, ox:ox + ot] += win
            idx += 1
    return (acc / norm).to(outs.dtype)


@torch.inference_mode()
def tiled_decode(ld, z: torch.Tensor, tile: int = 64,
                 overlap: int = 16) -> torch.Tensor:
    """VAE-decode latents ``[B, 4, h, w]`` tile by tile (x8 upscale)."""
    return tiled_apply(ld.decode_first_stage, z, tile, tile - overlap,
                       out_scale=8)


@torch.inference_mode()
def tiled_encode(ld, img: torch.Tensor, tile: int = 512,
                 overlap: int = 128) -> torch.Tensor:
    """VAE-encode images ``[B, 3, H, W]`` tile by tile (the posterior
    mode; the 1/8 scale is read from the encoder's output)."""
    return tiled_apply(ld.encode_first_stage, img, tile, tile - overlap)
