"""Image helpers of ``fgdm_tpu/train/metrics.py:47-66``: ``to_uint8`` and
``make_grid`` (the inference CLI's ``--n_rows`` grids).  The training
metrics and loggers of that module are not ported (ROADMAP Queue A item 13).
"""

from __future__ import annotations

import numpy as np

__all__ = ["to_uint8", "make_grid"]


def to_uint8(img) -> np.ndarray:
    """[-1, 1] float -> uint8."""
    return (np.clip((np.asarray(img) + 1.0) / 2.0, 0, 1) * 255).astype(
        np.uint8)


def make_grid(images: np.ndarray, nrow: int = 4, pad: int = 2) -> np.ndarray:
    """``[N, H, W, C]`` uint8 -> one grid image, ``nrow`` images a row on a
    white ground."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    rows = (n + nrow - 1) // nrow
    grid = np.full((rows * (h + pad) + pad, nrow * (w + pad) + pad, c), 255,
                   np.uint8)
    for i, img in enumerate(images):
        r, col = divmod(i, nrow)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y:y + h, x:x + w] = img
    return grid
