"""Canny edge annotator.

Counterpart of ``fgdm_tpu/annotators/canny.py``:

* ``CannyDetector``: ``cv2.Canny(img, low, high)`` (aperture 3, L1
  gradient, as at ``canny.py:22``) rebuilt in numpy and scipy, pixel for
  pixel: Sobel x and y with ``BORDER_REPLICATE``; ``|dx| + |dy|``, and on a
  multi-channel image, per pixel, the channel with the largest of it (the
  first on a tie) and its dx, dy; thresholds floored to ints (swapped if
  low > high); non-max suppression with the fixed-point ``TG22`` test
  (``CANNY_SHIFT = 15``), ``>`` on one side and ``>=`` on the other,
  magnitude outside the image 0; a pixel above ``low`` that survives is
  strong above ``high``, else weak; hysteresis keeps the weak pixels
  8-connected to a strong one.
* ``sobel_edges``: the in-graph approximation on the device: the channel
  mean, a zero-padded "SAME" Sobel, the magnitude normalised by each
  sample's max (+ 1e-8), thresholded.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["CannyDetector", "sobel_edges"]

_CANNY_SHIFT = 15
_TG22 = int(0.4142135623730950488016887242097 * (1 << _CANNY_SHIFT) + 0.5)


def _sobel(img: np.ndarray):
    """Sobel dx, dy (aperture 3, ``BORDER_REPLICATE``) of ``[H, W, C]``."""
    p = np.pad(img.astype(np.int32), ((1, 1), (1, 1), (0, 0)), mode="edge")
    h, w = img.shape[:2]

    def at(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    dx = (at(-1, 1) - at(-1, -1) + 2 * (at(0, 1) - at(0, -1))
          + at(1, 1) - at(1, -1))
    dy = (at(1, -1) - at(-1, -1) + 2 * (at(1, 0) - at(-1, 0))
          + at(1, 1) - at(-1, 1))
    return dx, dy


class CannyDetector:
    """Host-side exact Canny: uint8 ``[H, W]`` or ``[H, W, C]`` -> uint8
    ``[H, W]`` edges (255) on 0."""

    def __call__(self, img: np.ndarray, low_threshold: int = 100,
                 high_threshold: int = 200) -> np.ndarray:
        from scipy.ndimage import label

        img = np.asarray(img)
        if img.dtype != np.uint8:
            raise ValueError(f"Canny takes uint8, got {img.dtype}")
        if img.ndim == 2:
            img = img[..., None]
        low, high = sorted((low_threshold, high_threshold))
        low, high = math.floor(low), math.floor(high)
        dx, dy = _sobel(img)
        mag = np.abs(dx) + np.abs(dy)
        pick = np.argmax(mag, axis=-1)[..., None]
        mag, dx, dy = (np.take_along_axis(a, pick, axis=-1)[..., 0]
                       for a in (mag, dx, dy))
        h, w = mag.shape
        pm = np.pad(mag, 1)

        def nb(oy, ox):
            return pm[1 + oy:1 + oy + h, 1 + ox:1 + ox + w]

        x = np.abs(dx).astype(np.int64)
        y = np.abs(dy).astype(np.int64) << _CANNY_SHIFT
        tg22x = x * _TG22
        tg67x = tg22x + (x << (_CANNY_SHIFT + 1))
        horiz = y < tg22x
        vert = ~horiz & (y > tg67x)
        # the diagonal: s = -1 where dx and dy have opposite signs
        anti = (dx ^ dy) < 0
        keep = np.where(
            horiz, (mag > nb(0, -1)) & (mag >= nb(0, 1)),
            np.where(vert, (mag > nb(-1, 0)) & (mag >= nb(1, 0)),
                     np.where(anti, (mag > nb(-1, 1)) & (mag > nb(1, -1)),
                              (mag > nb(-1, -1)) & (mag > nb(1, 1)))))
        cand = (mag > low) & keep
        strong = cand & (mag > high)
        comp, _ = label(cand, structure=np.ones((3, 3), int))
        hit = np.unique(comp[strong])
        return np.where(np.isin(comp, hit[hit > 0]), 255, 0).astype(np.uint8)


_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def sobel_edges(img: torch.Tensor, threshold: float = 0.25) -> torch.Tensor:
    """In-graph edge map: ``[B, C, H, W]`` in [-1, 1] -> ``[B, 1, H, W]``
    float32 in {0, 1}."""
    gray = img.float().mean(dim=1, keepdim=True)
    kx = torch.tensor(_SOBEL_X, device=img.device)
    k = torch.stack([kx, kx.t()])[:, None]          # [2, 1, 3, 3]
    g = F.conv2d(gray, k, padding=1)
    mag = torch.sqrt((g * g).sum(dim=1, keepdim=True))
    mag = mag / (mag.amax(dim=(1, 2, 3), keepdim=True) + 1e-8)
    return (mag > threshold).float()
