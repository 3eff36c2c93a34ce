"""Label <-> colour codecs for semantic maps, host numpy.

Counterpart of ``fgdm_tpu/data/colorize.py`` (reference
``ldm/data/semantic.py:20-83``, ``BatchColorize``/``BatchDeColorize`` and the
bit-pattern ``color_map``; the ADE palette of ``color_mapping.py:176-177``).
Both directions are table lookups over the pixels: ``colorize`` indexes the
palette, ``decolorize`` searches the palette packed into 24-bit integers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from fgdm_tpu_torch.data.label_tables import ADE_PALETTE, COCO_TO_ADE

__all__ = ["color_map", "ade_cmap", "colorize", "decolorize",
           "coco_to_ade_labels", "nearest_palette_decolorize"]


def color_map(n: int = 256) -> np.ndarray:
    """PASCAL-style bit-pattern palette, ``[n, 3]`` uint8."""
    c = np.arange(n, dtype=np.uint32)
    r = np.zeros(n, np.uint32)
    g = np.zeros(n, np.uint32)
    b = np.zeros(n, np.uint32)
    for j in range(8):
        r |= ((c >> 0) & 1) << (7 - j)
        g |= ((c >> 1) & 1) << (7 - j)
        b |= ((c >> 2) & 1) << (7 - j)
        c = c >> 3
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def ade_cmap() -> np.ndarray:
    return np.asarray(ADE_PALETTE, dtype=np.uint8)


def colorize(labels: np.ndarray, cmap: Optional[np.ndarray] = None,
             void_label: int = 255) -> np.ndarray:
    """``[..., H, W]`` int labels -> ``[..., H, W, 3]`` uint8; void is
    white, labels past the palette take its last colour."""
    labels = np.asarray(labels)
    if cmap is None:
        cmap = color_map(max(int(labels.max()) + 1, 1))
    rgb = cmap[np.clip(labels, 0, len(cmap) - 1)]
    return np.where((labels == void_label)[..., None], np.uint8(255), rgb)


def _pack(rgb: np.ndarray) -> np.ndarray:
    rgb = rgb.astype(np.uint32)
    return (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]


def decolorize(rgb: np.ndarray, cmap: Optional[np.ndarray] = None,
               n: int = 256, void_label: int = 255) -> np.ndarray:
    """``[..., H, W, 3]`` uint8 -> ``[..., H, W]`` int32 labels by exact
    palette match; any other colour is void (as ``BatchDeColorize``)."""
    if cmap is None:
        cmap = color_map(n)
    packed_palette = _pack(cmap)
    order = np.argsort(packed_palette)
    sorted_pal = packed_palette[order]
    packed = _pack(np.asarray(rgb))
    idx = np.clip(np.searchsorted(sorted_pal, packed), 0, len(sorted_pal) - 1)
    labels = np.where(sorted_pal[idx] == packed, order[idx], void_label)
    return labels.astype(np.int32)


def coco_to_ade_labels(labels: np.ndarray, void_label: int = 255
                       ) -> np.ndarray:
    """COCO-stuff class ids -> ADE20K ids by the reference's table."""
    lut = np.full(256, void_label, dtype=np.int32)
    for k, v in COCO_TO_ADE.items():
        if 0 <= k < 256:
            lut[k] = v
    return lut[np.clip(np.asarray(labels), 0, 255)]


def nearest_palette_decolorize(rgb: np.ndarray, cmap: np.ndarray
                               ) -> np.ndarray:
    """Labels of the nearest palette colour (L1), for generated maps whose
    colours no longer match the palette exactly."""
    rgb = np.asarray(rgb)
    flat = rgb.reshape(-1, 3).astype(np.int32)
    d = np.abs(flat[:, None, :] - cmap.astype(np.int32)[None]).sum(-1)
    return d.argmin(1).astype(np.int32).reshape(rgb.shape[:-1])
