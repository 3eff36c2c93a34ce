"""Bounding-box utilities (vectorized numpy).

Counterpart of ``fgdm_tpu/utils/bbox.py`` (the reference's
``ldm/data/bbox.py``): pairwise IoU, xywh <-> xyxy conversion, clipping and
the center-scale transform of pose crops.  The same arithmetic as JAX's
copy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["bbox_iou", "bbox_xywh_to_xyxy", "bbox_xyxy_to_xywh",
           "bbox_clip_xyxy", "box_to_center_scale", "center_scale_to_box"]


def bbox_iou(bbox_a: np.ndarray, bbox_b: np.ndarray, offset: int = 0
             ) -> np.ndarray:
    """Pairwise IoU: [N, 4] x [M, 4] xyxy -> [N, M]."""
    a = np.asarray(bbox_a, np.float32)
    b = np.asarray(bbox_b, np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(br - tl + offset, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(a[:, 2:4] - a[:, :2] + offset, axis=1)
    area_b = np.prod(b[:, 2:4] - b[:, :2] + offset, axis=1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-12)


def _rows(x) -> Tuple[np.ndarray, bool]:
    x = np.asarray(x, np.float32)
    return (x[None], True) if x.ndim == 1 else (x, False)


def bbox_xywh_to_xyxy(xywh) -> np.ndarray:
    xywh, single = _rows(xywh)
    xyxy = np.concatenate(
        [xywh[:, :2], xywh[:, :2] + np.clip(xywh[:, 2:4] - 1, 0, None)],
        axis=1)
    return xyxy[0] if single else xyxy


def bbox_xyxy_to_xywh(xyxy) -> np.ndarray:
    xyxy, single = _rows(xyxy)
    xywh = np.concatenate([xyxy[:, :2], xyxy[:, 2:4] - xyxy[:, :2] + 1],
                          axis=1)
    return xywh[0] if single else xywh


def bbox_clip_xyxy(xyxy, width: int, height: int) -> np.ndarray:
    xyxy, single = _rows(xyxy)
    out = np.stack([
        np.clip(xyxy[:, 0], 0, width - 1),
        np.clip(xyxy[:, 1], 0, height - 1),
        np.clip(xyxy[:, 2], 0, width - 1),
        np.clip(xyxy[:, 3], 0, height - 1),
    ], axis=1)
    return out[0] if single else out


def box_to_center_scale(x: float, y: float, w: float, h: float,
                        aspect_ratio: float = 1.0, scale_mult: float = 1.25
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Pose-crop convention: box -> (center, scale) with aspect pinning."""
    center = np.array([x + w * 0.5, y + h * 0.5], np.float32)
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w, h], np.float32)
    if center[0] != -1:
        scale = scale * scale_mult
    return center, scale


def center_scale_to_box(center: np.ndarray, scale: np.ndarray) -> np.ndarray:
    w, h = scale[0], scale[1]
    return np.array([
        center[0] - w * 0.5, center[1] - h * 0.5,
        center[0] - w * 0.5 + w, center[1] - h * 0.5 + h,
    ], np.float32)
