"""Segmentation-adherence metrics (mIoU), on the host.

Counterpart of ``fgdm_tpu/utils/seg_metrics.py`` (the FG-DM paper's mIoU:
re-segment the generated image, compare against the requested map), with
mmseg's IoU convention: per-class intersection over union accumulated over
the whole set, the mean over the classes that appear.  Numpy, the same
arithmetic as JAX's copy; the nearest-palette decode is the port's own
``data/colorize.nearest_palette_decolorize``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["confusion_matrix", "miou_from_confusion", "labels_from_colorized"]


def confusion_matrix(pred: np.ndarray, gt: np.ndarray, num_classes: int,
                     ignore_label: Optional[int] = None) -> np.ndarray:
    """[...,] int label arrays -> [C, C] counts (rows gt, columns pred).

    Pixels where ``gt == ignore_label`` are excluded; out-of-range labels
    raise (a silent clip would fake adherence for corrupt decodes)."""
    pred = np.asarray(pred).reshape(-1).astype(np.int64)
    gt = np.asarray(gt).reshape(-1).astype(np.int64)
    if pred.shape != gt.shape:
        raise ValueError(f"pred {pred.shape} vs gt {gt.shape}")
    if ignore_label is not None:
        keep = gt != ignore_label
        pred, gt = pred[keep], gt[keep]
    if pred.size and (pred.min() < 0 or pred.max() >= num_classes):
        raise ValueError(f"pred labels outside [0, {num_classes})")
    if gt.size and (gt.min() < 0 or gt.max() >= num_classes):
        raise ValueError(f"gt labels outside [0, {num_classes})")
    return np.bincount(
        gt * num_classes + pred, minlength=num_classes * num_classes
    ).reshape(num_classes, num_classes)


def miou_from_confusion(cm: np.ndarray) -> Tuple[float, int]:
    """[C, C] confusion -> (mean IoU over the classes with a nonzero union,
    the number of such classes)."""
    cm = np.asarray(cm, np.float64)
    inter = np.diag(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    valid = union > 0
    if not valid.any():
        return float("nan"), 0
    return float((inter[valid] / union[valid]).mean()), int(valid.sum())


def labels_from_colorized(rgb: np.ndarray, cmap: np.ndarray) -> np.ndarray:
    """Colorized segmentation image(s) -> label map(s) by the nearest
    palette colour ([..., H, W, 3] uint8, or float in [0, 1] or [0, 255]
    -> [..., H, W] int32)."""
    from fgdm_tpu_torch.data.colorize import nearest_palette_decolorize

    arr = np.asarray(rgb)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8) if arr.max() > 1.5 \
            else (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    return nearest_palette_decolorize(arr, cmap)
