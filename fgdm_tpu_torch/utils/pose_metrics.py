"""Pose-adherence metric (tolerant skeleton F1), on the host.

Counterpart of ``fgdm_tpu/utils/pose_metrics.py``: the skeleton re-detected
from a generated image (``annotators/openpose.OpenposeDetector``) against
the requested render (``data/pose.render_skeleton``), as binary F1 over the
skeleton support with a Chebyshev tolerance of ``tol`` pixels (``pose_f1``,
``pose_precision``, ``pose_recall``).  Numpy and scipy, the same arithmetic
as JAX's copy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["skeleton_f1"]


def _support(maps: np.ndarray, threshold: float) -> np.ndarray:
    """[B, H, W, 3] in [0, 1] -> [B, H, W] bool: any-channel support."""
    maps = np.asarray(maps, np.float64)
    if maps.ndim != 4 or maps.shape[-1] != 3:
        raise ValueError(f"expected [B,H,W,3] skeleton maps, got {maps.shape}")
    return maps.max(axis=-1) > threshold


def _dilate(mask: np.ndarray, tol: int) -> np.ndarray:
    """Chebyshev-ball binary dilation of a [B, H, W] mask by ``tol`` px."""
    if tol <= 0:
        return mask
    from scipy.ndimage import maximum_filter

    k = 2 * tol + 1
    return maximum_filter(mask, size=(1, k, k), mode="constant")


def skeleton_f1(pred: np.ndarray, gt: np.ndarray, tol: int = 4,
                threshold: float = 0.1) -> Dict[str, float]:
    """Tolerant precision / recall / F1 between two batches of skeleton
    maps ([B, H, W, 3] renders in [0, 1], black background): a predicted
    skeleton pixel is correct if a ground-truth one lies within ``tol``
    (Chebyshev), and recall symmetrically."""
    p = _support(pred, threshold)
    g = _support(gt, threshold)
    if p.shape != g.shape:
        raise ValueError(f"pred {p.shape} vs gt {g.shape}")
    tp_p = float(np.logical_and(p, _dilate(g, tol)).sum())
    tp_g = float(np.logical_and(g, _dilate(p, tol)).sum())
    prec = tp_p / max(float(p.sum()), 1.0)
    rec = tp_g / max(float(g.sum()), 1.0)
    f1 = 2 * prec * rec / max(prec + rec, 1e-12)
    return {"pose_f1": f1, "pose_precision": prec, "pose_recall": rec}
