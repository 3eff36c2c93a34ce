"""Depth- and normal-adherence metrics, on the host.

Counterpart of ``fgdm_tpu/utils/depth_metrics.py``.  The depth factor emits
relative inverse depth (MiDaS convention, min-max normalized per image), so
the depth re-estimated from a generated image is scored against the
requested map after a per-image least-squares scale and shift (MiDaS's SSI
alignment, Ranftl et al., arXiv:1907.01341 section 3): ``depth_rmse_ssi``
and ``depth_mae_ssi``.  Normal maps are scored by the angle between unit
vectors.  Numpy, the same arithmetic as JAX's copy.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["scale_shift_align", "depth_adherence", "normal_angular_error"]


def scale_shift_align(pred: np.ndarray, gt: np.ndarray,
                      mask: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-image least-squares (a, b) with ``a * pred + b ~ gt`` ->
    (aligned pred, a, b).  Shapes [B, H, W]; ``mask`` selects the pixels
    the fit uses (default all)."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.shape != gt.shape:
        raise ValueError(f"pred {pred.shape} vs gt {gt.shape}")
    b = pred.shape[0]
    p = pred.reshape(b, -1)
    g = gt.reshape(b, -1)
    m = np.ones_like(p) if mask is None else \
        np.asarray(mask, np.float64).reshape(b, -1)
    n = m.sum(1)
    if (n < 2).any():
        raise ValueError("scale_shift_align needs ≥2 valid pixels per image")
    sp, sg = (m * p).sum(1), (m * g).sum(1)
    spp, spg = (m * p * p).sum(1), (m * p * g).sum(1)
    det = n * spp - sp * sp
    # a constant prediction: shift-only alignment (a = 0)
    safe = np.abs(det) > 1e-12 * np.maximum(n * spp, 1e-30)
    a = np.where(safe, (n * spg - sp * sg) / np.where(safe, det, 1.0), 0.0)
    b_ = (sg - a * sp) / n
    aligned = a[:, None] * p + b_[:, None]
    return aligned.reshape(pred.shape), a, b_


def depth_adherence(pred: np.ndarray, gt: np.ndarray,
                    mask: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Scale-shift-invariant RMSE / MAE between predicted and requested
    relative depth ([B, H, W], any consistent normalization)."""
    aligned, _, _ = scale_shift_align(pred, gt, mask)
    err = aligned - np.asarray(gt, np.float64)
    if mask is not None:
        err = err[np.asarray(mask, bool)]
    return {
        "depth_rmse_ssi": float(np.sqrt(np.mean(err ** 2))),
        "depth_mae_ssi": float(np.mean(np.abs(err))),
    }


def normal_angular_error(pred: np.ndarray, gt: np.ndarray
                         ) -> Dict[str, float]:
    """Mean / median angular error (degrees) between normal maps
    ([B, H, W, 3], any consistent scale: vectors are re-normalized)."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.shape != gt.shape:
        raise ValueError(f"pred {pred.shape} vs gt {gt.shape}")

    def unit(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True),
                              1e-12)

    cos = np.clip((unit(pred) * unit(gt)).sum(-1), -1.0, 1.0)
    ang = np.degrees(np.arccos(cos))
    return {
        "normal_mean_angle_deg": float(ang.mean()),
        "normal_median_angle_deg": float(np.median(ang)),
    }
