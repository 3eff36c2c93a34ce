"""Sketch-adherence metric (edge F1), on the host.

Counterpart of ``fgdm_tpu/utils/edge_metrics.py``: the edges re-detected
from a generated image against the requested sketch, both thresholded, as
binary precision / recall / F1 over the batch (``sketch_f1``,
``sketch_precision``, ``sketch_recall``).  Numpy, the same arithmetic as
JAX's copy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["edge_f1"]


def edge_f1(pred: np.ndarray, gt: np.ndarray,
            threshold: float = 0.5) -> Dict[str, float]:
    """[B, H, W] edge probabilities in [0, 1] -> precision / recall / F1 of
    the thresholded edge sets over the whole batch."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.shape != gt.shape:
        raise ValueError(f"pred {pred.shape} vs gt {gt.shape}")
    p = pred >= threshold
    g = gt >= threshold
    tp = float(np.logical_and(p, g).sum())
    fp = float(np.logical_and(p, ~g).sum())
    fn = float(np.logical_and(~p, g).sum())
    prec = tp / max(tp + fp, 1.0)
    rec = tp / max(tp + fn, 1.0)
    f1 = 2 * prec * rec / max(prec + rec, 1e-12)
    return {"sketch_f1": f1, "sketch_precision": prec, "sketch_recall": rec}
