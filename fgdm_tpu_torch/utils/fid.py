"""Frechet-distance evaluation (FID, clean-fid conventions), on the host.

Counterpart of ``fgdm_tpu/utils/fid.py``: streaming feature statistics
over batches (``FeatureStats``), the Frechet distance
``|mu1 - mu2|^2 + Tr(S1 + S2 - 2 (S1 S2)^(1/2))`` with scipy's ``sqrtm``
and its usual guards (``frechet_distance``), and ``compute_fid`` over any
``[B, H, W, 3] -> [B, D]`` feature function: the CLIP tower here
(``clip_feature_fn``, CLIP-FID) or InceptionV3 pool3
(``utils/inception.inception_feature_fn``).  The statistics and the
distance are the same numpy as JAX's copy.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np

__all__ = ["FeatureStats", "frechet_distance", "compute_fid",
           "clip_feature_fn"]


class FeatureStats:
    """Streaming mean / covariance accumulator for feature batches."""

    def __init__(self, dim: int):
        self.dim = dim
        self.n = 0
        self._sum = np.zeros(dim, np.float64)
        self._outer = np.zeros((dim, dim), np.float64)

    def update(self, feats: np.ndarray):
        feats = np.asarray(feats, np.float64)
        assert feats.ndim == 2 and feats.shape[1] == self.dim
        self.n += feats.shape[0]
        self._sum += feats.sum(0)
        self._outer += feats.T @ feats

    @property
    def mean(self) -> np.ndarray:
        return self._sum / max(self.n, 1)

    @property
    def cov(self) -> np.ndarray:
        mu = self.mean
        return self._outer / max(self.n - 1, 1) - np.outer(mu, mu) * (
            self.n / max(self.n - 1, 1))


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """The FID formula: ``eps`` on the diagonals when the square root is
    not finite, the real part of a complex root.  scipy's ``sqrtm`` as JAX
    calls it (``disp=False``) where scipy still takes ``disp``."""
    import inspect

    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    if "disp" in inspect.signature(linalg.sqrtm).parameters:
        covmean, _ = linalg.sqrtm(sigma1 @ sigma2, disp=False)
    else:   # scipy >= 1.18 returns the root alone and prints nothing
        covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def compute_fid(real_batches: Iterable[np.ndarray],
                fake_batches: Iterable[np.ndarray],
                feature_fn: Callable[[np.ndarray], np.ndarray],
                dim: int) -> float:
    """Images in [0, 1] ``[B, H, W, 3]`` -> Frechet distance over
    ``feature_fn``."""
    s_real, s_fake = FeatureStats(dim), FeatureStats(dim)
    for b in real_batches:
        s_real.update(np.asarray(feature_fn(b)))
    for b in fake_batches:
        s_fake.update(np.asarray(feature_fn(b)))
    return frechet_distance(s_real.mean, s_real.cov, s_fake.mean, s_fake.cov)


def clip_feature_fn(scorer) -> Tuple[Callable, int]:
    """CLIP-FID's feature backend from a ``utils.clip_score.CLIPScorer``:
    ``[B, H, W, 3]`` in [0, 1] (numpy) -> the normalized image features
    ``[B, proj_dim]`` (numpy, float32)."""

    def fn(img01: np.ndarray) -> np.ndarray:
        return scorer.encode_image(img01).cpu().numpy()

    return fn, scorer.vision.proj_dim
