"""Frechet distance and activation statistics, the core of FID; a copy of
rcot_tpu/metrics/frechet.py (reference: fid_score.py:158-252, vendored
pytorch-fid):

- d^2 = ||mu1 - mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)), scipy sqrtm of the
  covariance product, retried with an eps jitter on the diagonals when the
  product is near-singular (fid_score.py:194-200), and the imaginary-part
  check (:203-207). sqrtm is called without its `disp` argument, which
  SciPy 1.18 removes; its result is the same either way;
- statistics: mean and covariance (rowvar=False) over the features.

The features come from metrics/inception.py on the device; the O(dims^3)
sqrtm stays on the host. A stats .npz written by either package reads in
the other.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
from scipy import linalg


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    mu1 = np.atleast_1d(np.asarray(mu1, np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError("statistics shape mismatch")

    diff = mu1 - mu2
    with warnings.catch_warnings():  # a singular product is retried below
        warnings.simplefilter("ignore", linalg.LinAlgWarning)
        covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        # near-singular product: jitter the diagonals and retry
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def activation_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mu, sigma) with sample covariance (rowvar=False)."""
    feats = np.asarray(feats, np.float64)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def save_stats(path: str, mu: np.ndarray, sigma: np.ndarray) -> None:
    np.savez_compressed(path, mu=mu, sigma=sigma)


def load_stats(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with np.load(path) as z:
        return z["mu"], z["sigma"]
