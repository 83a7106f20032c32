"""NIQE, the Natural Image Quality Evaluator (no reference), host-side numpy.

A copy of rcot_tpu/metrics/niqe.py (Mittal, Soundararajan, Bovik 2013; the
reference wraps skvideo.measure.niqe, util/val_utils.py:69-74):

1. MSCN coefficients: I' = (I - mu) / (sigma + 1), mu and sigma from a 7x7
   Gaussian (sigma 7/6) window, zero-padded like MATLAB's filter2.
2. Per-96x96-patch NSS features, 18 per scale: a GGD fit of the MSCN
   values (2) and AGGD fits of the four orientations' pairwise products
   (4 x 4); two scales, the second a MATLAB-bicubic 0.5 downsample
   (data/imresize.py), 36 features.
3. Patch selection by sharpness (> 0.75 of the sharpest) when fitting a
   pristine model; scoring keeps every patch.
4. Score = sqrt((mu_p-mu_d)^T ((cov_p+cov_d)/2)^+ (mu_p-mu_d)).

The official pristine model (niqe_image_params.mat) loads through
load_niqe_model; fit_niqe_model builds a surrogate from clean images, for
relative scores. The model files are the JAX package's format both ways.
NIQE runs on the host: 36-dim statistics per image, no device work.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence

import numpy as np
from scipy.special import gamma as _gamma

# ---------------------------------------------------------------- windows

_GAM_GRID = np.arange(0.2, 10.001, 0.001)
_R_GGD = (_gamma(1.0 / _GAM_GRID) * _gamma(3.0 / _GAM_GRID)
          / _gamma(2.0 / _GAM_GRID) ** 2)
_R_AGGD = (_gamma(2.0 / _GAM_GRID) ** 2
           / (_gamma(1.0 / _GAM_GRID) * _gamma(3.0 / _GAM_GRID)))


def _gaussian_window(n: int = 7, sigma: float = 7.0 / 6.0) -> np.ndarray:
    half = (n - 1) / 2.0
    y, x = np.mgrid[-half:half + 1, -half:half + 1]
    w = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    return (w / w.sum()).astype(np.float64)


def _filter2_same(img: np.ndarray, win: np.ndarray) -> np.ndarray:
    """MATLAB filter2(win, img, 'same'): correlation, zero-padded borders
    (what the reference NIQE uses — NOT reflective padding)."""
    from scipy.ndimage import correlate
    return correlate(img, win, mode="constant", cval=0.0)


# ---------------------------------------------------------------- GGD/AGGD

def estimate_ggd_param(vec: np.ndarray) -> tuple:
    """Moment-matching GGD fit (MATLAB estimateggdparam): returns
    (alpha, sigma) for f(x) ~ exp(-(|x|/beta)^alpha)."""
    vec = np.asarray(vec, np.float64).ravel()
    sigma_sq = float(np.mean(vec ** 2))
    sigma = math.sqrt(sigma_sq)
    e_abs = float(np.mean(np.abs(vec)))
    if e_abs == 0.0:
        return float(_GAM_GRID[-1]), 0.0
    rho = sigma_sq / (e_abs ** 2)
    alpha = float(_GAM_GRID[np.argmin((_R_GGD - rho) ** 2)])
    return alpha, sigma


def estimate_aggd_param(vec: np.ndarray) -> tuple:
    """Moment-matching AGGD fit (MATLAB estimateaggdparam): returns
    (alpha, left_std, right_std)."""
    vec = np.asarray(vec, np.float64).ravel()
    left = vec[vec < 0]
    right = vec[vec > 0]
    left_std = math.sqrt(float(np.mean(left ** 2))) if left.size else 0.0
    right_std = math.sqrt(float(np.mean(right ** 2))) if right.size else 0.0
    if left_std == 0.0 or right_std == 0.0:
        return float(_GAM_GRID[-1]), left_std, right_std
    gamma_hat = left_std / right_std
    r_hat = float(np.mean(np.abs(vec))) ** 2 / float(np.mean(vec ** 2))
    r_hat_norm = (r_hat * (gamma_hat ** 3 + 1) * (gamma_hat + 1)
                  / (gamma_hat ** 2 + 1) ** 2)
    alpha = float(_GAM_GRID[np.argmin((_R_AGGD - r_hat_norm) ** 2)])
    return alpha, left_std, right_std


# ---------------------------------------------------------------- features

_SHIFTS = ((0, 1), (1, 0), (1, 1), (1, -1))  # H, V, D1, D2


def mscn(img: np.ndarray, win: Optional[np.ndarray] = None) -> tuple:
    """MSCN coefficients + the local sigma (sharpness) field."""
    if win is None:
        win = _gaussian_window()
    img = np.asarray(img, np.float64)
    mu = _filter2_same(img, win)
    sigma = np.sqrt(np.abs(_filter2_same(img * img, win) - mu * mu))
    return (img - mu) / (sigma + 1.0), sigma


def _patch_features(patch: np.ndarray) -> np.ndarray:
    """The 18 NSS features of one MSCN patch (GGD 2 + 4 x AGGD 4)."""
    feats = []
    alpha, sigma = estimate_ggd_param(patch)
    feats += [alpha, sigma ** 2]
    for dy, dx in _SHIFTS:
        shifted = np.roll(np.roll(patch, dy, axis=0), dx, axis=1)
        alpha, lstd, rstd = estimate_aggd_param(patch * shifted)
        const = math.sqrt(_gamma(1.0 / alpha)) / math.sqrt(_gamma(3.0 / alpha))
        mean_param = ((rstd - lstd) * (_gamma(2.0 / alpha)
                                       / _gamma(1.0 / alpha)) * const)
        feats += [alpha, mean_param, lstd ** 2, rstd ** 2]
    return np.asarray(feats, np.float64)


def _to_gray(img: np.ndarray) -> np.ndarray:
    """Luminance in [0,255] from HWC RGB or HW grayscale, [0,1] or [0,255]."""
    img = np.asarray(img, np.float64)
    if img.ndim == 3:
        img = (0.299 * img[..., 0] + 0.587 * img[..., 1]
               + 0.114 * img[..., 2])
    if img.max() <= 1.0 + 1e-6:
        img = img * 255.0
    return img


def niqe_features(img: np.ndarray, patch_size: int = 96,
                  sharpness_threshold: Optional[float] = None) -> np.ndarray:
    """Per-patch 36-dim NSS feature matrix of one image (rows = patches).
    Matches the MATLAB computefeature/computequality layout: patch grid at
    scale 1 (selection, when enabled, computed at scale 1 and reused at
    scale 2), second scale = MATLAB-bicubic 0.5 downsample.

    sharpness_threshold: None (default) keeps ALL patches — what the
    reference implementations do when SCORING a test image; pass a value
    (0.75 in the papers) only when FITTING a pristine model, where the
    corpus is filtered to its sharp patches."""
    from ..data.imresize import imresize

    gray = _to_gray(img)
    h, w = gray.shape
    hc, wc = (h // patch_size) * patch_size, (w // patch_size) * patch_size
    if hc < patch_size or wc < patch_size:
        raise ValueError(
            f"image {h}x{w} smaller than one {patch_size}px NIQE patch")
    gray = gray[:hc, :wc]
    win = _gaussian_window()

    coeffs, sigma_field = mscn(gray, win)
    ny, nx = hc // patch_size, wc // patch_size
    if sharpness_threshold is None:
        selected = np.arange(ny * nx)
    else:
        sharpness = sigma_field[:ny * patch_size, :nx * patch_size].reshape(
            ny, patch_size, nx, patch_size).mean(axis=(1, 3)).ravel()
        selected = np.flatnonzero(
            sharpness > sharpness_threshold * sharpness.max())
        if selected.size == 0:
            selected = np.array([int(np.argmax(sharpness))])

    half = imresize(gray / 255.0, scale=0.5) * 255.0
    coeffs2, _ = mscn(half, win)
    p2 = patch_size // 2

    rows = []
    for idx in selected:
        by, bx = divmod(int(idx), nx)
        f1 = _patch_features(
            coeffs[by * patch_size:(by + 1) * patch_size,
                   bx * patch_size:(bx + 1) * patch_size])
        f2 = _patch_features(
            coeffs2[by * p2:(by + 1) * p2, bx * p2:(bx + 1) * p2])
        rows.append(np.concatenate([f1, f2]))
    return np.stack(rows)


# ---------------------------------------------------------------- the model

def fit_niqe_model(images: Sequence[np.ndarray], patch_size: int = 96,
                   sharpness_threshold: float = 0.75) -> Dict:
    """Fit a pristine MVG model {mu, cov} from clean images (the surrogate
    path — relative scores only; absolute parity needs the official
    niqe_image_params via load_niqe_model). Sharpness selection applies
    HERE (the pristine corpus keeps only its sharp patches, per the
    reference implementations); scoring uses all patches. Images smaller
    than one patch are skipped with a warning rather than aborting the
    whole fit."""
    import warnings
    rows = []
    for im in images:
        try:
            rows.append(niqe_features(im, patch_size, sharpness_threshold))
        except ValueError as e:
            warnings.warn(f"fit_niqe_model: skipping image: {e}")
    if not rows:
        raise ValueError(
            f"no usable images: all inputs smaller than one "
            f"{patch_size}px NIQE patch (or empty input list)")
    feats = np.concatenate(rows, axis=0)
    if feats.shape[0] < 2:
        raise ValueError("need >= 2 selected patches to fit a covariance")
    return {"mu": feats.mean(axis=0),
            "cov": np.cov(feats, rowvar=False),
            "patch_size": patch_size,
            "source": "surrogate-fit"}


def load_niqe_model(path: str) -> Dict:
    """Turnkey loader for a real pristine model: .npz with mu/cov, or the
    official MATLAB .mat (keys pop_mu/pop_cov or mu_prisparam/cov_prisparam;
    mu stored as a row/column vector either way)."""
    if path.endswith(".mat"):
        import scipy.io as sio
        m = sio.loadmat(path)
        for mu_k, cov_k in (("pop_mu", "pop_cov"),
                            ("mu_prisparam", "cov_prisparam")):
            if mu_k in m:
                return {"mu": np.asarray(m[mu_k], np.float64).ravel(),
                        "cov": np.asarray(m[cov_k], np.float64),
                        "patch_size": 96, "source": os.path.basename(path)}
        raise KeyError(f"no known NIQE keys in {path}: {sorted(m)[:8]}")
    z = np.load(path)
    return {"mu": np.asarray(z["mu"], np.float64).ravel(),
            "cov": np.asarray(z["cov"], np.float64),
        "patch_size": int(z["patch_size"]) if "patch_size" in z else 96,
            "source": os.path.basename(path)}


def save_niqe_model(path: str, model: Dict) -> str:
    np.savez(path, mu=model["mu"], cov=model["cov"],
             patch_size=model.get("patch_size", 96))
    return path


def niqe(img: np.ndarray, model: Dict) -> float:
    """NIQE score of one image against a pristine model (lower = better).
    Distance between the pristine MVG and the image's fitted MVG with the
    pooled covariance, pinv for rank-deficient fits (few patches give a
    singular 36x36 covariance — MATLAB hits the same and also uses pinv).
    ALL patches of the test image contribute (sharpness selection is a
    pristine-FIT step only, matching skvideo/MATLAB — scoring with
    selection would shift mu/cov away from what published numbers use)."""
    feats = niqe_features(img, model.get("patch_size", 96))
    mu_d = feats.mean(axis=0)
    cov_d = (np.cov(feats, rowvar=False) if feats.shape[0] > 1
             else np.zeros((feats.shape[1], feats.shape[1])))
    diff = np.asarray(model["mu"], np.float64) - mu_d
    pooled = (np.asarray(model["cov"], np.float64) + cov_d) / 2.0
    return float(math.sqrt(max(0.0, diff @ np.linalg.pinv(pooled) @ diff)))
