"""MATLAB-faithful bicubic imresize (host-side numpy), the part of
rcot_tpu/data/imresize.py that NIQE's second scale uses.

Behavioral spec (reference: util/imresize.py): for each output coordinate
u, sample positions x = (u + 0.5) / scale - 0.5 (0-based), the Keys
(a = -0.5) cubic kernel widened by 1/scale when downscaling (antialiasing),
weights normalized to sum 1. Boundary taps follow the reference, not
MATLAB's replicate-clamp: taps left of the image get weight 0 and the rest
renormalize; taps right of it mirror back into the image (reference
util/imresize.py:113-126). Float inputs only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _cubic(x: np.ndarray) -> np.ndarray:
    """MATLAB bicubic kernel (Keys, a = -0.5), support 4."""
    ax = np.abs(x)
    ax2, ax3 = ax ** 2, ax ** 3
    return ((1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((ax > 1) & (ax <= 2)))


def _contributions(in_len: int, out_len: int, scale: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-pixel (weights, indices) like MATLAB's contributions()."""
    if scale < 1:
        def h(x):
            return scale * _cubic(scale * x)
        kernel_width = 4.0 / scale
    else:
        h = _cubic
        kernel_width = 4.0

    u = (np.arange(out_len, dtype=np.float64) + 0.5) / scale - 0.5
    left = np.floor(u - kernel_width / 2).astype(np.int64)
    p = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p)[None, :]
    weights = h(u[:, None] - indices)
    weights[indices < 0] = 0.0
    sums = np.sum(weights, axis=1, keepdims=True)
    sums[sums == 0] = 1.0
    weights = weights / sums
    mirror = np.concatenate([np.arange(in_len), np.arange(in_len - 1, -1, -1)])
    indices = mirror[np.mod(indices, mirror.shape[0])]

    # drop all-zero columns (MATLAB prunes them)
    keep = ~np.all(weights == 0, axis=0)
    return weights[:, keep], indices[:, keep]


def imresize(img: np.ndarray, scale: float) -> np.ndarray:
    """Resize a float HxW or HxWxC image by `scale` (output ceil(H * scale)
    by ceil(W * scale)), rows first, as MATLAB does at equal scales."""
    in_h, in_w = img.shape[:2]
    out_h, out_w = int(np.ceil(in_h * scale)), int(np.ceil(in_w * scale))
    x = img.astype(np.float64)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, :, None]
    w, idx = _contributions(in_h, out_h, float(scale))
    x = np.einsum("op,opwc->owc", w, x[idx, :, :])
    w, idx = _contributions(in_w, out_w, float(scale))
    x = np.einsum("op,hopc->hoc", w, x[:, idx, :])
    if squeeze:
        x = x[:, :, 0]
    return x.astype(img.dtype)
