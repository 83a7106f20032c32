"""PNG grids of (B, H, W, C) images in [0, 1]: the trainer's sample dumps;
and the library's converters between PIL images and float HWC arrays and
the SOTS ground truths' border crop.

Counterpart of rcot_tpu/utils/image_io.py (torchvision's save_image
layout; reference util/image_io.py:20-80).
"""

from __future__ import annotations

import math
import os

import numpy as np
from PIL import Image


def pil_to_np(img) -> np.ndarray:
    """PIL -> float32 HWC in [0, 1]."""
    return np.asarray(img.convert("RGB"), np.float32) / 255.0


def np_to_pil(arr: np.ndarray) -> Image.Image:
    """HWC in [0, 1] -> PIL, rounded half up to 8 bits; one channel -> "L"."""
    a = np.clip(np.asarray(arr) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    return Image.fromarray(a)


def prepare_gt_img(img: np.ndarray, d: int = 10) -> np.ndarray:
    """SOTS ground-truth border crop: outdoor SOTS ground truths carry a
    d-pixel border the hazy inputs lack; d = 0 is the identity."""
    return img if d == 0 else img[d:-d, d:-d, :]


def save_image(path: str, images: np.ndarray, *, nrow: int = 8,
               padding: int = 2) -> None:
    """(B,H,W,C) or (H,W,C) in [0,1] -> one PNG grid, nrow images a row."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.asarray(images, np.float32)
    if arr.ndim == 3:
        arr = arr[None]
    b, h, w, c = arr.shape
    if b == 0:
        raise ValueError(f"save_image({path!r}): empty batch")
    ncol = min(nrow, b)
    nrows = math.ceil(b / ncol)
    grid = np.zeros((nrows * (h + padding) + padding,
                     ncol * (w + padding) + padding, c), np.float32)
    for i in range(b):
        r, col = divmod(i, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y:y + h, x:x + w] = arr[i]
    pixels = np.clip(grid * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(pixels[..., 0] if c == 1 else pixels).save(path)


def save_sample_grid(out_dir: str, tag: str, **named_images) -> None:
    """One grid per named batch: <out_dir>/<tag>_<name>.png."""
    for name, img in named_images.items():
        save_image(os.path.join(out_dir, f"{tag}_{name}.png"), np.asarray(img))
