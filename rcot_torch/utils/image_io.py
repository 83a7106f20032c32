"""PNG grids of (B, H, W, C) images in [0, 1]: the trainer's sample dumps.

Counterpart of save_image and save_sample_grid in
rcot_tpu/utils/image_io.py (torchvision's save_image layout).
"""

from __future__ import annotations

import math
import os

import numpy as np
from PIL import Image


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
