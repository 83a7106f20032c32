"""Image folders for evaluation (rcot_tpu/data/datasets.py:43-46,169-177)."""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
from PIL import Image

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def load_rgb(path: str) -> np.ndarray:
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def list_image_folder(path: str) -> List[str]:
    return sorted(os.path.join(path, n) for n in os.listdir(path)
                  if n.lower().endswith(IMAGE_EXTS))


def eval_pairs(degset: str, tarset: str) -> List[Tuple[str, str]]:
    """Sorted-glob pairing of degraded/target folders (reference: tester.py:55-58)."""
    return list(zip(list_image_folder(degset), list_image_folder(tarset)))
