"""Host-side datasets: manifests, oversampling, ground-truth paths, crops,
and the image folders of evaluation.

Counterpart of rcot_tpu/data/datasets.py:36-177 (reference:
util/dataset_utils.py:27-281):
- manifest-driven sample lists per degradation, oversampled (denoise x5,
  derain x360, deblur x5, lowlight x20, single x5); de_ids as DE_DICT;
- images centre-cropped to multiples of 16, then a random patch; paired
  tasks crop degraded and clean at one location;
- ground-truth paths: rain 'rainy/rain-N.png' -> 'gt/norain-N.png'; haze
  'synthetic/<p>_*.ext' -> 'original/<p>.ext'; deblur blur/ vs sharp/;
  lowlight low/ vs high/; single degraded/ vs target/.

Every directory listing is sorted and the draws come from a given
random.Random, so the index and the patches are the JAX package's, byte
for byte. The host decodes and crops only; the augment and the noise run
on the device (data/degradations.py).
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

from ..utils.config import DE_DICT, DataConfig

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def collapse_de_id(de_id):
    """The noise_combine label collapse (rcot_tpu/data/datasets.py:180,
    reference util/dataset_utils.py:267-277): every denoise id -> 0, the
    others shift down by 2. Ints or arrays. Batches keep the canonical ids;
    this is for prompt-style harnesses."""
    collapsed = np.asarray(de_id) - 2
    return np.maximum(collapsed, 0) if collapsed.ndim else max(int(collapsed), 0)


def load_rgb(path: str) -> np.ndarray:
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def list_image_folder(path: str) -> List[str]:
    return sorted(os.path.join(path, n) for n in os.listdir(path)
                  if n.lower().endswith(IMAGE_EXTS))


def eval_pairs(degset: str, tarset: str) -> List[Tuple[str, str]]:
    """Sorted-glob pairing of degraded/target folders (reference: tester.py:55-58)."""
    return list(zip(list_image_folder(degset), list_image_folder(tarset)))


def crop_to_base(img: np.ndarray, base: int = 16) -> np.ndarray:
    """Centre-crop HWC to multiples of `base` (reference: util/image_utils.py:59-64)."""
    h, w = img.shape[:2]
    ch, cw = h % base, w % base
    return img[ch // 2:h - ch + ch // 2, cw // 2:w - cw + cw // 2, :]


def rain_gt_path(rainy: str) -> str:
    """'.../rainy/rain-N.png' -> '.../gt/norain-N.png'."""
    return rainy.split("rainy")[0] + "gt/norain-" + rainy.split("rain-")[-1]


def haze_gt_path(hazy: str) -> str:
    """'.../synthetic/<p>_*.ext' -> '.../original/<p>.ext'."""
    dir_name = hazy.split("synthetic")[0] + "original/"
    name = hazy.split("/")[-1].split("_")[0]
    suffix = "." + hazy.split(".")[-1]
    return dir_name + name + suffix


@dataclass
class Sample:
    degraded_path: str
    clean_path: str
    de_id: int


class TrainIndex:
    """The oversampled sample list of the configured de_types, in the JAX
    package's order (denoise lists shuffled by `rng`, one shuffle per id)."""

    def __init__(self, cfg: DataConfig, rng: Optional[random.Random] = None):
        self.cfg = cfg
        self.rng = rng or random.Random(0)
        self.samples: List[Sample] = []
        self._build()

    def _manifest(self, rel: str) -> List[str]:
        with open(os.path.join(self.cfg.data_file_dir, rel)) as f:
            return [ln.strip() for ln in f if ln.strip()]

    def _build(self) -> None:
        cfg = self.cfg
        ov = cfg.oversample
        de = cfg.de_type
        add = self.samples.extend

        denoise_ids = [t for t in ("denoise_15", "denoise_25", "denoise_50") if t in de]
        if denoise_ids:
            names = set(self._manifest("noisy/denoise.txt"))
            listing = [cfg.denoise_dir + n for n in sorted(os.listdir(cfg.denoise_dir))
                       if n.strip() in names]
            for t in denoise_ids:
                batch = [Sample(p, p, DE_DICT[t]) for p in listing] * ov["denoise"]
                self.rng.shuffle(batch)
                add(batch)
        if "derain" in de:
            rainy = [cfg.derain_dir + n for n in self._manifest("rainy/rainTrain.txt")]
            add([Sample(p, rain_gt_path(p), 3) for p in rainy] * ov["derain"])
        if "dehaze" in de:
            hazy = [cfg.dehaze_dir + n for n in self._manifest("hazy/hazy_outside.txt")]
            add([Sample(p, haze_gt_path(p), 4) for p in hazy])
        # (kind, de_id, degraded dir, clean dir, the dir whose listing names
        # the samples)
        for kind, de_id, deg, clean, listed in (
                ("deblur", 5, "blur/", "sharp/", "sharp/"),
                ("lowlight", 6, "low/", "high/", "low/"),
                ("single", 7, "degraded/", "target/", "degraded/")):
            if kind not in de:
                continue
            root = getattr(cfg, f"{kind}_dir")
            names = sorted(os.listdir(os.path.join(root, listed)))
            add([Sample(os.path.join(root, deg, n), os.path.join(root, clean, n), de_id)
                 for n in names] * ov[kind])

    def __len__(self) -> int:
        return len(self.samples)


def _check_patchable(path: str, h: int, w: int, patch_size: int,
                     crop_base: int) -> None:
    """Name the file when an image is too small for the patch crop."""
    if h < patch_size or w < patch_size:
        raise ValueError(
            f"training image {path!r} is {h}x{w} after the mod-{crop_base} "
            f"center crop — smaller than patch_size={patch_size}")


def get_patch_pair(sample: Sample, patch_size: int, crop_base: int,
                   rng: random.Random) -> Tuple[np.ndarray, np.ndarray, int]:
    """Decode and crop one sample -> (degraded, clean, de_id), uint8 patches.
    Denoise ids return the clean patch twice (the noise is made on the
    device); paired ids crop both images at one location."""
    if sample.de_id < 3:
        clean = crop_to_base(load_rgb(sample.clean_path), crop_base)
        h, w = clean.shape[:2]
        _check_patchable(sample.clean_path, h, w, patch_size, crop_base)
        i = rng.randint(0, h - patch_size)
        j = rng.randint(0, w - patch_size)
        patch = clean[i:i + patch_size, j:j + patch_size]
        return patch, patch, sample.de_id
    degraded = crop_to_base(load_rgb(sample.degraded_path), crop_base)
    clean = crop_to_base(load_rgb(sample.clean_path), crop_base)
    h, w = degraded.shape[:2]
    _check_patchable(sample.degraded_path, h, w, patch_size, crop_base)
    _check_patchable(sample.clean_path, *clean.shape[:2], patch_size, crop_base)
    i = rng.randint(0, h - patch_size)
    j = rng.randint(0, w - patch_size)
    return (degraded[i:i + patch_size, j:j + patch_size],
            clean[i:i + patch_size, j:j + patch_size], sample.de_id)
