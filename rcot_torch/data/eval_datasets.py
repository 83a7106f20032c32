"""The four test-set classes of multi-task evaluation; a copy of
rcot_tpu/data/eval_datasets.py (reference: util/dataset_utils.py:290-521).

Each yields (name, degraded, clean) as float32 [0,1] HWC numpy arrays,
images centre-cropped to multiples of 16 like the reference.

- DenoiseTestDataset: a clean folder plus gaussian noise drawn on the fly,
  set_sigma reseeding the stream from (seed, sigma) (:290-349).
- DerainDehazeDataset: set_dataset('derain'|'dehaze') with the input ->
  target GT-path rules (:383-397), optional addnoise.
- DeblurTestDataset: test/blur against test/sharp, val split 50 (:421-473).
- LowLightTestDataset: low/ against high/ (:478-521).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .datasets import crop_to_base, list_image_folder, load_rgb

Item = Tuple[str, np.ndarray, np.ndarray]


def _to01(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 255.0


def _add_noise(rng: np.random.Generator, img_u8: np.ndarray, sigma: float) -> np.ndarray:
    noise = rng.standard_normal(img_u8.shape)
    return np.clip(img_u8 + noise * sigma, 0, 255).astype(np.uint8)


class DenoiseTestDataset:
    def __init__(self, denoise_path: str, sigma: float = 15, *, seed: int = 0,
                 crop_base: int = 16):
        self.files = list_image_folder(denoise_path)
        self.crop_base = crop_base
        self._seed = seed
        self.set_sigma(sigma)

    def set_sigma(self, sigma: float) -> None:
        """Reseeds the noise stream from (seed, sigma): each sigma's noise
        is then independent of which other sigmas were evaluated first, so
        per-sigma numbers are reproducible across invocations. (The
        reference draws from the unseeded global np.random stream,
        dataset_utils.py:307-308 — no reproducibility contract to keep.)"""
        self.sigma = sigma
        self.rng = np.random.default_rng((self._seed, int(sigma * 1000)))

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> Item:
        clean = crop_to_base(load_rgb(self.files[i]), self.crop_base)
        noisy = _add_noise(self.rng, clean, self.sigma)
        name = os.path.basename(self.files[i]).rsplit(".", 1)[0]
        return name, _to01(noisy), _to01(clean)


class DerainDehazeDataset:
    def __init__(self, derain_path: str = "", dehaze_path: str = "",
                 task: str = "derain", *, addnoise: bool = False,
                 sigma: Optional[float] = None, seed: int = 0,
                 crop_base: int = 16):
        self.paths = {"derain": derain_path, "dehaze": dehaze_path}
        self.addnoise = addnoise
        self.sigma = sigma
        self.crop_base = crop_base
        self.rng = np.random.default_rng(seed)
        self.set_dataset(task)

    def set_dataset(self, task: str) -> None:
        if task not in self.paths:
            raise KeyError(task)
        self.task = task
        root = self.paths[task]
        self.ids = list_image_folder(os.path.join(root, "input/"))

    def _gt_path(self, degraded: str) -> str:
        if self.task == "derain":
            # input/x_rain.png -> target/x_norain.png (:383-388)
            gt = degraded.replace("input", "target")
            d, f = os.path.split(gt)
            return os.path.join(d, f.replace("rain", "norain"))
        # dehaze: input/<p>_rest -> target/<p>.png (:389-393)
        d = degraded.split("input")[0] + "target/"
        name = degraded.split("/")[-1].split("_")[0] + ".png"
        return d + name

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, i: int) -> Item:
        deg_path = self.ids[i]
        deg = crop_to_base(load_rgb(deg_path), self.crop_base)
        if self.addnoise:
            deg = _add_noise(self.rng, deg, self.sigma)
        clean = crop_to_base(load_rgb(self._gt_path(deg_path)), self.crop_base)
        name = os.path.basename(deg_path)[:-4]
        return name, _to01(deg), _to01(clean)


class DeblurTestDataset:
    def __init__(self, deblur_dir: str, *, is_val: bool = False,
                 val_split: int = 50, addnoise: bool = False,
                 sigma: Optional[float] = None, seed: int = 0,
                 crop_base: int = 16):
        names = sorted(os.listdir(os.path.join(deblur_dir, "test/sharp/")))
        if is_val:
            names = names[:val_split]
        self.names = names
        self.root = deblur_dir
        self.addnoise = addnoise
        self.sigma = sigma
        self.crop_base = crop_base
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, i: int) -> Item:
        n = self.names[i]
        deg = crop_to_base(load_rgb(os.path.join(self.root, "test/blur", n)),
                           self.crop_base)
        clean = crop_to_base(load_rgb(os.path.join(self.root, "test/sharp", n)),
                             self.crop_base)
        if self.addnoise:
            deg = _add_noise(self.rng, deg, self.sigma)
        return n, _to01(deg), _to01(clean)


class LowLightTestDataset:
    def __init__(self, lowlight_dir: str, *, addnoise: bool = False,
                 sigma: Optional[float] = None, seed: int = 0,
                 crop_base: int = 16):
        self.names = sorted(os.listdir(os.path.join(lowlight_dir, "low/")))
        self.root = lowlight_dir
        self.addnoise = addnoise
        self.sigma = sigma
        self.crop_base = crop_base
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, i: int) -> Item:
        n = self.names[i]
        deg = crop_to_base(load_rgb(os.path.join(self.root, "low", n)),
                           self.crop_base)
        clean = crop_to_base(load_rgb(os.path.join(self.root, "high", n)),
                             self.crop_base)
        if self.addnoise:
            deg = _add_noise(self.rng, deg, self.sigma)
        return n, _to01(deg), _to01(clean)
