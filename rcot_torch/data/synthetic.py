"""A seeded synthetic training tree in the layout the presets read.

    python -m rcot_torch.data.synthetic ROOT [--seed 0] [--size 192]

writes, under ROOT:

  Train/Denoise/clean-K.png                    + manifests/noisy/denoise.txt
  Train/Derain/rainy/rain-K.png, gt/norain-K.png + manifests/rainy/rainTrain.txt
  Train/Dehaze/synthetic/hazeK_0.8.png, original/hazeK.png
                                               + manifests/hazy/hazy_outside.txt
  val/input/valK.png, val/target/valK.png      (the last one 250 x 321)

Train on it with --denoise-dir ROOT/Train/Denoise/ --derain-dir
ROOT/Train/Derain/ --dehaze-dir ROOT/Train/Dehaze/ --data-file-dir
ROOT/manifests/ --degset ROOT/val/input/ --tarset ROOT/val/target/.
Degraded images are their clean ones plus seeded noise (rain) or a veil
(haze): content for smoke runs, not for learning.

write_eval_tree (--eval) writes the test sets of cli.eval_all instead: a
clean denoise folder, derain (input/xK-rain -> target/xK-norain), dehaze
(input/<p>_<beta> -> target/<p>), GoPro-style deblur (test/blur,
test/sharp), LOL-style lowlight (low/, high/) and a --paired tree (input/,
target/); clean images are blocks with grain, so NIQE finds sharp patches.
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence, Tuple

import numpy as np
from PIL import Image


def _save(path: str, img: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path)


def _write_lines(path: str, lines: Sequence[str]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("".join(f"{ln}\n" for ln in lines))


def write_synthetic_tree(root: str, *, seed: int = 0, n_denoise: int = 3,
                         n_rain: int = 1, n_haze: int = 6, size: int = 192,
                         val_sizes: Sequence[Tuple[int, int]] = ((192, 192), (250, 321))
                         ) -> None:
    rng = np.random.default_rng(seed)

    def clean(h=size, w=size):
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)

    def degrade(img, veil=False):
        if veil:
            return (0.6 * img + 0.4 * 230).astype(np.uint8)
        return np.clip(img.astype(int) + rng.integers(0, 80, img.shape), 0, 255).astype(np.uint8)

    names = [f"clean-{k}.png" for k in range(n_denoise)]
    for n in names:
        _save(f"{root}/Train/Denoise/{n}", clean())
    _write_lines(f"{root}/manifests/noisy/denoise.txt", names)

    rainy = []
    for k in range(n_rain):
        gt = clean()
        _save(f"{root}/Train/Derain/gt/norain-{k}.png", gt)
        _save(f"{root}/Train/Derain/rainy/rain-{k}.png", degrade(gt))
        rainy.append(f"rainy/rain-{k}.png")
    _write_lines(f"{root}/manifests/rainy/rainTrain.txt", rainy)

    hazy = []
    for k in range(n_haze):
        gt = clean()
        _save(f"{root}/Train/Dehaze/original/haze{k}.png", gt)
        _save(f"{root}/Train/Dehaze/synthetic/haze{k}_0.8.png", degrade(gt, veil=True))
        hazy.append(f"synthetic/haze{k}_0.8.png")
    _write_lines(f"{root}/manifests/hazy/hazy_outside.txt", hazy)

    for k, (h, w) in enumerate(val_sizes):
        tgt = clean(h, w)
        _save(f"{root}/val/target/val{k}.png", tgt)
        _save(f"{root}/val/input/val{k}.png", degrade(tgt))


def write_eval_tree(root: str, *, seed: int = 0, n: int = 2,
                    size: Tuple[int, int] = (256, 256)) -> None:
    """n images a task at `size` (the denoise folder's k-th image 3k rows
    taller). Run with --denoise-path ROOT/denoise --derain-path ROOT/derain
    --dehaze-path ROOT/dehaze --deblur-dir ROOT/deblur --lowlight-dir
    ROOT/lowlight --paired NAME ROOT/paired."""
    rng = np.random.default_rng(seed)
    h, w = size

    def clean(hh=h):
        blocks = rng.integers(0, 256, (-(-hh // 8), -(-w // 8), 3))
        img = np.kron(blocks, np.ones((8, 8, 1)))[:hh, :w]
        return np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.uint8)

    def degrade(img):
        return np.clip(img.astype(int) + rng.integers(-40, 40, img.shape),
                       0, 255).astype(np.uint8)

    for k in range(n):
        _save(f"{root}/denoise/clean{k}.png", clean(h + 3 * k))
    for k in range(n):
        for deg, tgt in ((f"derain/input/x{k}-rain.png", f"derain/target/x{k}-norain.png"),
                         (f"dehaze/input/{k:04d}_0.8_0.2.png", f"dehaze/target/{k:04d}.png"),
                         (f"deblur/test/blur/b{k}.png", f"deblur/test/sharp/b{k}.png"),
                         (f"paired/input/p{k}.png", f"paired/target/p{k}.png")):
            gt = clean()
            _save(f"{root}/{tgt}", gt)
            _save(f"{root}/{deg}", degrade(gt))
        gt = clean()
        _save(f"{root}/lowlight/high/l{k}.png", gt)
        _save(f"{root}/lowlight/low/l{k}.png", gt // 4)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("root")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--size", type=int, default=192)
    p.add_argument("--eval", action="store_true",
                   help="write the test sets of cli.eval_all (write_eval_tree)")
    args = p.parse_args(argv)
    if args.eval:
        write_eval_tree(args.root, seed=args.seed, size=(args.size, args.size))
    else:
        write_synthetic_tree(args.root, seed=args.seed, size=args.size)


if __name__ == "__main__":
    main()
