"""FID between two image folders or saved .npz statistics.

    python -m rcot_torch.cli.fid PATH1 PATH2 [--batch-size 50] \
        [--inception-weights W.npz] [--device cuda] [--save-stats]

Counterpart of rcot_tpu/cli/fid.py (reference: the vendored pytorch-fid
CLI, fid_score.py:54-71,294-324). A path is a folder of images or a stats
.npz; with --save-stats the second path is where the first folder's
statistics go. Images get the reference's preprocessing (PIL resize to 256,
centre crop 256, ToTensor; fid_score.py:120-124), then the network's own
299 bilinear resize and [-1, 1] scaling (metrics/inception.py) on the
device. The Frechet distance runs on the host (metrics/frechet.py).
"""

from __future__ import annotations

import argparse
import functools
from typing import Optional

import numpy as np
from PIL import Image

from ..data.datasets import list_image_folder
from ..metrics.frechet import (activation_statistics, frechet_distance, load_stats,
                               save_stats)
from ..metrics.inception import InceptionV3, inception_pool3
from ..utils.device import resolve_device


def _load_and_preprocess(path: str, size: int = 256) -> np.ndarray:
    """torchvision Resize(size) + CenterCrop(size) + ToTensor, exactly: the
    long side is int(size * long / short), truncated (640x427 -> 383), and
    the crop offset is int(round(diff / 2.0))."""
    with Image.open(path) as src:
        img = src.convert("RGB")
    w, h = img.size
    if w < h:
        nw, nh = size, max(size, int(size * h / w))
    else:
        nh, nw = size, max(size, int(size * w / h))
    img = img.resize((nw, nh), Image.BILINEAR)
    left = int(round((nw - size) / 2.0))
    top = int(round((nh - size) / 2.0))
    img = img.crop((left, top, left + size, top + size))
    return np.asarray(img, np.float32) / 255.0


@functools.lru_cache(maxsize=2)
def _cached_net(weights: Optional[str], device: str) -> InceptionV3:
    """One net per (weights, device): compute_fid_folders reads two folders."""
    return InceptionV3(weights, device)


def folder_activations(folder: str, *, batch_size: int = 50,
                       weights: Optional[str] = None, device="cuda") -> np.ndarray:
    """(N, 2048) pool3 features of a folder's images, in sorted order."""
    net = _cached_net(weights, str(resolve_device(device)))
    files = list_image_folder(folder)
    if not files:
        raise ValueError(f"no images in {folder}")
    feats = []
    for i in range(0, len(files), batch_size):
        batch = np.stack([_load_and_preprocess(f) for f in files[i:i + batch_size]])
        feats.append(inception_pool3(net, batch).cpu().numpy())
    return np.concatenate(feats)


def _stats_for(path: str, batch_size: int, weights: Optional[str], device):
    if path.endswith(".npz"):
        return load_stats(path)
    return activation_statistics(folder_activations(
        path, batch_size=batch_size, weights=weights, device=device))


def compute_fid_folders(path1: str, path2: str, *, batch_size: int = 50,
                        weights: Optional[str] = None, device="cuda") -> float:
    mu1, s1 = _stats_for(path1, batch_size, weights, device)
    mu2, s2 = _stats_for(path2, batch_size, weights, device)
    return frechet_distance(mu1, s1, mu2, s2)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="rcot_torch FID")
    p.add_argument("paths", nargs=2, help="image folders or .npz stats")
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--inception-weights", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--save-stats", action="store_true",
                   help="treat paths as (image_folder, out_stats.npz)")
    args = p.parse_args(argv)

    if args.save_stats:
        mu, sigma = activation_statistics(folder_activations(
            args.paths[0], batch_size=args.batch_size,
            weights=args.inception_weights, device=args.device))
        save_stats(args.paths[1], mu, sigma)
        print(f"saved stats to {args.paths[1]}")
        return
    fid = compute_fid_folders(args.paths[0], args.paths[1],
                              batch_size=args.batch_size,
                              weights=args.inception_weights, device=args.device)
    print(f"FID: {fid:.6f}")


if __name__ == "__main__":
    main()
