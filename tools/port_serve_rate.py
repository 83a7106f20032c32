"""Serving rate of an rcot_torch tree on one CUDA card.

    python tools/port_serve_rate.py [--root DIR] [--rounds 3]

Imports rcot_torch from DIR (default: this checkout), builds its kernels
into DIR/build/kernels, and times make_restorer(...).restore_batch on
256x256 images at batch 1 and 8 with the full-width T_net (ModelConfig(),
seeded weights), TF32 off, as chip_smoke.py phase 5 does. Prints one JSON
line with the card's name and power limit. To hold two trees against each
other, run them in turns on the same card (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    from rcot_torch.kernels import build
    from rcot_torch.models.inference import make_restorer
    from rcot_torch.models.restormer import TNet
    from rcot_torch.utils.config import ModelConfig

    if not torch.cuda.is_available():
        print("port_serve_rate: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    build.library()
    cfg = ModelConfig()
    restorer = make_restorer(TNet(cfg, device="cuda", seed=0).eval(), cfg, device="cuda")
    rng = np.random.default_rng(0)

    def rate(batch: int, iters: int) -> float:
        imgs = [rng.uniform(0, 1, (256, 256, 3)).astype(np.float32) for _ in range(batch)]
        for _ in range(2):
            restorer.restore_batch(imgs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            restorer.restore_batch(imgs)
        torch.cuda.synchronize()
        return batch * iters / (time.perf_counter() - t0)

    b1 = [rate(1, 10) for _ in range(args.rounds)]
    b8 = [rate(8, 3) for _ in range(args.rounds)]
    print(json.dumps({"root": str(root), "card": card, "batch1_img_per_s": b1,
                      "batch8_img_per_s": b8}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
