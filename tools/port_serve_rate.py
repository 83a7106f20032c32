"""Serving rate of an rcot_torch tree on one CUDA card.

    python tools/port_serve_rate.py [--root DIR] [--rounds 3]
        [--composition full --attention-core gram --depthwise fused]
        [--dtype float32|bfloat16]

Imports rcot_torch from DIR (default: this checkout), builds its kernels
into DIR/build/kernels, and times make_restorer(...).restore_batch on
256x256 images at batch 1 and 8 with the full-width T_net (ModelConfig(),
seeded weights), TF32 off, as chip_smoke.py phase 5 does, and the peak
of torch.cuda.max_memory_allocated over the batch-8 rounds, in the block
composition, attention core and depthwise tier given (serving's default
"full"/gram/fused; e.g. off/mdta/dwconv, chip_smoke.py phase 4b's), in fp32
or bf16 (make_restorer's dtype; a tree without it prints its refusal).
Prints one JSON line with the card's name and power limit. To hold two trees
against each other, run them in turns on the same card (A, B, B, A).
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
    ap.add_argument("--composition", default="full")
    ap.add_argument("--attention-core", default="gram")
    ap.add_argument("--depthwise", default="fused")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
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
    tier = dict(composition=args.composition, attention_core=args.attention_core,
                depthwise=args.depthwise)
    dtype = {} if args.dtype == "float32" else {"dtype": torch.bfloat16}
    try:
        restorer = make_restorer(TNet(cfg, device="cuda", seed=0).eval(), cfg, device="cuda",
                                 **tier, **dtype)
    except TypeError as e:  # a tree from before bf16 serving
        print(json.dumps({"root": str(root), "card": card, "dtype": args.dtype,
                          "refused": str(e)}))
        return 0
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
    torch.cuda.reset_peak_memory_stats()
    b8 = [rate(8, 3) for _ in range(args.rounds)]
    print(json.dumps({"root": str(root), "card": card, **tier, "dtype": args.dtype,
                      "batch1_img_per_s": b1,
                      "batch8_img_per_s": b8,
                      "batch8_max_memory_allocated": torch.cuda.max_memory_allocated()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
