"""Times the depthwise 3x3 kernels (row 11: the forward, dx and dtaps) of
an rcot_torch tree on one CUDA card, at every block shape of the serving
and the training path.

    python tools/port_dwconv_times.py [--root DIR]

As tools/port_gram_times.py does: rcot_torch and its kernels are DIR's
(default: this checkout), timed with this checkout's
chip_smoke.kernel_timings (`ms`, `device_ms`, the bound, the plain twin and
the library call: cuDNN's depthwise convolution, or its weight gradient
for dtaps), the forward and dx at the GDFN width (2h) and the qkv width
(3C), dtaps at 3C. A tree whose ops/dwconv.py has no dtaps kernel computes
dtaps with nine products and sums in PyTorch ops; that code is timed in
the kernel's place. Prints one JSON line per shape, then the three
kernels' sums over one training iteration in tail/mdta/dwconv (94 blocks
at the qkv width, chip_smoke.BLOCKS_PER_FORWARD) and, last, the root and
the card's name and power limit. To hold two trees against each other,
run them in turns in one call (A, B, B, A).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))
import port_gram_times  # noqa: E402

NAMES = ["dwconv3x3", "dwconv3x3_qkv", "dwconv3x3_dx", "dwconv3x3_dx_qkv", "dwconv3x3_dtaps"]
TRAIN_ROWS = ["dwconv3x3_qkv", "dwconv3x3_dx_qkv", "dwconv3x3_dtaps"]


def nine_products(x, g):
    """dtaps as a tree without its kernel computes it (x, g (B,H,W,C))."""
    h, w = x.shape[1:3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([(g * xp[:, i:i + h, j:j + w]).sum(dim=(0, 1, 2))
                        for i in range(3) for j in range(3)], dim=-1).reshape(-1, 3, 3)


def main() -> int:
    smoke = port_gram_times.load(__doc__)
    if smoke is None:
        return 1
    if not hasattr(smoke.kdw, "dwconv3x3_dtaps"):
        smoke.kdw.dwconv3x3_dtaps = smoke.kdw.dwconv3x3_dtaps_plain = nine_products
    rows = port_gram_times.time_shapes(smoke, NAMES)
    per_iteration = {name: {key: sum(n * rows[f"train {label}"][name][key]
                                     for label, n in smoke.BLOCKS_PER_FORWARD.items())
                            for key in ("ms", "device_ms", "bound_ms", "library_ms",
                                        "library_device_ms")}
                     for name in TRAIN_ROWS}
    print(json.dumps({"per_train_iteration_tail_mdta_dwconv": per_iteration}))
    print(json.dumps({"root": str(smoke.root), "card": smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
