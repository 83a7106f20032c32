"""Times the MDTA attention core's kernels (rows 3-4 and 6-7) of an
rcot_torch tree on one CUDA card, at every block shape of the serving and
the training path.

    python tools/port_gram_times.py [--root DIR]

Puts DIR (default: this checkout) first on the import path, so that
rcot_torch and the kernels it builds into DIR/build/kernels are DIR's, and
times them with this checkout's chip_smoke.kernel_timings: `ms` (events
around back-to-back calls) and `device_ms` (torch.profiler), the bound, the
plain twin and the library call. Prints one JSON line per shape and, last,
the root and the card's name and power limit. To hold two trees against
each other, run them in turns in one call (A, B, B, A).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
NAMES = ["mdta_gram_fwd", "attn_apply_fwd", "mdta_gram_bwd", "attn_apply_bwd"]


def load(doc: str):
    """Parse --root, put it first on the import path and return this
    checkout's chip_smoke module (importing rcot_torch from the root), or
    None without a card."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.root = root
    if not smoke.torch.cuda.is_available():
        print(f"{Path(sys.argv[0]).stem}: no CUDA card", file=sys.stderr)
        return None
    smoke.torch.backends.cuda.matmul.allow_tf32 = False
    smoke.torch.backends.cudnn.allow_tf32 = False
    smoke.build.library()
    return smoke


def time_shapes(smoke, names) -> dict:
    """Times `names` at every serving (B = 1) and training (B = 3) block
    shape; prints and returns one row per shape, by "serve L1" etc."""
    gen = smoke.torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for tag, b, shapes in (("serve", 1, smoke.MAIN_SHAPES),
                           ("train", smoke.TRAIN_B, smoke.TRAIN_SHAPES)):
        for label, res, c, heads in shapes:
            rows = smoke.kernel_timings(gen, label, res, c, heads, b, names)
            out[f"{tag} {label}"] = rows
            print(json.dumps({"shape": f"{tag} {label}", **rows}), flush=True)
    return out


def main() -> int:
    smoke = load(__doc__)
    if smoke is None:
        return 1
    time_shapes(smoke, NAMES)
    print(json.dumps({"root": str(smoke.root), "card": smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
