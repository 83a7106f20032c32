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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch = smoke.torch
    if not torch.cuda.is_available():
        print("port_gram_times: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke.build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for tag, b, shapes in (("serve", 1, smoke.MAIN_SHAPES),
                           ("train", smoke.TRAIN_B, smoke.TRAIN_SHAPES)):
        for label, res, c, heads in shapes:
            rows = smoke.kernel_timings(gen, label, res, c, heads, b, NAMES)
            print(json.dumps({"shape": f"{tag} {label}", **rows}), flush=True)
    print(json.dumps({"root": str(root), "card": smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
