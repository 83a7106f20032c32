"""Times the MDTA attention core's kernels (rows 3-4 and 6-7) of an
rcot_torch tree on one CUDA card, at every block shape of the serving and
the training path.

    python tools/port_gram_times.py [--root DIR] [--digest]

Puts DIR (default: this checkout) first on the import path, so that
rcot_torch and the kernels it builds into DIR/build/kernels are DIR's, and
times them with this checkout's chip_smoke.kernel_timings: `ms` (events
around back-to-back calls) and `device_ms` (torch.profiler), the bound, the
plain twin and the library call. Prints one JSON line per shape, then the
same at the heads of one head a level (ModelConfig(heads=(1, 1, 1, 1)):
192 channels at level 3, 384 at the latent; a tree that refuses heads
wider than 128 prints its refusal) and, last, the root and the card's name
and power limit. With --digest it first prints a SHA-256 of the four
kernels' outputs on seeded inputs at every serving and training shape,
computed twice: two trees, or two calls, whose digests agree computed the
same bits. To hold two trees against each other, run them in turns in one
call (A, B, B, A).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
NAMES = ["mdta_gram_fwd", "attn_apply_fwd", "mdta_gram_bwd", "attn_apply_bwd"]
# (label, resolution, C) of the one-head-a-level model's wide heads
WIDE_SHAPES = [("L3", 64, 192), ("latent", 32, 384)]


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


def digests(smoke) -> dict:
    """{shape: [SHA-256 of the four kernels' outputs, of a second call's]}
    on seeded inputs at every serving (B = 1) and training (B = 3) shape."""
    torch = smoke.torch
    kg = smoke.kgram
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for tag, b, shapes in (("serve", 1, smoke.MAIN_SHAPES),
                           ("train", smoke.TRAIN_B, smoke.TRAIN_SHAPES)):
        for label, res, c, heads in shapes:
            ch = c // heads
            r = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
            qkv, g = r(b, res, res, 3 * c), r(b, res, res, c)
            attn = torch.softmax(r(b, heads, ch, ch), -1)
            cot = [r(b, heads, ch, ch), r(b, heads, ch), r(b, heads, ch)]
            twice = []
            for _ in range(2):
                h = hashlib.sha256()
                for t in (*kg.mdta_gram_fwd(qkv, heads), kg.attn_apply_fwd(qkv, attn),
                          kg.mdta_gram_bwd(qkv, *cot, heads), *kg.attn_apply_bwd(qkv, attn, g)):
                    h.update(t.cpu().numpy().tobytes())
                twice.append(h.hexdigest())
            out[f"{tag} {label}"] = twice
    return out


def time_wide(smoke) -> None:
    """The four kernels at one head of 192 and of 384 channels, B = 1 at
    256 px and B = 3 at 128 px; a refusal is printed as such."""
    gen = smoke.torch.Generator(device="cuda").manual_seed(0)
    for tag, b, f in (("serve", 1, 1), ("train", smoke.TRAIN_B, 256 // smoke.TRAIN_RES)):
        for label, res, c in WIDE_SHAPES:
            shape = f"{tag} {label} one head"
            try:
                rows = smoke.kernel_timings(gen, label, res // f, c, 1, b, NAMES)
            except ValueError as e:
                print(json.dumps({"shape": shape, "refused": str(e)}), flush=True)
                continue
            print(json.dumps({"shape": shape, **rows}), flush=True)


def main() -> int:
    flag = "--digest" in sys.argv
    sys.argv = [a for a in sys.argv if a != "--digest"]
    smoke = load(__doc__)
    if smoke is None:
        return 1
    if flag:
        print(json.dumps({"digests": digests(smoke)}), flush=True)
    time_shapes(smoke, NAMES)
    time_wide(smoke)
    print(json.dumps({"root": str(smoke.root), "card": smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
