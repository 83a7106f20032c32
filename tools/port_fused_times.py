"""Times the fused 1x1 -> depthwise kernels (rows 8-9: conv1x1_dw, gdfn_fused
and their backwards) of an rcot_torch tree on one CUDA card, at every block
shape of the training path (128^2, B = 3) and, forward only, at serve L1
and serve decoder L1 (256^2, B = 1: "tail" and "off" serve through them).

    python tools/port_fused_times.py [--root DIR] [--digest] [--iterations]

As tools/port_block_bwd_times.py does: rcot_torch and its kernels are DIR's
(default: this checkout), timed with this checkout's
chip_smoke.kernel_timings (`ms`, `device_ms`, the bound, the plain twin),
with two floors of the tensor-core design beside (design_floors). Beside
each kernel it prints the device time of one call split into stages by
the kernel names torch.profiler records (`stage_split`: the 1x1 products,
their reduces, the depthwise stencils, the gate, memsets and copies, and
the CUDA-core design's halo kernels and GEMMs), then the sums over one
training iteration (94 blocks, chip_smoke.BLOCKS_PER_FORWARD): a "tail"
iteration runs 94 qkv forwards and backwards, a "head" one 94 GDFN ones.
With --digest it first prints a SHA-256 of the four kernels' outputs on
seeded inputs at every training shape: two calls' digests agree where the
sums run in a fixed order. With --iterations it also times full-width
minimax iterations/s in "tail" and "head" in turns
(chip_smoke.timed_in_turns), as context. Last come the root and the card's
name and power limit. To hold two trees against each other, run them in
turns in one call (A, B, B, A).
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import port_block_bwd_times as bwd_times  # noqa: E402
import port_gram_times  # noqa: E402

FORWARD = ["conv1x1_dw", "gdfn_fused"]
NAMES = ["conv1x1_dw", "conv1x1_dw_bwd", "gdfn_fused", "gdfn_fused_bwd"]
# the configuration each iteration runs rows 8-9 in (ops/dispatch.py)
PER_ITERATION = {"tail": ("conv1x1_dw", "conv1x1_dw_bwd"),
                 "head": ("gdfn_fused", "gdfn_fused_bwd")}


def design_floors(b: int, res: int, c: int, gate_fused_max_c: int) -> dict:
    """Two floors of the tensor-core design at one shape, in ms, beside
    chip_smoke's bound (fp32 CUDA cores): its 1x1 products at the 3xTF32
    rate, and the bytes that its own launches move through device memory
    (each launch reading its inputs and writing its outputs once: in units
    of N floats, the qkv forward's C + 3M with M = 3C, the GDFN's 2C + 8h,
    2C + 10h with a gate pass (C > gate_fused_max_c), the qkv backward's
    3C + 7M and the GDFN's 5C + 24h) at 3.35 TB/s."""
    n, hid, m = b * res * res, int(c * 2.66), 3 * c
    floats = {"conv1x1_dw": n * (c + 3 * m),
              "gdfn_fused": n * (2 * c + (10 if c > gate_fused_max_c else 8) * hid),
              "conv1x1_dw_bwd": n * (3 * c + 7 * m), "gdfn_fused_bwd": n * (5 * c + 24 * hid)}
    flops = {"conv1x1_dw": 2 * n * m * c, "gdfn_fused": 6 * n * hid * c,
             "conv1x1_dw_bwd": 6 * n * m * c, "gdfn_fused_bwd": 16 * n * hid * c}
    return {k: {"tf32x3_products_ms": flops[k] / bwd_times.TF32X3_FLOPS * 1e3,
                "workspace_passes_ms": 4 * floats[k] / 3.35e12 * 1e3} for k in floats}


def calls(smoke, p, g_qkv, g_c) -> dict:
    """{kernel: a call of it} on the block inputs p and the cotangents."""
    kf = smoke.kfused
    qkv, gdfn = smoke.fused_args(p, False), smoke.fused_args(p, True)
    return {"conv1x1_dw": lambda: kf.fused_dwconv_fwd(*qkv),
            "conv1x1_dw_bwd": lambda: kf.fused_dwconv_bwd(*qkv, g_qkv),
            "gdfn_fused": lambda: kf.fused_dwconv_fwd(*gdfn),
            "gdfn_fused_bwd": lambda: kf.fused_dwconv_bwd(*gdfn, g_c)}


def inputs(smoke, gen, b, res, c):
    r = lambda *shape: smoke.torch.randn(*shape, device="cuda", generator=gen)  # noqa: E731
    return smoke.block_inputs(gen, b, res, c, False), r(b, res, res, 3 * c), r(b, res, res, c)


def digests(smoke) -> dict:
    """SHA-256 of rows 8-9's outputs on seeded inputs, by shape."""
    gen = smoke.torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for label, res, c, _ in smoke.TRAIN_SHAPES:
        h = hashlib.sha256()
        for fn in calls(smoke, *inputs(smoke, gen, smoke.TRAIN_B, res, c)).values():
            got = fn()
            for t in (got,) if smoke.torch.is_tensor(got) else got:
                if t is not None:
                    h.update(t.cpu().numpy().tobytes())
        out[label] = h.hexdigest()
    return out


def iterations(smoke) -> dict:
    """Full-width minimax iterations/s in "tail" and "head", in turns."""
    cfg = smoke.Config()
    state = smoke.create_train_state(cfg, seed=0, device="cuda")
    gen = smoke.torch.Generator(device="cuda").manual_seed(0)
    batches, alphas = smoke.train_inputs(gen, cfg)
    settings = {"tail": dict(composition="tail"), "head": dict(composition="head")}
    smoke.timed_in_turns(state, cfg, batches, alphas, settings, n_timed=1)
    return smoke.timed_in_turns(state, cfg, batches, alphas, settings)


def main() -> int:
    flags = {f: f in sys.argv for f in ("--digest", "--iterations")}
    sys.argv = [a for a in sys.argv if a not in flags]
    smoke = port_gram_times.load(__doc__)
    if smoke is None:
        return 1
    if flags["--digest"]:
        print(json.dumps({"digests": digests(smoke)}), flush=True)
    gen = smoke.torch.Generator(device="cuda").manual_seed(0)
    serve = [s for s in smoke.MAIN_SHAPES if s[0] in ("L1", "decoder_level1")]
    rows = {}
    for tag, b, shapes, names in (
            ("serve", 1, serve, FORWARD),
            ("train", smoke.TRAIN_B, smoke.TRAIN_SHAPES, NAMES)):
        for label, res, c, heads in shapes:
            row = smoke.kernel_timings(gen, label, res, c, heads, b, names)
            fns = calls(smoke, *inputs(smoke, gen, b, res, c))
            floors = design_floors(b, res, c, smoke.kblock.GATE_FUSED_MAX_C)
            for name in names:
                row[name]["stage_split"] = bwd_times.stage_split(smoke, fns[name])
                row[name].update(floors[name])
            rows[f"{tag} {label}"] = row
            print(json.dumps({"shape": f"{tag} {label}", **row}), flush=True)
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "tf32x3_products_ms",
            "workspace_passes_ms")
    per = {name: {k: sum(n * rows[f"train {label}"][name][k]
                         for label, n in smoke.BLOCKS_PER_FORWARD.items()) for k in keys}
           for name in NAMES}
    print(json.dumps({"per_train_iteration": {
        mode: {**{name: per[name] for name in pair},
               "both": {k: sum(per[name][k] for name in pair) for k in keys}}
        for mode, pair in PER_ITERATION.items()}}), flush=True)
    if flags["--iterations"]:
        print(json.dumps({"iterations_per_s_in_turns": iterations(smoke)}), flush=True)
    print(json.dumps({"root": str(smoke.root), "card": smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
