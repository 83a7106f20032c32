"""Times the fused block forward (rows 1-2: block_tail_fwd and block_head_fwd)
of an rcot_torch tree on one CUDA card, at every block shape of the serving
path (256^2, B = 1) and of the training path (128^2, B = 3).

    python tools/port_block_fwd_times.py [--root DIR] [--serve-rate] [--odd-h]

As tools/port_block_bwd_times.py does: rcot_torch and its kernels are DIR's
(default: this checkout), timed with this checkout's
chip_smoke.kernel_timings (`ms`, `device_ms`, the bound, the plain twin),
with two floors of the tensor-core design beside (design_floors). Beside
each shape it prints the device time of one call split into stages by the
kernel names torch.profiler records (`stage_split`: the 1x1 products, the
LayerNorm, the depthwise stencils, the gate, the reduces, memsets and
copies, and the fused halo kernels of the CUDA-core design), then the sums
over one serving forward (chip_smoke.BLOCKS_PER_FORWARD: 94 heads and 94
tails), one "tail" training iteration (94 tails) and one "full" one (94 of
each). With --serve-rate it then runs tools/port_serve_rate.py on the same
root in this call (img/s at batch 1 and 8, the peak memory at batch 8), as
context. With --odd-h it times the tail at train L1 and serve decoder L1
with the model's odd h (127, 255: conv's c2 half and W_out's rows 4-byte
aligned, so their width class takes 4-byte copies) and with h rounded up to
a multiple of 4 (16-byte copies), split by launch: what the narrow copies
cost. Last come the root and the card's name and power limit. To hold
two trees against each other, run them in turns in one call (A, B, B, A).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import port_block_bwd_times as bwd_times  # noqa: E402
import port_gram_times  # noqa: E402

NAMES = ["block_tail", "block_head"]


def design_floors(b: int, res: int, c: int) -> dict:
    """Two floors of the tensor-core forward at one shape, in ms, beside
    chip_smoke's bound (fp32 CUDA cores): its 1x1 products at the 3xTF32
    rate, and the bytes that its own launches move through device memory
    (each launch reading its inputs and writing its outputs once: in units
    of N floats, the tail's 8 h + 8 C (t, LN2, h, the depthwise, the gated
    W_out product), the head's 3 M + 3 C with M = 3C (LN1, qkv, the
    depthwise)) at 3.35 TB/s."""
    n, hid, m = b * res * res, int(c * 2.66), 3 * c
    floats = {"block_tail": n * (8 * hid + 8 * c), "block_head": n * (3 * m + 3 * c)}
    flops = {"block_tail": 2 * n * (c * c + 3 * hid * c), "block_head": 2 * n * m * c}
    return {k: {"tf32x3_products_ms": flops[k] / bwd_times.TF32X3_FLOPS * 1e3,
                "workspace_passes_ms": 4 * floats[k] / 3.35e12 * 1e3} for k in floats}


def odd_h_cost(smoke) -> dict:
    """The tail at train L1 and serve decoder L1 with its h and with h
    rounded up to a multiple of 4, device ms and split by launch."""
    torch = smoke.torch
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for tag, b, res, c in (("train L1", smoke.TRAIN_B, smoke.TRAIN_RES, 48),
                           ("serve decoder_level1", 1, 256, 96)):
        hid = int(c * 2.66)
        for h in (hid, hid + -hid % 4):
            p = smoke.block_inputs(gen, b, res, c, True)
            p["w_in"] = torch.randn(2 * h, c, device="cuda", generator=gen) * c ** -0.5
            p["dw_in"] = torch.randn(2 * h, 3, 3, device="cuda", generator=gen) * 0.3
            p["w_out"] = torch.randn(c, h, device="cuda", generator=gen) * h ** -0.5

            def fn(p=p):
                return smoke.kblock.block_tail_fwd(*smoke.tail_args(p))
            out[f"{tag} h={h}"] = dict(device_ms=smoke.device_ms(fn)[0],
                                       by_launch=bwd_times.stage_split(smoke, fn).get("by_launch"))
    return out


def serve_rate(root: Path) -> dict:
    """tools/port_serve_rate.py's line for this root."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve().parent
                                              / "port_serve_rate.py"), "--root", str(root)],
                         check=True, capture_output=True, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main() -> int:
    flags = {f: f in sys.argv for f in ("--serve-rate", "--odd-h")}
    sys.argv = [a for a in sys.argv if a not in flags]
    smoke = port_gram_times.load(__doc__)
    if smoke is None:
        return 1
    gen = smoke.torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for tag, b, shapes in (("serve", 1, smoke.MAIN_SHAPES),
                           ("train", smoke.TRAIN_B, smoke.TRAIN_SHAPES)):
        for label, res, c, heads in shapes:
            row = smoke.kernel_timings(gen, label, res, c, heads, b, NAMES)
            p = smoke.block_inputs(gen, b, res, c, True)
            row["block_tail"]["stage_split"] = bwd_times.stage_split(
                smoke, lambda: smoke.kblock.block_tail_fwd(*smoke.tail_args(p)))
            row["block_head"]["stage_split"] = bwd_times.stage_split(
                smoke, lambda: smoke.kblock.block_head_fwd(*smoke.head_args(p)))
            for name, floors in design_floors(b, res, c).items():
                row[name].update(floors)
            rows[f"{tag} {label}"] = row
            print(json.dumps({"shape": f"{tag} {label}", **row}), flush=True)
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "tf32x3_products_ms",
            "workspace_passes_ms")

    def summed(tag, name):
        return {k: sum(n * rows[f"{tag} {label}"][name][k]
                       for label, n in smoke.BLOCKS_PER_FORWARD.items()) for k in keys}
    serve = {name: summed("serve", name) for name in NAMES}
    train = {name: summed("train", name) for name in NAMES}
    print(json.dumps({
        "per_serving_forward": {**serve, "both": {k: serve["block_tail"][k]
                                                  + serve["block_head"][k] for k in keys}},
        "per_train_iteration": {"tail": train["block_tail"],
                                "full": {k: train["block_tail"][k] + train["block_head"][k]
                                         for k in keys}}}), flush=True)
    if flags["--odd-h"]:
        print(json.dumps({"odd_h_cost": odd_h_cost(smoke)}), flush=True)
    if flags["--serve-rate"]:
        print(json.dumps({"serve_rate": serve_rate(smoke.root)}), flush=True)
    print(json.dumps({"root": str(smoke.root), "card": smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
