"""Times the fused block backward (row 5: block_tail_bwd and block_head_bwd)
of an rcot_torch tree on one CUDA card, at every block shape of the
training path (128^2, B = 3).

    python tools/port_block_bwd_times.py [--root DIR] [--iterations] [--digest]

As tools/port_gram_times.py does: rcot_torch and its kernels are DIR's
(default: this checkout), timed with this checkout's
chip_smoke.kernel_timings (`ms`, `device_ms`, the bound, the plain twin),
with two floors of the redesigned kernels beside (design_floors).
Beside each shape it prints the device time of one call split into
stages by the kernel names torch.profiler records (`stage_split`: the 1x1
products, the reduces of their pixel sums, the depthwise stencils, the
LayerNorm, the gate, memsets and copies), then both configurations' sums
over one training iteration (94 blocks, chip_smoke.BLOCKS_PER_FORWARD): a
"tail" iteration runs 94 tail backwards, a "full" one 94 of each. With
--iterations it also times full-width minimax iterations/s in "tail" and
"full" in turns (chip_smoke.timed_in_turns), as context. With --digest it
first prints a SHA-256 of both configurations' outputs on seeded inputs at
every training shape, WithBias and BiasFree: two trees whose digests agree
computed the same bits. Last come the root and the card's name and power
limit. To hold two trees against each
other, run them in turns in one call (A, B, B, A).
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import port_gram_times  # noqa: E402

NAMES = ["block_tail_bwd", "block_head_bwd"]
# the stage of a device record, by the first of these that its name holds
STAGES = (("reduce", "reduce"), ("sum_parts", "reduce"), ("gemm", "products"),
          ("mm_kernel", "products"), ("dw3x3", "stencils"), ("ddw", "stencils"),
          ("dwconv", "stencils"), ("ln_", "layernorm"), ("gate", "gate"),
          ("Memset", "memsets and copies"), ("Memcpy", "memsets and copies"),
          # the earlier CUDA-core block forward (rows 1-2) and rows 8-9, in an
          # older tree
          ("tail_proj", "products"), ("head_kernel", "fused halo"),
          ("tail_gdfn", "fused halo"), ("conv1x1_dw_kernel", "fused halo"),
          ("gdfn_kernel", "fused halo"))
SPLIT_CALLS = 10
TF32X3_FLOPS = 495e12 / 3  # H100 SXM: TF32 on the tensor cores, three products each


def design_floors(b: int, res: int, c: int) -> dict:
    """Two floors of the redesigned kernels at one shape, in ms, beside
    chip_smoke's bound (fp32 CUDA cores): their 1x1 products at the 3xTF32
    rate, and the bytes that their own launches move through device memory
    (each launch reading its inputs and writing its outputs once: in units
    of N floats, the tail's 24 h wide and 19 C narrow, the head's 7 M wide
    with M = 3C and 8 C narrow) at 3.35 TB/s."""
    n, hid, m = b * res * res, int(c * 2.66), 3 * c
    floats = {"block_tail_bwd": n * (24 * hid + 19 * c), "block_head_bwd": n * (7 * m + 8 * c)}
    flops = {"block_tail_bwd": 2 * n * (3 * c * c + 8 * hid * c),
             "block_head_bwd": 2 * n * 3 * m * c}
    return {k: {"tf32x3_products_ms": flops[k] / TF32X3_FLOPS * 1e3,
                "workspace_passes_ms": 4 * floats[k] / 3.35e12 * 1e3} for k in floats}


def stage_of(name: str) -> str:
    for key, stage in STAGES:
        if key in name:
            return stage
    return "other"


def short_name(name: str) -> str:
    """A kernel's name without its namespace and parameters."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].strip()


def stage_split(smoke, fn) -> dict:
    """Device ms of one call of fn by stage, device records per call and,
    where every call put the same records on the card, each record's name
    and ms in launch order (`by_launch`)."""
    torch = smoke.torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(SPLIT_CALLS):
            fn()
        torch.cuda.synchronize()
    split: dict = {}
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    for e in events:
        stage = stage_of(e.name)
        split[stage] = split.get(stage, 0.0) + e.time_range.elapsed_us() / 1e3 / SPLIT_CALLS
    out = dict(split, records_per_call=len(events) / SPLIT_CALLS)
    if events and len(events) % SPLIT_CALLS == 0:
        per = len(events) // SPLIT_CALLS
        out["by_launch"] = [[short_name(events[i].name),
                             sum(events[i + k * per].time_range.elapsed_us()
                                 for k in range(SPLIT_CALLS)) / 1e3 / SPLIT_CALLS]
                            for i in range(per)]
    return out


def digests(smoke) -> dict:
    """SHA-256 of row 5's outputs on seeded inputs, by shape and LN kind."""
    torch = smoke.torch
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, out = smoke.TRAIN_B, {}
    for label, res, c, _ in smoke.TRAIN_SHAPES:
        for ln_bias in (True, False):
            p = smoke.block_inputs(gen, b, res, c, ln_bias)
            g_head = torch.randn(b, res, res, 3 * c, device="cuda", generator=gen)
            g_c = torch.randn(b, res, res, c, device="cuda", generator=gen)
            got = (*smoke.kblock.block_tail_bwd(*smoke.tail_args(p), g_c),
                   *smoke.kblock.block_head_bwd(*smoke.head_args(p), g_head))
            h = hashlib.sha256()
            for t in got:
                if t is not None:
                    h.update(t.cpu().numpy().tobytes())
            out[f"{label} {'WithBias' if ln_bias else 'BiasFree'}"] = h.hexdigest()
    return out


def iterations(smoke) -> dict:
    """Full-width minimax iterations/s in "tail" and "full", in turns."""
    cfg = smoke.Config()
    state = smoke.create_train_state(cfg, seed=0, device="cuda")
    gen = smoke.torch.Generator(device="cuda").manual_seed(0)
    batches, alphas = smoke.train_inputs(gen, cfg)
    # one untimed iteration in each: cuDNN's and the allocator's first calls
    smoke.timed_in_turns(state, cfg, batches, alphas, {
        "tail": dict(composition="tail"), "full": dict(composition="full")}, n_timed=1)
    return smoke.timed_in_turns(state, cfg, batches, alphas, {
        "tail": dict(composition="tail"), "full": dict(composition="full")})


def main() -> int:
    flags = {f: f in sys.argv for f in ("--iterations", "--digest")}
    sys.argv = [a for a in sys.argv if a not in flags]
    smoke = port_gram_times.load(__doc__)
    if smoke is None:
        return 1
    if flags["--digest"]:
        print(json.dumps({"digests": digests(smoke)}), flush=True)
    gen = smoke.torch.Generator(device="cuda").manual_seed(0)
    b = smoke.TRAIN_B
    rows = {}
    for label, res, c, heads in smoke.TRAIN_SHAPES:
        row = smoke.kernel_timings(gen, label, res, c, heads, b, NAMES)
        p = smoke.block_inputs(gen, b, res, c, True)
        r = lambda *shape: smoke.torch.randn(*shape, device="cuda", generator=gen)  # noqa: E731
        g_head, g_c = r(b, res, res, 3 * c), r(b, res, res, c)
        row["block_tail_bwd"]["stage_split"] = stage_split(
            smoke, lambda: smoke.kblock.block_tail_bwd(*smoke.tail_args(p), g_c))
        row["block_head_bwd"]["stage_split"] = stage_split(
            smoke, lambda: smoke.kblock.block_head_bwd(*smoke.head_args(p), g_head))
        for name, floors in design_floors(b, res, c).items():
            row[name].update(floors)
        rows[label] = row
        print(json.dumps({"shape": f"train {label}", **row}), flush=True)
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "tf32x3_products_ms",
            "workspace_passes_ms")
    per = {name: {k: sum(n * rows[label][name][k]
                         for label, n in smoke.BLOCKS_PER_FORWARD.items()) for k in keys}
           for name in NAMES}
    full = {k: per["block_tail_bwd"][k] + per["block_head_bwd"][k] for k in keys}
    print(json.dumps({"per_train_iteration": {"tail": per["block_tail_bwd"], "full": full}}),
          flush=True)
    if flags["--iterations"]:
        print(json.dumps({"iterations_per_s_in_turns": iterations(smoke)}), flush=True)
    print(json.dumps({"root": str(smoke.root), "card": smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
