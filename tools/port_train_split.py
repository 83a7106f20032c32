"""Splits one training iteration of an rcot_torch tree on one CUDA card by
the kernels it puts on the card: a full-width state in tail/mdta/dwconv
(cli.train --attention-core mdta --depthwise dwconv's path) at 128^2,
B = 3, on chip_smoke's seeded batches, in fp32 and in bf16 (the same
batches rounded, as cli.train --dtype bfloat16 makes them).

    python tools/port_train_split.py [--root DIR]

As tools/port_gram_times.py does: rcot_torch and its kernels are DIR's
(default: this checkout). After two warm-up iterations of each, the
iterations/s are taken on the host clock in turns (fp32, bf16, bf16,
fp32), then PROFILED iterations of each run under torch.profiler
(CUDA activity), and each device record (annotated ranges, such as the
optimizer's step, left out) is put in one group: the port's
own kernels (a __global__ function of rcot_torch/csrc), cuBLAS/CUTLASS
products, cuDNN convolutions, PyTorch's elementwise kernels (casts
among them), its reductions, copies and memsets, the rest. Prints one
JSON line per dtype (host ms and device ms per iteration, the card's idle
share 1 - device / host, each group's device ms and launches per
iteration, the heaviest kernel names), then one with the bf16 - fp32
difference by group, and last the root and the card's name and power
limit.
"""

from __future__ import annotations

import functools
import json
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import port_gram_times  # noqa: E402

PROFILED = 3
GROUPS = (("cublas", ("gemm", "xmma", "cutlass", "sm90_", "cublas")),
          ("cudnn", ("cudnn", "conv", "implicit", "wgrad", "dgrad", "fprop")),
          ("elementwise", ("elementwise", "vectorized", "unrolled")),
          ("reduce", ("reduce",)),
          ("copy", ("memcpy", "memset", "copy")))


def port_kernels(root: Path) -> frozenset:
    """Names of the __global__ functions in root's rcot_torch/csrc."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    return frozenset(m for p in (root / "rcot_torch" / "csrc").glob("*.cu*")
                     for m in pat.findall(p.read_text()))


@functools.lru_cache(maxsize=None)
def group(name: str, ours: frozenset) -> str:
    if any(re.search(rf"\b{k}\b", name) for k in ours):
        return "port"
    low = name.lower()
    return next((g for g, keys in GROUPS if any(k in low for k in keys)), "other")


def split(smoke, state, iteration, batches, alphas, lr, n, ours) -> dict:
    """n iterations under torch.profiler: device ms and launches a group."""
    torch = smoke.torch
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            state, _ = iteration(state, batches[i % 3], alphas[i % 3], False, lr)
        torch.cuda.synchronize()
    groups: dict = {}
    names: dict = {}
    for e in prof.events():
        # a range a user annotated (the optimizer's step) spans kernels of
        # its own records: not a record of its own
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        us = e.time_range.elapsed_us()
        g = groups.setdefault(group(e.name, ours), [0.0, 0])
        g[0] += us
        g[1] += 1
        names[e.name] = names.get(e.name, 0.0) + us
    top = sorted(names.items(), key=lambda kv: -kv[1])[:15]
    return dict(state=state,
                device_ms=sum(g[0] for g in groups.values()) / n / 1e3,
                groups={k: {"device_ms": v[0] / n / 1e3, "launches": v[1] / n}
                        for k, v in sorted(groups.items(), key=lambda kv: -kv[1][0])},
                top=[{"name": k[:160], "device_ms": v / n / 1e3} for k, v in top])


def main() -> int:
    smoke = port_gram_times.load(__doc__)
    if smoke is None:
        return 1
    torch = smoke.torch
    cfg = smoke.Config(train=smoke.TrainConfig(dtype="bfloat16"))
    state = smoke.create_train_state(cfg, seed=0, device="cuda", **smoke.OPT_IN_TIERS)
    gen = torch.Generator(device="cuda").manual_seed(14)
    batches, alphas = smoke.train_inputs(gen, cfg)
    runs = {"fp32": (batches, alphas), "bf16": smoke.bf16_batches(batches, alphas)}
    iteration = smoke.make_train_iteration(cfg)
    lr = smoke.step_decay_lr(cfg.train.lr, 0, cfg.train.lr_step)
    for tag, (bs, als) in runs.items():
        for i in range(2):
            state, _ = iteration(state, bs[i], als[i], False, lr)
    host = {"fp32": [], "bf16": []}
    for tag in ("fp32", "bf16", "bf16", "fp32"):
        bs, als = runs[tag]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(5):
            state, _ = iteration(state, bs[i % 3], als[i % 3], False, lr)
        torch.cuda.synchronize()
        host[tag].append((time.perf_counter() - t0) / 5 * 1e3)
    ours = port_kernels(smoke.root)
    out = {}
    for tag, (bs, als) in runs.items():
        res = split(smoke, state, iteration, bs, als, lr, PROFILED, ours)
        state = res.pop("state")
        host_ms = sum(host[tag]) / len(host[tag])
        out[tag] = res
        print(json.dumps({"dtype": tag, "composition": "tail/mdta/dwconv",
                          "host_ms_per_iteration": host_ms, "host_ms_runs": host[tag],
                          "idle_share": 1 - res["device_ms"] / host_ms, **res}), flush=True)
    diff = {g: out["bf16"]["groups"].get(g, {"device_ms": 0.0})["device_ms"]
            - out["fp32"]["groups"].get(g, {"device_ms": 0.0})["device_ms"]
            for g in out["bf16"]["groups"].keys() | out["fp32"]["groups"].keys()}
    print(json.dumps({"bf16_minus_fp32_device_ms": diff}))
    print(json.dumps({"root": str(smoke.root), "card": smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
