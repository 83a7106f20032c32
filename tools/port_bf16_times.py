"""Times rows 1-4 in bf16 (serving's bf16 kernels: block_head_bf16,
block_tail_bf16, mdta_gram_fwd_bf16, attn_apply_fwd_bf16) of an rcot_torch
tree on one CUDA card, at every block shape of the serving path (256^2,
B = 1).

    python tools/port_bf16_times.py [--root DIR]

As tools/port_gram_times.py does: rcot_torch and its kernels are DIR's
(default: this checkout), timed with this checkout's chip_smoke.bf16_timings
(`ms`, `device_ms`, the bound at bf16 bytes and the bf16 tensor-core rate,
the plain bf16 twin, `bmm` on bf16 heads for rows 3-4). At serve L1,
decoder L1 and the latent each call of the four kernels is then split by
launch in bf16 and in fp32 on the same inputs (tools/port_block_bwd_times.py
stage_split: `by_launch` lists each launch's kernel and device ms). Last
come the sums per serving forward (chip_smoke.BLOCKS_PER_FORWARD, device
ms) and the root and the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import port_block_bwd_times as bwd_times  # noqa: E402
import port_gram_times  # noqa: E402

SPLIT_AT = ("L1", "decoder_level1", "latent")


def split(smoke, gen, label, res, c, heads) -> dict:
    """Each of rows 1-4 in fp32 and in bf16 at one shape, split by launch."""
    torch, kb, kg = smoke.torch, smoke.kblock, smoke.kgram
    p32 = smoke.block_inputs(gen, 1, res, c, True)
    ch = c // heads
    attn = torch.softmax(torch.randn(1, heads, ch, ch, device="cuda", generator=gen), -1)
    out = {}
    for tag, p in (("fp32", p32), ("bf16", smoke.bf16_block_inputs(p32))):
        qkv = kb.block_head(*smoke.head_args(p))
        for name, fn in (("block_head", lambda: kb.block_head(*smoke.head_args(p))),
                         ("block_tail", lambda: kb.block_tail(*smoke.tail_args(p))),
                         ("mdta_gram_fwd", lambda: kg.mdta_gram_fwd(qkv, heads)),
                         ("attn_apply_fwd", lambda: kg.attn_apply_fwd(qkv, attn))):
            out[f"{name} {tag}"] = bwd_times.stage_split(smoke, fn)
    return out


def main() -> int:
    smoke = port_gram_times.load(__doc__)
    if smoke is None:
        return 1
    gen = smoke.torch.Generator(device="cuda").manual_seed(0)
    per_forward: dict = {}
    for label, res, c, heads in smoke.MAIN_SHAPES:
        rows = smoke.bf16_timings(gen, label, res, c, heads, 1)
        for name, row in rows.items():
            per_forward[name] = (per_forward.get(name, 0.0)
                                 + smoke.BLOCKS_PER_FORWARD[label] * row["device_ms"])
        print(json.dumps({"shape": f"serve {label}", **rows}), flush=True)
        if label in SPLIT_AT:
            print(json.dumps({"split": f"serve {label}",
                              **split(smoke, gen, label, res, c, heads)}), flush=True)
    print(json.dumps({"device_ms_per_serving_forward": per_forward}))
    print(json.dumps({"root": str(smoke.root), "card": smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
