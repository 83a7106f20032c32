"""Times the bf16 kernels of an rcot_torch tree on one CUDA card: rows 1-4
in bf16 (serving's: block_head_bf16, block_tail_bf16, mdta_gram_fwd_bf16,
attn_apply_fwd_bf16) at every block shape of the serving path (256^2,
B = 1), and bf16 training's forms of rows 8 (qkv) forward and 9 (qkv), 5
(tail), 6 and 7 backward (conv1x1_dw_bf16, conv1x1_dw_bwd_bf16,
block_tail_bwd_bf16, mdta_gram_bwd_bf16, attn_apply_bwd_bf16) at every
block shape of the training path (128^2, B = 3).

    python tools/port_bf16_times.py [--root DIR]

As tools/port_gram_times.py does: rcot_torch and its kernels are DIR's
(default: this checkout), timed with this checkout's chip_smoke.bf16_timings
and bf16_train_timings (`ms`, `device_ms`, the bound at bf16 bytes and the
bf16 tensor-core rate for bf16 products, the fp32 rate for the rest, the
plain bf16 twin, `bmm` on bf16 heads for rows 3-4 and 6-7). At serve L1,
decoder L1 and the latent each call of rows 1-4 is then split by launch in
bf16 and in fp32 on the same inputs (tools/port_block_bwd_times.py
stage_split: `by_launch` lists each launch's kernel and device ms), and at
train L1, decoder L1 and the latent each call of the training forms the
same way, in turns with their fp32 forms (fp32, bf16, bf16, fp32). Last
come the sums per serving forward and per bf16 training iteration
(chip_smoke.BLOCKS_PER_FORWARD, device ms) and the root and the card's name
and power limit.
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


def split_train(smoke, gen, res, c, heads) -> dict:
    """Each bf16 training form and its fp32 form on the same inputs (the
    fp32 ones the bf16 values widened) at one training shape, split by
    launch, in turns fp32, bf16, bf16, fp32."""
    torch = smoke.torch
    p16 = smoke.bf16_block_inputs(smoke.block_inputs(gen, smoke.TRAIN_B, res, c, True))
    p32 = {k: None if v is None else v.float() for k, v in p16.items()}
    qkv16 = smoke.kblock.block_head(*smoke.head_args(p16))

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    calls16 = {**smoke.bf16_block_calls(p16, r), **smoke.bf16_mdta_calls(qkv16, heads, r)}
    fp32 = {"qkv": smoke.fused_args(p32, False), "tail": smoke.tail_args(p32)}
    b = smoke.TRAIN_B
    ch = c // heads
    g_m, g_c = r(b, res, res, 3 * c), r(b, res, res, c)
    cot = [r(b, heads, ch, ch), r(b, heads, ch), r(b, heads, ch)]
    attn = torch.softmax(r(b, heads, ch, ch), -1)
    qkv32 = qkv16.float()
    kf, kb, kg = smoke.kfused, smoke.kblock, smoke.kgram
    calls32 = {"conv1x1_dw_bf16": lambda: kf.fused_dwconv_fwd(*fp32["qkv"]),
               "conv1x1_dw_bwd_bf16": lambda: kf.fused_dwconv_bwd(*fp32["qkv"], g_m),
               "block_tail_bwd_bf16": lambda: kb.block_tail_bwd(*fp32["tail"], g_c),
               "mdta_gram_bwd_bf16": lambda: kg.mdta_gram_bwd(qkv32, *cot, heads),
               "attn_apply_bwd_bf16": lambda: kg.attn_apply_bwd(qkv32, attn, g_c)}
    out: dict = {}
    for name in smoke.BF16_TRAIN_KERNELS:
        for i, tag in enumerate(("fp32", "bf16", "bf16", "fp32")):
            fn = calls16[name][0] if tag == "bf16" else calls32[name]
            out[f"{name} {tag} {1 + i // 2}"] = bwd_times.stage_split(smoke, fn)
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
    per_iteration: dict = {}
    for label, res, c, heads in smoke.TRAIN_SHAPES:
        rows = smoke.bf16_train_timings(gen, label, res, c, heads, smoke.TRAIN_B)
        for name, row in rows.items():
            per_iteration[name] = (per_iteration.get(name, 0.0)
                                   + smoke.BLOCKS_PER_FORWARD[label] * row["device_ms"])
        print(json.dumps({"shape": f"train {label}", **rows}), flush=True)
        if label in SPLIT_AT:
            print(json.dumps({"split": f"train {label}",
                              **split_train(smoke, gen, res, c, heads)}), flush=True)
    print(json.dumps({"device_ms_per_serving_forward": per_forward,
                      "device_ms_per_bf16_training_iteration": per_iteration}))
    print(json.dumps({"root": str(smoke.root), "card": smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
