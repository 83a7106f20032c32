"""Times the bf16 kernels of an rcot_torch tree on one CUDA card: rows 1-4
in bf16 (serving's: block_head_bf16, block_tail_bf16, mdta_gram_fwd_bf16,
attn_apply_fwd_bf16) at every block shape of the serving path (256^2,
B = 1), and bf16 training's forms of rows 8 (qkv) forward and 9 (qkv), 5
(tail), 6 and 7 backward (conv1x1_dw_bf16, conv1x1_dw_bwd_bf16,
block_tail_bwd_bf16, mdta_gram_bwd_bf16, attn_apply_bwd_bf16) and of rows 5
(head) backward and 8-9 (GDFN) forward and backward (block_head_bwd_bf16,
gdfn_fused_bf16, gdfn_fused_bwd_bf16) at every block shape of the training
path (128^2, B = 3); and rows 10 and 11 in bf16 (mdta_attend_bf16;
dwconv3x3_bf16 at 2h and 3C, dwconv3x3_dx_bf16 and dwconv3x3_dtaps_bf16 at
3C) at every serving and training shape, where the tree has them.

    python tools/port_bf16_times.py [--root DIR] [--redesigned]

As tools/port_gram_times.py does: rcot_torch and its kernels are DIR's
(default: this checkout), timed with this checkout's
chip_smoke.bf16_timings and bf16_train_timings (`ms`, `device_ms`, the
bound at bf16 bytes and the bf16 tensor-core rate for products of two bf16
operands, a product of a bf16 and an fp32 operand as two TF32 terms at the
TF32 rate (chip_smoke.bf16_bwd_work, bf16_gram_yardstick), the fp32 rate
for the rest, the plain
bf16 twin, `bmm` on bf16 heads for rows 3-4 and 6-7). At serve L1, decoder
L1 and the latent each call of rows 1-4 is then split by launch in bf16 and
in fp32 on the same inputs (tools/port_block_bwd_times.py stage_split:
`by_launch` lists each launch's kernel and device ms), and at train L1,
decoder L1 and the latent each call of the training forms the same way, in
turns with their fp32 forms (fp32, bf16, bf16, fp32). Rows 10-11 in bf16
are timed with chip_smoke.bf16_opt_in_timings (the library call a bf16
F.conv2d(groups=C) and cuDNN's bf16 weight gradient) and each in turns with
its fp32 form on the widened values (device ms, fp32, bf16, bf16, fp32).
Last come the sums per serving forward and per bf16 training iteration
(chip_smoke.BLOCKS_PER_FORWARD, device ms; rows 10-11 per bf16
off/mdta/dwconv forward and tail/mdta/dwconv iteration) and the root and
the card's name and power limit.

With --redesigned it times only the bf16 forms that their latest Hopper
redesign replaced (REDESIGNED: row 1's head forward, block_head_bf16, at
serve L1 and serve decoder L1, B = 1, and row 8's qkv forward,
conv1x1_dw_bf16, at train L1 and decoder L1, B = 3): device ms, event ms,
the kernels one call puts on the card and the bytes it allocates at its
peak, with chip_smoke.bf16_fwd_work's bound (no library call computes
them), on seeded inputs, one JSON line. chip_smoke.py --root
runs it on the parent and on this tree in turns (parent, this, this,
parent).
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
    fp32 = {"qkv": smoke.fused_args(p32, False), "gdfn": smoke.fused_args(p32, True),
            "head": smoke.head_args(p32), "tail": smoke.tail_args(p32)}
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
               "attn_apply_bwd_bf16": lambda: kg.attn_apply_bwd(qkv32, attn, g_c),
               "block_head_bwd_bf16": lambda: kb.block_head_bwd(*fp32["head"], g_m),
               "gdfn_fused_bf16": lambda: kf.fused_dwconv_fwd(*fp32["gdfn"]),
               "gdfn_fused_bwd_bf16": lambda: kf.fused_dwconv_bwd(*fp32["gdfn"], g_c)}
    out: dict = {}
    for name in smoke.BF16_TRAIN_KERNELS:
        for i, tag in enumerate(("fp32", "bf16", "bf16", "fp32")):
            fn = calls16[name][0] if tag == "bf16" else calls32[name]
            out[f"{name} {tag} {1 + i // 2}"] = bwd_times.stage_split(smoke, fn)
    return out


# rows 10-11 in bf16: key -> (name in bf16_opt_in_calls, width: "3C" or "2h")
OPT_IN_ROWS = {"mdta_attend_bf16": ("mdta_attend_bf16", None),
               "dwconv3x3_bf16": ("dwconv3x3_bf16", "2h"),
               "dwconv3x3_bf16_qkv": ("dwconv3x3_bf16", "3C"),
               "dwconv3x3_dx_bf16": ("dwconv3x3_dx_bf16", "3C"),
               "dwconv3x3_dtaps_bf16": ("dwconv3x3_dtaps_bf16", "3C")}
# the rows one block runs in bf16 off/mdta/dwconv serving and in bf16
# tail/mdta/dwconv training
SERVE_OPT_IN = ("mdta_attend_bf16", "dwconv3x3_bf16", "dwconv3x3_bf16_qkv")
TRAIN_OPT_IN = ("mdta_attend_bf16", "dwconv3x3_bf16_qkv", "dwconv3x3_dx_bf16",
                "dwconv3x3_dtaps_bf16")


def opt_in_turns(smoke, gen, res, c, heads, b) -> dict:
    """Rows 10-11 in bf16 and their fp32 forms on the same values widened,
    device ms in turns fp32, bf16, bf16, fp32."""
    kdw, kmdta = smoke.kdw, smoke.kmdta
    inputs = smoke.bf16_opt_in_inputs(gen, b, res, c, heads)
    calls = smoke.bf16_opt_in_calls(inputs)
    # the fp32 forms' inputs are widened here, outside the timed calls
    q, k, v = (t.float() for t in inputs["attend"][:3])
    temp = inputs["attend"][3]
    widths = {"3C": 3 * c, "2h": 2 * int(c * 2.66)}
    fp32 = {"mdta_attend_bf16": lambda: kmdta.mdta_attend_fwd(q, k, v, temp)}
    for key, (name, w) in OPT_IN_ROWS.items():
        if w is None:
            continue
        x, g, taps = inputs[widths[w]]
        x, g = x.float(), g.float()
        fp32[key] = {"dwconv3x3_bf16": lambda x=x, t=taps: kdw.dwconv3x3_fwd(x, t),
                     "dwconv3x3_dx_bf16": lambda g=g, t=taps: kdw.dwconv3x3_dx(g, t),
                     "dwconv3x3_dtaps_bf16": lambda x=x, g=g: kdw.dwconv3x3_dtaps(x, g)}[name]
    out = {}
    for key, (name, w) in OPT_IN_ROWS.items():
        bf16 = calls[(name, widths[w] if w else None)][0]
        for i, tag in enumerate(("fp32", "bf16", "bf16", "fp32")):
            out[f"{key} {tag} {1 + i // 2}"] = smoke.device_ms(
                fp32[key] if tag == "fp32" else bf16)[0]
    return out


def opt_in(smoke, gen) -> dict:
    """Rows 10-11 in bf16 at every serving (B = 1) and training (B = 3)
    shape: their timings and their turns with the fp32 forms, printed a
    line a shape; -> the device ms per bf16 off/mdta/dwconv forward and per
    tail/mdta/dwconv iteration."""
    sums = {"device_ms_per_bf16_off_mdta_dwconv_forward": {},
            "device_ms_per_bf16_tail_mdta_dwconv_iteration": {}}
    for tag, shapes, b, keys, total in (
            ("serve", smoke.MAIN_SHAPES, 1, SERVE_OPT_IN,
             "device_ms_per_bf16_off_mdta_dwconv_forward"),
            ("train", smoke.TRAIN_SHAPES, smoke.TRAIN_B, TRAIN_OPT_IN,
             "device_ms_per_bf16_tail_mdta_dwconv_iteration")):
        for label, res, c, heads in shapes:
            rows = smoke.bf16_opt_in_timings(gen, label, res, c, heads, b)
            turns = opt_in_turns(smoke, gen, res, c, heads, b)
            for key in keys:
                sums[total][key] = (sums[total].get(key, 0.0)
                                    + smoke.BLOCKS_PER_FORWARD[label] * rows[key]["device_ms"])
            print(json.dumps({"shape": f"{tag} {label} bf16 opt-in", **rows, "turns": turns}),
                  flush=True)
    return sums


# the forms the redesign replaced, by the path and the levels they are timed
# at: row 1's head forward in serving (B = 1), row 8's qkv forward in
# training (B = 3)
REDESIGNED = {"serve": ("block_head_bf16",), "train": ("conv1x1_dw_bf16",)}
REDESIGNED_AT = ("L1", "decoder_level1")


def redesigned(smoke) -> dict:
    """{"<form> <path> <level>": {device_ms, device_records (kernels a
    call), ms, peak_bytes (what a call allocates at its peak: the output
    and the workspaces), bound_ms, bound_by, library_device_ms}} of the
    bf16 forwards of row 1's head (serving, 256^2, B = 1) and row 8's qkv
    (training, 128^2, B = 3), on inputs seeded alike in every tree; the
    bound from chip_smoke.bf16_fwd_work, no library call (None)."""
    torch, kb, kf = smoke.torch, smoke.kblock, smoke.kfused
    gen = torch.Generator(device="cuda").manual_seed(19)
    out = {}
    for path, b, shapes in (("serve", 1, smoke.MAIN_SHAPES),
                            ("train", smoke.TRAIN_B, smoke.TRAIN_SHAPES)):
        for label, res, c, heads in shapes:
            if label not in REDESIGNED_AT:
                continue
            p = smoke.bf16_block_inputs(smoke.block_inputs(gen, b, res, c, True))
            head, qkv = smoke.head_args(p), smoke.fused_args(p, False)
            for name in REDESIGNED[path]:
                fn = ((lambda: kb.block_head(*head)) if name == "block_head_bf16" else
                      (lambda: kf.fused_dwconv_fwd(*qkv)))
                flops, nbytes = smoke.bf16_fwd_work(b, res * res, c)[name]
                bound_ms, by = smoke.bound_at(flops, nbytes)
                dev, records = smoke.device_ms(fn)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                out[f"{name} {path} {label}"] = dict(
                    device_ms=dev, device_records=records, ms=smoke.cuda_ms(fn),
                    peak_bytes=torch.cuda.max_memory_allocated() - base,
                    bound_ms=bound_ms, bound_by=by, library_device_ms=None)
    return out


def main() -> int:
    only = "--redesigned" in sys.argv
    sys.argv = [a for a in sys.argv if a != "--redesigned"]
    smoke = port_gram_times.load(__doc__)
    if smoke is None:
        return 1
    if only:
        print(json.dumps({"redesigned": redesigned(smoke), "root": str(smoke.root),
                          "card": smoke.card_line()}))
        return 0
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
    sums = opt_in(smoke, gen) if hasattr(smoke.kmdta, "mdta_route") else {}
    print(json.dumps({"device_ms_per_serving_forward": per_forward,
                      "device_ms_per_bf16_training_iteration": per_iteration, **sums}))
    print(json.dumps({"root": str(smoke.root), "card": smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
