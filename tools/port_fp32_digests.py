"""SHA-256 digests of the fp32 kernels' outputs of an rcot_torch tree on
one CUDA card: rows 1-2 (tools/port_block_fwd_times.py), 3-4 and 6-7
(port_gram_times.py), 5 (port_block_bwd_times.py) and 8-9
(port_fused_times.py), each tool's `digests` alone, without its timings;
rows 10-11 (the fused attend, the depthwise forward, dx and dtaps); the
bf16 forms of rows 1-4 (rows 1-2 share row 11's depthwise template, rows
3-4 at a head of 192 channels tc.cuh's slot sum) and of bf16 training's
rows 5-9 (`opt_in_and_bf16`); and bf16 serving's outputs in every
composition of the fused tier, a full-width T_net from a seed at 128^2
(`bf16_serving`); and rows 3-4, 6 and 7 on a bf16 qkv at odd widths, a
ragged pixel count, the main path's heads and two channel blocks, rows 6
and 7 in both operand policies, and row 7 in both at train L1 and decoder
L1 (`bf16_mdta_edges`); and rows 5 (tail and head) and 9 (qkv and GDFN)
in bf16 in both operand policies at train L1 and the latent, and at odd
shapes with a cotangent 2 bytes off, with the bf16 forwards of rows 2
(tail) and 8 (GDFN) at those shapes (`bf16_tile_edges`).

    python tools/port_fp32_digests.py [--root DIR]

rcot_torch and its kernels are DIR's (default: this checkout). Two trees
whose digests agree computed the same bits. Prints one JSON line with the
root and the card's name and power limit.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import port_block_bwd_times  # noqa: E402
import port_block_fwd_times  # noqa: E402
import port_fused_times  # noqa: E402
import port_gram_times  # noqa: E402


def _hash(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().float().numpy().tobytes())
    return h.hexdigest()


def opt_in_and_bf16(smoke) -> dict:
    """SHA-256 of rows 10-11's fp32 outputs at every training shape (B = 3)
    and of rows 1-2's bf16 outputs at every serving shape (B = 1), seeded."""
    torch, kdw, kmdta = smoke.torch, smoke.kdw, smoke.kmdta
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for label, res, c, heads in smoke.TRAIN_SHAPES:
        b = smoke.TRAIN_B

        def r(*shape):
            return torch.randn(*shape, device="cuda", generator=gen)
        q, k, v = (r(b, heads, c // heads, res * res) for _ in range(3))
        temp = torch.rand(heads, 1, 1, device="cuda", generator=gen) + 0.5
        x, g, taps = r(b, res, res, 3 * c), r(b, res, res, 3 * c), r(3 * c, 3, 3)
        out[f"rows 10-11 fp32 train {label}"] = _hash(
            kmdta.mdta_attend_fwd(q, k, v, temp), kdw.dwconv3x3_fwd(x, taps),
            kdw.dwconv3x3_dx(g, taps), kdw.dwconv3x3_dtaps(x, g))
    for label, res, c, _ in smoke.MAIN_SHAPES:
        p = smoke.bf16_block_inputs(smoke.block_inputs(gen, 1, res, c, True))
        out[f"rows 1-2 bf16 serve {label}"] = _hash(
            smoke.kblock.block_head(*smoke.head_args(p)),
            smoke.kblock.block_tail(*smoke.tail_args(p)))
    qkv = torch.randn(1, 64, 64, 3 * 192, device="cuda", generator=gen).to(torch.bfloat16)
    attn = torch.softmax(torch.randn(1, 1, 192, 192, device="cuda", generator=gen), -1)
    out["rows 3-4 bf16 one head of 192"] = _hash(*smoke.kgram.mdta_gram_fwd(qkv, 1),
                                                 smoke.kgram.attn_apply_fwd(qkv, attn))

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    for label, res, c, heads in smoke.TRAIN_SHAPES:
        if label not in ("L1", "latent"):
            continue
        p = smoke.bf16_block_inputs(smoke.block_inputs(gen, smoke.TRAIN_B, res, c, True))
        qkv = smoke.kblock.block_head(*smoke.head_args(p))
        calls = {**smoke.bf16_block_calls(p, r), **smoke.bf16_mdta_calls(qkv, heads, r)}
        for name in sorted(calls):
            out[f"{name} train {label}"] = _hash(*(t for t in calls[name][0]() if t is not None))
        # rows 5 and 9 in bf16 with bf16 operands in their products
        b16 = smoke.b16ops_calls(p, qkv, heads, r)
        for name in ("block_tail_bwd_bf16_b16ops", "conv1x1_dw_bwd_bf16_b16ops",
                     "block_head_bwd_bf16_b16ops", "gdfn_fused_bwd_bf16_b16ops"):
            out[f"{name} train {label}"] = _hash(*(t for t in b16[name][0]() if t is not None))
    out.update(bf16_mdta_edges(smoke, r))
    out.update(bf16_tile_edges(smoke, gen, r))
    return out


# (b, h, w, c): bf16 training's row 5 and row 9 backwards, both
# configurations each, also at C = 6 (h = 15), odd shapes, the latent's and
# C = 576 (the LayerNorm's wide path), each with a cotangent 2 bytes off its
# allocation
BF16_TILE_EDGES = [(1, 20, 19, 6), (2, 12, 13, 192), (1, 9, 33, 384), (1, 8, 9, 576)]


def bf16_tile_edges(smoke, gen, r) -> dict:
    """SHA-256 of rows 5 (tail, head) and 9 (qkv, GDFN) backward in bf16,
    both operand policies, at BF16_TILE_EDGES, the cotangent 2 bytes off,
    and of the bf16 forwards of rows 2 (tail) and 8 (GDFN) there (h = 15,
    510, 1,021 and 1,532: odd and even gate widths, ragged tiles)."""
    torch, bf16 = smoke.torch, smoke.torch.bfloat16
    out = {}

    def off(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        return buf[1:].view_as(t).copy_(t)
    for b, h, w, c in BF16_TILE_EDGES:
        p = smoke.bf16_block_inputs(smoke.block_inputs(gen, b, h, c, True, w))
        g_c, g_m = off(r(b, h, w, c).to(bf16)), off(r(b, h, w, 3 * c).to(bf16))
        for ops in (False, True):
            got = (*smoke.kblock.block_tail_bwd(*smoke.tail_args(p), g_c, bf16_ops=ops),
                   *smoke.kfused.fused_dwconv_bwd(*smoke.fused_args(p, False), g_m,
                                                  bf16_ops=ops)[:3])
            out[f"rows 5 tail, 9 qkv bf16{'_b16ops' if ops else ''} {(b, h, w, c)}"] = _hash(
                *(t for t in got if t is not None))
            got = (*smoke.kblock.block_head_bwd(*smoke.head_args(p), g_m, bf16_ops=ops),
                   *smoke.kfused.fused_dwconv_bwd(*smoke.fused_args(p, True), g_c,
                                                  bf16_ops=ops))
            out[f"rows 5 head, 9 GDFN bf16{'_b16ops' if ops else ''} {(b, h, w, c)}"] = _hash(
                *(t for t in got if t is not None))
        out[f"rows 2 tail, 8 GDFN bf16 forwards {(b, h, w, c)}"] = _hash(
            smoke.kblock.block_tail(*smoke.tail_args(p)),
            smoke.kfused.fused_dwconv_fwd(*smoke.fused_args(p, True)))
    return out


# (b, h, w, heads, ch): the bf16 MDTA kernels' copy widths (25: 2-byte, 26:
# 4-byte), a ragged pixel count, the main path's heads, two channel blocks
BF16_MDTA_EDGES = [(2, 9, 13, 3, 25), (2, 17, 19, 2, 26), (1, 250, 321, 1, 48),
                   (3, 64, 64, 1, 96), (1, 64, 64, 1, 192)]
# row 7 in bf16 also at train L1 and decoder L1 (128^2, B = 3)
BF16_APPLY_BWD_SHAPES = [(3, 128, 128, 1, 48), (3, 128, 128, 1, 96)]


def bf16_mdta_edges(smoke, r) -> dict:
    """SHA-256 of rows 3-4, 6 and 7 on a bf16 qkv (the backward forms in
    both operand policies) at BF16_MDTA_EDGES, and of row 7 in both at
    BF16_APPLY_BWD_SHAPES."""
    kg, bf16 = smoke.kgram, smoke.torch.bfloat16
    out = {}
    for b, h, w, heads, ch in BF16_MDTA_EDGES:
        qkv = r(b, h, w, 3 * heads * ch).to(bf16)
        attn = smoke.torch.softmax(r(b, heads, ch, ch), -1)
        cot = [r(b, heads, ch, ch), r(b, heads, ch), r(b, heads, ch)]
        out[f"rows 3-4, 6 bf16 {(b, h, w, heads, ch)}"] = _hash(
            *kg.mdta_gram_fwd(qkv, heads), kg.attn_apply_fwd(qkv, attn),
            kg.mdta_gram_bwd(qkv, *cot, heads), kg.mdta_gram_bwd(qkv, *cot, heads, bf16_ops=True))
    for b, h, w, heads, ch in BF16_MDTA_EDGES + BF16_APPLY_BWD_SHAPES:
        qkv = r(b, h, w, 3 * heads * ch).to(bf16)
        attn = smoke.torch.softmax(r(b, heads, ch, ch), -1)
        g = r(b, h, w, heads * ch).to(bf16)
        out[f"row 7 bf16 {(b, h, w, heads, ch)}"] = _hash(
            *kg.attn_apply_bwd(qkv, attn, g), *kg.attn_apply_bwd(qkv, attn, g, bf16_ops=True))
    return out


def bf16_serving(smoke) -> dict:
    """SHA-256 of ModelConfig()'s bf16 forward (seed 0) of one seeded 128^2
    image through make_restorer in each composition, Gram core, fused tier."""
    np, torch = smoke.np, smoke.torch
    net = smoke.TNet(smoke.ModelConfig(), device="cuda", seed=0).eval()
    img = np.random.default_rng(7).uniform(0, 1, (128, 128, 3)).astype(np.float32)
    out = {}
    for mode in smoke.COMPOSITIONS:
        r = smoke.make_restorer(net, smoke.ModelConfig(), device="cuda", dtype=torch.bfloat16,
                                composition=mode)
        out[mode] = hashlib.sha256(r(img).tobytes()).hexdigest()
    return out


def main() -> int:
    smoke = port_gram_times.load(__doc__)
    if smoke is None:
        return 1
    out = {name: mod.digests(smoke) for name, mod in (
        ("block_fwd", port_block_fwd_times), ("gram", port_gram_times),
        ("block_bwd", port_block_bwd_times), ("fused", port_fused_times))}
    out["opt_in_and_bf16"] = opt_in_and_bf16(smoke)
    out["bf16_serving"] = bf16_serving(smoke)
    print(json.dumps({"root": str(smoke.root), "card": smoke.card_line(), "digests": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
