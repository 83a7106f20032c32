"""Where the time of the bf16 kernels goes, by subtraction, on one CUDA
card: the Gram forward (row 3), the apply forward (row 4), the Gram
backward (row 6, both operand policies) and the apply backward (row 7,
both operand policies), each on a bf16 qkv; bf16 training's backward
forms of rows 5 and 9, both operand policies: row 5's tail (`5`) and head
(`5h`), row 9's qkv (`9`) and GDFN (`9g`), on bf16 tiles, or, in a tree
that holds it (`--root`), the design that widened its bf16 operands in a
launch of its own and rounded its outputs in another (csrc/cast.cuh); and
the bf16 forwards of row 2's tail (`2`, block_tail_bf16), row 8's GDFN
(`8g`, gdfn_fused_bf16), row 1's head (`1`, block_head_bf16) and row 8's
qkv (`8q`, conv1x1_dw_bf16).

    python tools/port_bf16_ablate.py [--rows 3 4 6 7 5 5h 9 9g 2 8g 1 8q]
                                     [--variants full nostore ...] [--root DIR]

Copies the rcot_torch of DIR (default: this checkout) into
build/ablate_<variant>/ with only the sources the chosen rows need, cuts
one part of their kernels in the copy's csrc (or its plan in ops/gram.py):

  full      nothing cut;
  nostore   the stores of the results (the Gram forward's partials of G,
            nq and nk; the epilogues' stores of d[q|k], out and dv; the
            staging stays);
  nomma     the products (the fragment reads of the tf32 kernels go with
            them; the ldmatrix reads of the bf16 ones stay);
  noload    the copies of the q, k, v and g tiles (the ring keeps what it
            holds; dG and attn are still staged);
  nosquare  the Gram forward's sums of squares (row 3);
  noreduce  the Gram forward's second launch, the fixed-order reduce of its
            pixel ranges' partials (row 3; G is then wrong);
  deep      the Gram forward's ring eight stages deep (a 512-pixel range
            all in flight at ch <= 64; row 3);
  split2    the Gram forward's ranges planned for two blocks an SM (row 3;
            GRAM_BLOCKS_PER_SM = 2, so shorter ranges and twice the blocks);
  sqv1, sqw8, sqw0  the Gram forward's squares read one channel at a time,
            by eight warps of their own, or by the products' warps after
            their products (row 3; the same chains, the same bits);
  ring6     the apply backward's ring six stages deep up to R = 4, four at
            R = 5-6 (row 7; a whole range of six tiles in flight at train L1);
  sub1, slot128, slot256  the Gram forward's ring slots one stage each
            (not two), or 128 pixels each, or 256 up to R = 4 and 128
            above (row 3; the same sums);
  nowiden   the launch that widens the bf16 operands into fp32 workspaces
            (rows 5 and 9 in the widening design);
  nonarrow  the launch that rounds the fp32 results to the bf16 outputs
            (rows 5 and 9 in the widening design);
  noprod    the backward's 1x1 products and pixel sums with their
            fixed-order reduces (rows 5 and 9; the recompute's products
            stay); the forward's 1x1 products (rows 2 and 8g: the tail's
            three, the GDFN's two; rows 1 and 8q: the W_qkv or W_in
            product, in a launch of its own or in the product-depthwise,
            csrc/pw_dw.cu);
  noln      the head's LayerNorm launch (row 1);
  nostencil the product-depthwise's stencil and its stores (rows 1 and 8q
            in the design that has it);
  nostage   the product-depthwise's copies of x past its first steps: the
            ring keeps what it holds (rows 1 and 8q in that design);
  nogate    the forward's gate pass, which reads the fp32 conv and writes
            the bf16 gate (rows 2 and 8g in the design that has one);
  nogelu    the gated depthwise's gelu: the gate c1 c2 (rows 2 and 8g);
  noring    the gated depthwise's copies past its first three rows: the
            ring keeps what it holds (rows 2 and 8g);
  c2one     the gated depthwise's c2 half at odd h copied a bf16 at a time,
            loaded and stored by the threads, in place of its 4-byte copies
            from the column before it (the same elements to the same
            places; rows 2 and 8g in the design that takes the gate in its
            depthwise);
  lb1       the products on bf16 tiles of the tf32 path (mm.cuh) built
            for one block an SM, so that they take up to 255 registers
            and spill none (rows 5 and 9 on bf16 tiles);
  nob1      the products' single-bf16 copies (W_out's rows at odd h, which
            the threads load and store themselves) left unread (row 5's
            tail and row 9's GDFN on bf16 tiles, and the forwards of rows 2
            and 8g),

builds the copies at once, then times each in a process of its own, in
turns (full first and last): device ms a call (chip_smoke.device_ms) and
each launch's (tools/port_block_bwd_times.py stage_split), row 3 at serve
L1, serve decoder L1 and train L1, row 4 at serve L1, decoder L1 and L1 at
batch 8, rows 1 and 2 at serve L1 and serve decoder L1 (256^2, B = 1),
rows 5-7, 8g, 8q and 9 at train L1 and decoder L1 (128^2, B = 3). Rows 5
and 9's nowiden and nonarrow cuts are made in the design that widens and
rounds in launches of its own (`--root` on a checkout that holds it); a
tree without that design refuses them.
A cut
kernel computes nothing useful; only its time is read. A variant that cuts
nothing in a row's sources is not timed for it. Each line names its
variant; the last line the card's name and power limit. Not part of the
port: a measurement tool, whose copies live under build/ and are rebuilt
each run.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# the sources each row's kernels compile from
ROW_SOURCES = {"3": {"gram_bf16.cu"}, "4": {"gram_bf16.cu"},
               "6": {"gram_bwd_bf16.cu", "gram_bwd_bf16_b16ops.cu"},
               "7": {"apply_bwd_bf16.cu", "apply_bwd_bf16_b16ops.cu"},
               "5": {"block_bwd_bf16.cu", "dwconv.cu"},
               "5h": {"block_bwd_bf16.cu", "dwconv.cu"},
               "9": {"fused_dwconv_bf16.cu", "dwconv.cu"},
               "9g": {"fused_dwconv_bf16.cu", "dwconv.cu"},
               "2": {"block_fwd_bf16.cu", "dwconv.cu"},
               "8g": {"fused_dwconv_bf16.cu", "dwconv.cu"},
               "1": {"block_fwd_bf16.cu", "dwconv.cu", "pw_dw.cu"},
               "8q": {"fused_dwconv_bf16.cu", "dwconv.cu", "pw_dw.cu"}}
BF16_BWD = ("5", "5h", "9", "9g")
# the bf16 forwards of row 2's tail and row 8's GDFN, row 1's head and row
# 8's qkv, and their sources; the rows that run the product-depthwise
BF16_FWD = {("2", "1"): "csrc/block_fwd_bf16.cu", ("8g", "8q"): "csrc/fused_dwconv_bf16.cu"}
PW_DW = ("1", "8q")
# rows 5 and 9's cuts, the same text in either source
WIDENING = {("5", "5h"): "csrc/block_bwd_bf16.cu", ("9", "9g"): "csrc/fused_dwconv_bf16.cu"}
# variant -> [(rows, file under rcot_torch/, text, replacement)], rows a
# string of one-character rows or a tuple of rows; each text must be found
# where the rows it serves are built
CUTS = {
    "full": [],
    "nostore": [
        ("6", "csrc/gram_bwd.cuh", "      store_staged_v(out + off,",
         "      if (p0 < 0) store_staged_v(out + off,"),
        ("4", "csrc/gram_bf16.cu", "      store_staged_v(out + base,",
         "      if (p0 < 0) store_staged_v(out + base,"),
        ("3", "csrc/gram_bf16.cu", "      go[c * ch + d] = v;",
         "      if (s < 0) go[c * ch + d] = v;"),
        ("3", "csrc/gram_bf16.cu", "    (which ? nk_out + pj * cb : nq_out + pi * cb)[unit",
         "    if (s < 0) (which ? nk_out + pj * cb : nq_out + pi * cb)[unit"),
        ("7", "csrc/gram_bwd.cuh", "          store_staged_v(dv + off + jc,",
         "          if (p0 < 0) store_staged_v(dv + off + jc,")],
    "nomma": [
        ("67", "csrc/gram_bwd.cuh",
         "    if constexpr (OPS16)\n      mma_1xtf32(acc, ah, bh, use_m, use_n);\n"
         "    else\n      mma_3xtf32<MT, NJ, !F32>(acc, ah, al, bh, bl, use_m, use_n);",
         "    (void)ah; (void)al; (void)bh; (void)bl;"),
        ("7", "csrc/gram_bwd.cuh", "        mma_1xtf32(part, ar, br, use_m, use_n);",
         "        (void)ar; (void)br;"),
        ("4", "csrc/gram_bf16.cu",
         "        mma_bf16(acc[j], af, b0);\n        mma_bf16(acc[j + 1], af, b1);",
         "        (void)b0; (void)b1;"),
        ("3", "csrc/gram_bf16.cu",
         "          if (use_m[i] && use_n[j]) mma_bf16(part[i][j], af[i], bfr[j]);",
         "          (void)af; (void)bfr;")],
    "noload": [
        ("6", "csrc/gram_bwd.cuh", "      stage_rows_bf16_v(dst, LDA,",
         "      if (p0 < 0) stage_rows_bf16_v(dst, LDA,"),
        ("6", "csrc/gram_bwd.cuh", "      stage_rows_bf16_v(dst + TP * LDA,",
         "      if (p0 < 0) stage_rows_bf16_v(dst + TP * LDA,"),
        ("4", "csrc/gram_bf16.cu", "    stage_rows_bf16_v(ring + (i % STAGES) * TP * LD, LD,",
         "    if (t < 0) stage_rows_bf16_v(ring + (i % STAGES) * TP * LD, LD,"),
        ("3", "csrc/gram_bf16.cu", "    stage_rows_bf16<V>(dst, LD, q_rows,",
         "    if (p0 < 0) stage_rows_bf16<V>(dst, LD, q_rows,"),
        ("3", "csrc/gram_bf16.cu", "    stage_rows_bf16<V>(dst + SLOT * LD, LD, k_rows,",
         "    if (p0 < 0) stage_rows_bf16<V>(dst + SLOT * LD, LD, k_rows,"),
        ("7", "csrc/gram_bwd.cuh", "      stage_rows_bf16_v(dst, LDB, g_rows,",
         "      if (p0 < 0) stage_rows_bf16_v(dst, LDB, g_rows,"),
        ("7", "csrc/gram_bwd.cuh", "      stage_rows_bf16_v(dst + TP * LDB, LDB, v_rows,",
         "      if (p0 < 0) stage_rows_bf16_v(dst + TP * LDB, LDB, v_rows,")],
    "nosquare": [("3", "csrc/gram_bf16.cu", "        if (!sq_on[k]) continue;\n        float x[",
                  "        if (!sq_on[k] || t >= 0) continue;\n        float x[")],
    "ring6": [("7", "csrc/gram_bwd.cuh", "  static constexpr int STAGES = R <= 4 ? 4 : 3;\n  static constexpr int TILES = 2 * kBwdTP * LDB;  // bf16, one stage\n  static constexpr int DV",
               "  static constexpr int STAGES = R <= 4 ? 6 : R <= 6 ? 4 : 3;\n  static constexpr int TILES = 2 * kBwdTP * LDB;  // bf16, one stage\n  static constexpr int DV")],
    "sub1": [("3", "csrc/gram_bf16.cu", "static constexpr int SUB = 2;",
              "static constexpr int SUB = 1;")],
    "slot128": [("3", "csrc/gram_bf16.cu", "static constexpr int SUB = 2;",
                 "static constexpr int SUB = TP < 128 ? 128 / TP : 1;")],
    "slot256": [("3", "csrc/gram_bf16.cu", "static constexpr int SUB = 2;",
                 "static constexpr int SUB = R <= 4 ? 256 / TP : 128 / TP;")],
    "sqv1": [("3", "csrc/gram_bf16.cu", "static constexpr int SQV = SQW ? 2 : 1;",
              "static constexpr int SQV = 1;")],
    "sqw8": [("3", "csrc/gram_bf16.cu", "static constexpr int SQW = R <= 6 ? 4 : 0;",
              "static constexpr int SQW = R <= 6 ? 8 : 0;")],
    "sqw0": [("3", "csrc/gram_bf16.cu", "static constexpr int SQW = R <= 6 ? 4 : 0;",
              "static constexpr int SQW = 0;")],
    "noreduce": [("3", "csrc/gram_bf16.cu",
                  "  if (splits > 1) return launch_reduce(ws, gram, nq, nk,",
                  "  if (splits < 0) return launch_reduce(ws, gram, nq, nk,")],
    "deep": [("3", "csrc/gram_bf16.cu", "constexpr int kStagesBf = 3;",
              "constexpr int kStagesBf = 8;")],
    "split2": [("3", "ops/gram.py", "GRAM_BLOCKS_PER_SM = 1", "GRAM_BLOCKS_PER_SM = 2")],
    "nowiden": [(r, f, "  RCOT_TRY(up.run(st));", "  (void)up;") for r, f in WIDENING.items()],
    "nonarrow": [(r, f, "  return down.run(st);", "  (void)down;\n  return cudaSuccess;")
                 for r, f in WIDENING.items()],
    "noprod": [(r, f, old, "if (n < 0) " + old) for r, f in WIDENING.items()
               for old in ("RCOT_TRY((product<true, ", "RCOT_TRY(pixel_sum<OPS16>(")]
              + [(r, f, old, new) for r, f in BF16_FWD.items() for old, new in (
                  ("  RCOT_TRY((product<false, ", "  if (n < 0) RCOT_TRY((product<false, "),
                  ("  return product<false, ", "  return n >= 0 ? cudaSuccess : product<false, "))]
              + [(PW_DW, "csrc/pw_dw.cu", "    if (rin) row_sums<",
                  "    if (rin && n_in < 0) row_sums<")],
    "c2one": [(("2", "8g"), "csrc/dwconv.cu", old, new) for old, new in (
        ("      cp_async<V>(dst + s2[k], src + at + hid - d, in);",
         "      for (int e = 0; e < (MODE == kGateShift ? V : 0); ++e)\n"
         "        cp_async<1>(dst + s2[k] + e, src + at + hid - d + e, in);\n"
         "      if (MODE != kGateShift) cp_async<V>(dst + s2[k], src + at + hid - d, in);"),
        ("        cp_async<V>(dst + c2_at + col * ld2 + cw,\n"
         "                    src + (in ? gx * (int)pix + hid - d + c0 + cw : 0), in);",
         "        for (int e = 0; e < V; ++e)\n"
         "          cp_async<1>(dst + c2_at + col * ld2 + cw + e,\n"
         "                      src + (in ? gx * (int)pix + hid - d + c0 + cw + e : 0), in);"))],
    "nogelu": [(("2", "8g"), "csrc/dwconv.cu", f"c + e < hid ? gate_fwd(p{k}2[e], q{k}2[e]) : 0.f",
                f"c + e < hid ? p{k}2[e] * q{k}2[e] : 0.f") for k in "ab"],
    "noring": [(("2", "8g"), "csrc/dwconv.cu",
                "    if (r + kStages - 1 < n_in) stage(r + kStages - 1);\n    cp_commit();\n"
                "    const bf16* s = ring + (r % kStages) * slot;",
                "    cp_commit();\n    const bf16* s = ring + (r % kStages) * slot;")],
    "noln": [("1", "csrc/block_fwd_bf16.cu", "  RCOT_TRY(ln_fwd(x, ln_w, ln_b, u, stats, n, C,",
              "  if (n < 0) RCOT_TRY(ln_fwd(x, ln_w, ln_b, u, stats, n, C,")],
    "nostencil": [(PW_DW, "csrc/pw_dw.cu", "if (s >= 1 && st_on) {",
                   "if (s >= 1 && st_on && n_in < 0) {")],
    "nostage": [(PW_DW, "csrc/pw_dw.cu",
                 "if (s + stages - 1 < steps) stage_step(s + stages - 1, next);",
                 "if (s + stages - 1 < steps && n_in < 0) stage_step(s + stages - 1, next);")],
    "nogate": [(r, f, "  RCOT_TRY(gate_pass(conv, h, n, hid, plan[",
                "  if (n < 0) RCOT_TRY(gate_pass(conv, h, n, hid, plan[")
               for r, f in BF16_FWD.items()],
    "lb1": [(BF16_BWD, "csrc/mm.cuh", "__global__ void __launch_bounds__(kThreads, 2) mm_kernel(",
             "__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 && (sizeof(EA) == 2 || "
             "sizeof(EB) == 2 || sizeof(EO) == 2) ? 1 : 2) mm_kernel(")],
    "nob1": [((*BF16_BWD, "2", "8g"), "csrc/mm.cuh", "      *to = in ? *from : from_f<T>(0.f);",
              "      *to = from_f<T>(0.f);")],
}


def cuts(variant: str, rows) -> list:
    return [c for c in CUTS[variant] if set(c[0]) & set(rows)]


def make_tree(variant: str, rows, src: Path = HERE) -> Path:
    """build/ablate_<variant>/rcot_torch, src's with the rows' sources alone
    and the cut made."""
    root = HERE / "build" / f"ablate_{variant}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(src / "rcot_torch", root / "rcot_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    keep = set().union(*(ROW_SOURCES[r] for r in rows))
    for f in (root / "rcot_torch" / "csrc").glob("*.cu"):
        if f.name not in keep:
            f.unlink()
    for _, name, old, new in cuts(variant, rows):
        f = root / "rcot_torch" / name
        if not f.exists():  # a design without this source: nothing to cut there
            continue
        text = f.read_text()
        if old not in text:
            raise SystemExit(f"{variant}: {name} no longer holds {old!r}")
        f.write_text(text.replace(old, new))
    build = root / "rcot_torch" / "kernels" / "build.py"  # bind what the copy builds
    text = build.read_text()
    old = "        fn = getattr(lib, name)\n"
    build.write_text(text.replace(old, "        if not hasattr(lib, name):\n"
                                       "            continue\n" + old))
    return root


def time_tree(root: Path, rows) -> dict:
    """{"<form> <shape>": [device ms, each launch's [name, ms]]} of the rows'
    forms, imported from root."""
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(HERE / "tools"))
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import port_block_bwd_times as bwd_times
    torch, g, kb, kf = cs.torch, cs.kgram, cs.kblock, cs.kfused
    cs.build.library()
    gen = torch.Generator(device="cuda").manual_seed(3)

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    calls = {}
    if "3" in rows:
        for tag, b, res, ch in (("serve L1", 1, 256, 48), ("serve decoder L1", 1, 256, 96),
                                ("train L1", 3, 128, 48)):
            qkv = r(b, res, res, 3 * ch).to(torch.bfloat16)
            calls[f"mdta_gram_fwd_bf16 {tag}"] = lambda qkv=qkv: g.mdta_gram_fwd(qkv, 1)
    if "4" in rows:
        for tag, b, res, ch in (("serve L1", 1, 256, 48), ("serve decoder L1", 1, 256, 96),
                                ("serve L1 B=8", 8, 256, 48)):
            qkv = r(b, res, res, 3 * ch).to(torch.bfloat16)
            attn = torch.softmax(r(b, 1, ch, ch), -1)
            calls[f"attn_apply_fwd_bf16 {tag}"] = lambda q=qkv, a=attn: g.attn_apply_fwd(q, a)
    for tag, res, ch in (("serve L1", 256, 48), ("serve decoder L1", 256, 96)):
        if not {"1", "2"} & set(rows):
            break
        p = cs.bf16_block_inputs(cs.block_inputs(gen, 1, res, ch, True))
        if "1" in rows:
            calls[f"block_head_bf16 {tag}"] = lambda p=p: kb.block_head(*cs.head_args(p))
        if "2" in rows:
            calls[f"block_tail_bf16 {tag}"] = lambda p=p: kb.block_tail(*cs.tail_args(p))
    for tag, b, res, ch in (("train L1", 3, 128, 48), ("train decoder L1", 3, 128, 96)):
        qkv = r(b, res, res, 3 * ch).to(torch.bfloat16)
        cot = [r(b, 1, ch, ch), r(b, 1, ch), r(b, 1, ch)]
        attn, gc = torch.softmax(r(b, 1, ch, ch), -1), r(b, res, res, ch).to(torch.bfloat16)
        for ops in (False, True):
            sfx = "_b16ops" if ops else ""
            if "6" in rows:
                calls[f"mdta_gram_bwd_bf16{sfx} {tag}"] = (
                    lambda q=qkv, c=cot, o=ops: g.mdta_gram_bwd(q, *c, 1, bf16_ops=o))
            if "7" in rows:
                calls[f"attn_apply_bwd_bf16{sfx} {tag}"] = (
                    lambda q=qkv, a=attn, x=gc, o=ops: g.attn_apply_bwd(q, a, x, bf16_ops=o))
        if not {*BF16_BWD, "8g", "8q"} & set(rows):
            continue
        p = cs.bf16_block_inputs(cs.block_inputs(gen, b, res, ch, True))
        if "8q" in rows:
            calls[f"conv1x1_dw_bf16 {tag}"] = (
                lambda p=p: kf.fused_dwconv_fwd(*cs.fused_args(p, False)))
        if "8g" in rows:
            calls[f"gdfn_fused_bf16 {tag}"] = (
                lambda p=p: kf.fused_dwconv_fwd(*cs.fused_args(p, True)))
        g_m = r(b, res, res, 3 * ch).to(torch.bfloat16)
        for ops in (False, True):
            sfx = "_b16ops" if ops else ""
            if "5" in rows:
                calls[f"block_tail_bwd_bf16{sfx} {tag}"] = (
                    lambda p=p, x=gc, o=ops: kb.block_tail_bwd(*cs.tail_args(p), x, bf16_ops=o))
            if "5h" in rows:
                calls[f"block_head_bwd_bf16{sfx} {tag}"] = (
                    lambda p=p, x=g_m, o=ops: kb.block_head_bwd(*cs.head_args(p), x, bf16_ops=o))
            if "9" in rows:
                calls[f"conv1x1_dw_bwd_bf16{sfx} {tag}"] = (
                    lambda p=p, x=g_m, o=ops: kf.fused_dwconv_bwd(*cs.fused_args(p, False), x,
                                                                  bf16_ops=o))
            if "9g" in rows:
                calls[f"gdfn_fused_bwd_bf16{sfx} {tag}"] = (
                    lambda p=p, x=gc, o=ops: kf.fused_dwconv_bwd(*cs.fused_args(p, True), x,
                                                                 bf16_ops=o))
    return {key: [cs.device_ms(fn)[0], bwd_times.stage_split(cs, fn).get("by_launch")]
            for key, fn in calls.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", nargs="+", default=list(ROW_SOURCES), choices=list(ROW_SOURCES))
    ap.add_argument("--variants", nargs="+", default=list(CUTS), choices=list(CUTS))
    ap.add_argument("--root", type=Path, default=HERE,
                    help="the tree whose rcot_torch is copied (default: this checkout)")
    ap.add_argument("--time", help=argparse.SUPPRESS)  # a child: time this tree
    args = ap.parse_args()
    if args.time:
        print(json.dumps({"device_ms": time_tree(Path(args.time), args.rows)}))
        return 0
    # a variant is timed for the rows it cuts (full for all)
    variants = {v: [r for r in args.rows if v == "full" or cuts(v, [r])]
                for v in dict.fromkeys(["full", *args.variants])}
    variants = {v: rows for v, rows in variants.items() if rows}
    roots = {v: make_tree(v, rows, args.root.resolve()) for v, rows in variants.items()}
    builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
                                " from rcot_torch.kernels import build; build.build()", str(root)],
                               cwd=HERE) for root in roots.values()]
    if any(p.wait() for p in builds):
        return 1
    for v in [*variants, "full"]:
        run = subprocess.run([sys.executable, __file__, "--time", str(roots[v]),
                              "--rows", *variants[v]], cwd=HERE, capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return 1
        line = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"variant": v, **line}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": card.stdout.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
