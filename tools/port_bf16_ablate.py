"""Where the time of the bf16 Gram backward (row 6, both operand policies)
and the bf16 apply forward (row 4) goes, by subtraction, on one CUDA card.

    python tools/port_bf16_ablate.py [--variants full nostore nomma noload]

Copies this checkout's rcot_torch into build/ablate_<variant>/ with only
the three sources these kernels need (gram_bwd_bf16.cu without row 7's
wrapper, gram_bwd_bf16_b16ops.cu, gram_bf16.cu), cuts one part of both
kernels in the copy's csrc:

  full     nothing cut;
  nostore  the epilogue's stores of d[q|k] and out (the staging stays);
  nomma    the products (the Gram backward's fragment reads of its tiles
           and of dG go with them; the apply's ldmatrix reads stay);
  noload   the copies of the q, k and v tiles (the ring keeps what it
           holds; dG and attn are still staged),

builds the copies at once, then times each in a process of its own, in
turns (full first and last), at train L1 and decoder L1 (128^2, B = 3; the
Gram backward) and serve L1, decoder L1 and L1 at batch 8 (256^2; the
apply): device ms a call (chip_smoke.device_ms). A cut kernel computes
nothing useful; only its time is read. Each line names its variant; the
last line the card's name and power limit. Not part of the port: a
measurement tool, whose copies live under build/ and are rebuilt each run.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# variant -> [(source, text, replacement)]; each text must be found
CUTS = {
    "full": [],
    "nostore": [("gram_bwd.cuh", "      store_staged_v(out + off,",
                 "      if (p0 < 0) store_staged_v(out + off,"),
                ("gram_bf16.cu", "      store_staged_v(out + base,",
                 "      if (p0 < 0) store_staged_v(out + base,")],
    "nomma": [("gram_bwd.cuh",
               "    if constexpr (OPS16)\n      mma_1xtf32(acc, ah, bh, use_m, use_n);\n"
               "    else\n      mma_3xtf32<MT, NJ, !F32>(acc, ah, al, bh, bl, use_m, use_n);",
               "    (void)ah; (void)al; (void)bh; (void)bl;"),
              ("gram_bf16.cu",
               "        mma_bf16(acc[j], af, b0);\n        mma_bf16(acc[j + 1], af, b1);",
               "        (void)b0; (void)b1;")],
    "noload": [("gram_bwd.cuh", "      stage_rows_bf16_v(dst, LDA,",
                "      if (p0 < 0) stage_rows_bf16_v(dst, LDA,"),
               ("gram_bwd.cuh", "      stage_rows_bf16_v(dst + TP * LDA,",
                "      if (p0 < 0) stage_rows_bf16_v(dst + TP * LDA,"),
               ("gram_bf16.cu", "    stage_rows_bf16_v(ring + (i % STAGES) * TP * LD, LD,",
                "    if (t < 0) stage_rows_bf16_v(ring + (i % STAGES) * TP * LD, LD,")],
}
KEEP = {"gram_bwd_bf16.cu", "gram_bwd_bf16_b16ops.cu", "gram_bf16.cu"}


def make_tree(variant: str) -> Path:
    """build/ablate_<variant>/rcot_torch with the cut made."""
    root = HERE / "build" / f"ablate_{variant}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE / "rcot_torch", root / "rcot_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = root / "rcot_torch" / "csrc"
    for f in csrc.glob("*.cu"):
        if f.name not in KEEP:
            f.unlink()
    src = csrc / "gram_bwd_bf16.cu"  # row 7's wrapper needs apply_bwd.cu: cut it
    text = src.read_text()
    cut = text.index("// qkv (B, hw, 3*heads*ch) bf16, attn (B,heads,ch,ch) fp32, g (B, hw,")
    src.write_text(text[:cut] + "}  // extern \"C\"\n")
    for name, old, new in CUTS[variant]:
        f = csrc / name
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


def time_tree(root: Path) -> dict:
    """Device ms of the three forms, imported from root."""
    sys.path.insert(0, str(root))
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch, g = cs.torch, cs.kgram
    cs.build.library()
    gen = torch.Generator(device="cuda").manual_seed(3)

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    out = {}
    for tag, b, res, ch in (("train L1", 3, 128, 48), ("train decoder L1", 3, 128, 96)):
        qkv = r(b, res, res, 3 * ch).to(torch.bfloat16)
        cot = [r(b, 1, ch, ch), r(b, 1, ch), r(b, 1, ch)]
        out[f"mdta_gram_bwd_bf16 {tag}"] = cs.device_ms(lambda: g.mdta_gram_bwd(qkv, *cot, 1))[0]
        out[f"mdta_gram_bwd_bf16_b16ops {tag}"] = cs.device_ms(
            lambda: g.mdta_gram_bwd(qkv, *cot, 1, bf16_ops=True))[0]
    for tag, b, res, ch in (("serve L1", 1, 256, 48), ("serve decoder L1", 1, 256, 96),
                            ("serve L1 B=8", 8, 256, 48)):
        qkv = r(b, res, res, 3 * ch).to(torch.bfloat16)
        attn = torch.softmax(r(b, 1, ch, ch), -1)
        out[f"attn_apply_fwd_bf16 {tag}"] = cs.device_ms(lambda: g.attn_apply_fwd(qkv, attn))[0]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(CUTS), choices=list(CUTS))
    ap.add_argument("--time", help=argparse.SUPPRESS)  # a child: time this tree
    args = ap.parse_args()
    if args.time:
        print(json.dumps({"device_ms": time_tree(Path(args.time))}))
        return 0
    variants = list(dict.fromkeys(["full", *args.variants]))
    roots = {v: make_tree(v) for v in variants}
    builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
                                " from rcot_torch.kernels import build; build.build()", str(root)],
                               cwd=HERE) for root in roots.values()]
    if any(p.wait() for p in builds):
        return 1
    for v in [*variants, "full"]:
        run = subprocess.run([sys.executable, __file__, "--time", str(roots[v])], cwd=HERE,
                             capture_output=True, text=True)
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
