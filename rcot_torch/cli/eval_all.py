"""Multi-task evaluation over the test sets (counterpart of rcot_tpu/cli/eval_all.py).

    python -m rcot_torch.cli.eval_all --ckpt CKPT \\
        --denoise-path data/test/BSD68/ --sigmas 15 25 50 \\
        --derain-path data/test/Rain100L/ --dehaze-path data/test/SOTS/ \\
        --deblur-dir data/test/GoPro/ --lowlight-dir data/test/LOL/ \\
        [--paired NAME DIR] [--json-out summary.json] [--device cuda] \\
        [--composition full|head|tail|off] [--attention-core gram|mdta] \\
        [--depthwise fused|dwconv]

One checkpoint (a JAX-package .npz or a TNet state_dict .pt, read by
cli/test.py's load_state_dict), many tasks, per-task PSNR/SSIM (the
reference's SSIM, ssim_ref_single) beside the identity baseline
(degraded against target, `input_psnr` / `input_ssim`), one JSON summary
{"ckpt", "results"}:
- every derain/dehaze task's derived GT paths are checked before any
  compute, and every missing one is counted in the error;
- each task runs on its own: a failing one records {"error": ...} and the
  others still run; the exit code is then 1;
- the summary is rewritten after every task (to --json-out too), so
  partial results survive a later crash;
- an item that fails (a shape mismatch, an unreadable file) is skipped,
  logged with its reason and counted in its row.
--dtype bfloat16 serves in bf16, in every composition, attention core and
depthwise tier.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..data.datasets import crop_to_base, eval_pairs, load_rgb
from ..data.eval_datasets import (DeblurTestDataset, DenoiseTestDataset,
                                  DerainDehazeDataset, LowLightTestDataset)
from ..metrics.quality import AverageMeter, psnr, ssim_ref_single
from ..models.inference import make_restorer
from ..ops.dispatch import ATTENTION_CORES, COMPOSITIONS, DEPTHWISE
from .test import DTYPES, load_state_dict, refuse_unported


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="rcot_torch unified evaluation")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--denoise-path", default=None,
                   help="clean image folder (noise synthesized per --sigmas)")
    p.add_argument("--sigmas", type=float, nargs="+", default=[15, 25, 50])
    p.add_argument("--derain-path", default=None, help="folder with input/ + target/")
    p.add_argument("--dehaze-path", default=None, help="folder with input/ + target/")
    p.add_argument("--deblur-dir", default=None, help="GoPro-style root (test/blur, test/sharp)")
    p.add_argument("--lowlight-dir", default=None, help="LOL-style root (low/, high/)")
    p.add_argument("--paired", nargs=2, action="append", default=[],
                   metavar=("NAME", "DIR"),
                   help="extra task: DIR/input + DIR/target paired by sorted "
                        "order (tester.py:55-58 semantics); repeatable")
    p.add_argument("--tile", type=int, default=0)
    p.add_argument("--tile-overlap", type=int, default=32)
    p.add_argument("--dtype", choices=list(DTYPES), default="float32",
                   help="activation dtype")
    p.add_argument("--json-out", default=None, help="write the summary JSON here too")
    p.add_argument("--device", default="cuda")
    p.add_argument("--composition", default="full", choices=COMPOSITIONS,
                   help="kernels of the T_net blocks")
    p.add_argument("--attention-core", default="gram", choices=ATTENTION_CORES)
    p.add_argument("--depthwise", default="fused", choices=DEPTHWISE)
    return p


def _eval_items(restorer, items, task: str) -> dict:
    """Evaluate one task; skips are loud (logged and counted), never silent."""
    pm, sm = AverageMeter(), AverageMeter()
    ipm, ism = AverageMeter(), AverageMeter()  # input (identity) baseline
    skipped = 0
    for name, deg, clean in items:
        if deg.shape != clean.shape:
            skipped += 1
            print(f"eval_skip task={task} item={name} reason=shape_mismatch "
                  f"deg={deg.shape} target={clean.shape}", flush=True)
            continue
        try:
            out = restorer(deg)
        except Exception as e:  # one bad item must not end the task
            skipped += 1
            print(f"eval_skip task={task} item={name} "
                  f"reason={type(e).__name__}: {e}", flush=True)
            continue
        o, d, c = (torch.from_numpy(a) for a in (out, deg, clean))
        pm.update(float(psnr(o, c)))
        sm.update(float(ssim_ref_single(o * 255.0, c * 255.0)))
        ipm.update(float(psnr(d, c)))
        ism.update(float(ssim_ref_single(d * 255.0, c * 255.0)))
    row = {"psnr": round(pm.avg, 4), "ssim": round(sm.avg, 5), "n": pm.count,
           "input_psnr": round(ipm.avg, 4), "input_ssim": round(ism.avg, 5)}
    if skipped:
        row["skipped"] = skipped
    return row


def _validate_paired(ds) -> None:
    """Fail before any compute, naming how many derived GT paths are
    missing (the rules of reference util/dataset_utils.py:383-397)."""
    if not ds.ids:
        raise FileNotFoundError(f"no input images for task {ds.task!r}")
    missing = [gt for gt in (ds._gt_path(p) for p in ds.ids) if not os.path.isfile(gt)]
    if missing:
        raise FileNotFoundError(
            f"{len(missing)}/{len(ds.ids)} derived GT paths missing for "
            f"task {ds.task!r} (first: {', '.join(missing[:3])})")


def _write_summary(args, results) -> str:
    summary = json.dumps({"ckpt": args.ckpt, "results": results}, indent=2)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(summary)
    return summary


def _paired_items(root: str):
    pairs = eval_pairs(os.path.join(root, "input/"), os.path.join(root, "target/"))
    if not pairs:
        raise FileNotFoundError(f"no input/target pairs under {root!r}")
    for deg_p, tar_p in pairs:
        deg = crop_to_base(load_rgb(deg_p), 16)
        tar = crop_to_base(load_rgb(tar_p), 16)
        yield (os.path.basename(deg_p)[:-4], deg.astype(np.float32) / 255.0,
               tar.astype(np.float32) / 255.0)


def build_tasks(args) -> list:
    """[(key, build)]: build() validates the task's folders and returns its
    items, so a bad folder is an error of that task alone."""
    tasks = []
    if args.denoise_path:
        for sigma in args.sigmas:
            # :g keeps fractional sigmas apart (15.2 and 15.8)
            def build(sigma=sigma):
                ds = DenoiseTestDataset(args.denoise_path, sigma=sigma)
                if not len(ds):
                    raise FileNotFoundError(f"no images in {args.denoise_path!r}")
                return (ds[i] for i in range(len(ds)))
            tasks.append((f"denoise_sigma{sigma:g}", build))
    for task, path in (("derain", args.derain_path), ("dehaze", args.dehaze_path)):
        if not path:
            continue

        def build(task=task):
            ds = DerainDehazeDataset(args.derain_path or "", args.dehaze_path or "",
                                     task=task)
            _validate_paired(ds)
            return (ds[i] for i in range(len(ds)))
        tasks.append((task, build))
    for key, path, cls in (("deblur", args.deblur_dir, DeblurTestDataset),
                           ("lowlight", args.lowlight_dir, LowLightTestDataset)):
        if path:
            def build(path=path, cls=cls):
                ds = cls(path)
                return (ds[i] for i in range(len(ds)))
            tasks.append((key, build))
    for name, root in args.paired:
        # the generator's first next() lists the folders: the error is the task's
        tasks.append((name, lambda root=root: _paired_items(root)))
    return tasks


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    sd, model_cfg = load_state_dict(args.ckpt)
    restorer = make_restorer(sd, model_cfg, tile=args.tile, tile_overlap=args.tile_overlap,
                             device=args.device, composition=args.composition,
                             attention_core=args.attention_core, depthwise=args.depthwise,
                             dtype=DTYPES[args.dtype])
    results = {}
    failed = 0
    for key, build in build_tasks(args):
        try:
            results[key] = _eval_items(restorer, build(), key)
        except Exception as e:  # a failed task is recorded; the others still run
            failed += 1
            results[key] = {"error": f"{type(e).__name__}: {e}"}
            print(f"task {key} FAILED: {results[key]['error']}", file=sys.stderr, flush=True)
        else:
            print(f"{key}: {results[key]}", flush=True)
        _write_summary(args, results)  # partial results survive a crash

    print(_write_summary(args, results))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
