"""Folder restoration and PSNR/SSIM report (counterpart of rcot_tpu/cli/test.py).

    python -m rcot_torch.cli.test --ckpt CKPT --degset DEG/ --tarset TAR/ \
        [--batch N] [--tile T --tile-overlap O] [--noise-sigma S] [--device cuda] \
        [--composition full|head|tail|off] [--attention-core gram|mdta] \
        [--depthwise fused|dwconv]

--ckpt is a JAX-package .npz (a raw T-params npz or a trainer checkpoint)
or a .pt state_dict of this package's TNet. Images are reflect-padded to
mod 8 and cropped back; residual, output and target PNGs are written to
--saveres/--save/--savetar. float32 only. `--composition`,
`--attention-core` and `--depthwise` pick the T_net blocks' kernels
(ops/dispatch.py), as RCOT_INFER_BLOCK, RCOT_PALLAS_MDTA=1 and
RCOT_PALLAS_FUSED=0 RCOT_PALLAS_DWCONV=1 do for the JAX package's tester;
the defaults are serving's: full, gram, fused.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from ..compat.jax_params import load_jax_npz
from ..data.datasets import eval_pairs, load_rgb
from ..metrics.quality import AverageMeter, psnr, ssim_ref_single
from ..models.inference import make_restorer
from ..ops.dispatch import ATTENTION_CORES, COMPOSITIONS, DEPTHWISE
from ..utils.config import EvalConfig, ModelConfig


def build_parser() -> argparse.ArgumentParser:
    d = EvalConfig()
    p = argparse.ArgumentParser(description="rcot_torch tester")
    p.add_argument("--ckpt", required=True,
                   help="JAX-package .npz checkpoint or a TNet state_dict .pt")
    p.add_argument("--degset", required=True, help="degraded image folder")
    p.add_argument("--tarset", required=True, help="target image folder")
    p.add_argument("--save", default=d.save)
    p.add_argument("--savetar", default=d.savetar)
    p.add_argument("--saveres", default=d.saveres)
    p.add_argument("--tile", type=int, default=d.tile,
                   help="overlap-tiled inference tile size (0 = whole image)")
    p.add_argument("--tile-overlap", type=int, default=d.tile_overlap)
    p.add_argument("--batch", type=int, default=d.batch_size,
                   help="restore N same-bucket images per forward")
    p.add_argument("--noise-sigma", type=float, default=d.noise_sigma,
                   help="synthesize gaussian noise on the GT (tester_noise mode)")
    p.add_argument("--seed", type=int, default=1850)  # tester_noise.py:12
    p.add_argument("--device", default="cuda")
    p.add_argument("--composition", default="full", choices=COMPOSITIONS,
                   help="kernels of the T_net blocks")
    p.add_argument("--attention-core", default="gram", choices=ATTENTION_CORES,
                   help="attention core (mdta = the fused MDTA attend kernel)")
    p.add_argument("--depthwise", default="fused", choices=DEPTHWISE,
                   help="depthwise tier of qkv and GDFN outside the block kernels "
                        "(dwconv = the standalone depthwise kernel)")
    return p


def save_png(path: str, img01: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.clip(np.asarray(img01) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def load_state_dict(path: str):
    """-> (state_dict, ModelConfig) from a JAX-package .npz (whose metadata
    may carry the model config) or a .pt TNet state_dict at ModelConfig().
    A reference checkpoint (.pth, a pickle of the reference's modules) stops
    the run by name: reading it needs the reference-weights port."""
    if path.endswith(".pth"):
        raise SystemExit(f"{path}: a reference .pth checkpoint is not ported to rcot_torch "
                         "yet (ROADMAP.md, Queue 1 item 3); convert it with "
                         "tools/port_reference_ckpt.py and pass the .npz it writes")
    if path.endswith(".npz"):
        return load_jax_npz(path)
    return torch.load(path, map_location="cpu", weights_only=True), ModelConfig()


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    sd, model_cfg = load_state_dict(args.ckpt)
    restorer = make_restorer(sd, model_cfg, tile=args.tile,
                             tile_overlap=args.tile_overlap, device=args.device,
                             composition=args.composition,
                             attention_core=args.attention_core, depthwise=args.depthwise)

    rng = np.random.default_rng(args.seed)
    p_meter, s_meter = AverageMeter(), AverageMeter()
    best, worst = (-1.0, None), (1e9, None)

    def flush(chunk):
        nonlocal best, worst
        outs = (restorer.restore_batch([deg for _, deg, _ in chunk])
                if args.batch > 1 else [restorer(deg) for _, deg, _ in chunk])
        for (name, deg, tar), out in zip(chunk, outs):
            # residual dump gain: x2 normally (tester.py:106), x3 in noise
            # mode (tester_noise.py:116)
            res_gain = 3.0 if args.noise_sigma > 0 else 2.0
            save_png(os.path.join(args.saveres, name), res_gain * (deg - out))
            save_png(os.path.join(args.save, name), out)
            save_png(os.path.join(args.savetar, name), tar)
            o, t = torch.from_numpy(out), torch.from_numpy(tar)
            p = float(psnr(o, t, 1.0))
            s = float(ssim_ref_single(o * 255.0, t * 255.0))
            p_meter.update(p)
            s_meter.update(s)
            if p > best[0]:
                best = (p, name)
            if p < worst[0]:
                worst = (p, name)
            print(f"{name}: psnr {p:.4f} ssim {s:.4f}")

    chunk = []
    for deg_path, tar_path in eval_pairs(args.degset, args.tarset):
        name = os.path.basename(deg_path)
        tar = load_rgb(tar_path).astype(np.float32) / 255.0
        if args.noise_sigma > 0:
            noise = rng.standard_normal(tar.shape) * args.noise_sigma / 255.0
            deg = np.clip(tar + noise, 0.0, 1.0).astype(np.float32)
        else:
            deg = load_rgb(deg_path).astype(np.float32) / 255.0
            if tar.shape != deg.shape:
                print(f"skip {name}: shape mismatch {deg.shape} vs {tar.shape}")
                continue
        chunk.append((name, deg, tar))
        if len(chunk) >= max(args.batch, 1):
            flush(chunk)
            chunk = []
    if chunk:
        flush(chunk)

    print(f"PSNR: average {p_meter.avg:.5f}  best {best[1]} {best[0]:.4f}  "
          f"worst {worst[1]} {worst[0]:.4f}")
    print(f"SSIM: average {s_meter.avg:.5f}")


if __name__ == "__main__":
    main()
