"""Folder restoration and its metrics (counterpart of rcot_tpu/cli/test.py).

    python -m rcot_torch.cli.test --ckpt CKPT --degset DEG/ --tarset TAR/ \
        [--batch N] [--tile T --tile-overlap O] [--noise-sigma S] [--device cuda] \
        [--composition full|head|tail|off] [--attention-core gram|mdta] \
        [--depthwise fused|dwconv] [--fid [--inception-weights W.npz]] \
        [--lpips [--lpips-weights W.npz]] [--niqe-model PARAMS.mat|.npz|fit:FOLDER]

--ckpt is a JAX-package .npz (a raw T-params npz or a trainer checkpoint)
or a .pt state_dict of this package's TNet. Images are reflect-padded to
mod 8 and cropped back; residual, output and target PNGs are written to
--saveres/--save/--savetar. float32 only. `--composition`,
`--attention-core` and `--depthwise` pick the T_net blocks' kernels
(ops/dispatch.py), as RCOT_INFER_BLOCK, RCOT_PALLAS_MDTA=1 and
RCOT_PALLAS_FUSED=0 RCOT_PALLAS_DWCONV=1 do for the JAX package's tester;
the defaults are serving's: full, gram, fused.

Besides per-image and average PSNR/SSIM it reports, as the JAX tester
does, the mean LPIPS (--lpips, metrics/lpips.py), the mean NIQE of the
restored images (--niqe-model: a params file, or fit:FOLDER for a
surrogate pristine model fit on a clean folder; images smaller than one
96 px patch are skipped by name) and FID between --savetar and --save
(--fid, cli/fid.py). Without a weights file the LPIPS and Inception nets
use the JAX package's crc32-seeded surrogates, whose scores compare only
with each other. Flags of paths not ported yet (--dtype bfloat16,
--backbone mprnet, --sr-scale, --spatial) stop the run by name.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from ..compat.jax_params import load_jax_npz
from ..data.datasets import eval_pairs, list_image_folder, load_rgb
from ..metrics import niqe as niqe_mod
from ..metrics.lpips import LPIPS, lpips as lpips_dist
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
    p.add_argument("--fid", action="store_true", help="also compute FID")
    p.add_argument("--inception-weights", default=None)
    p.add_argument("--lpips", action="store_true", help="also report mean LPIPS")
    p.add_argument("--lpips-weights", default=None)
    p.add_argument("--niqe-model", default=None,
                   help="NIQE pristine-model params (.mat/.npz) or 'fit:<folder>' "
                        "to fit a surrogate from a clean folder; reports the mean "
                        "no-reference NIQE of the restored outputs")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="bfloat16 is not ported yet")
    p.add_argument("--backbone", choices=["auto", "restormer", "mprnet"], default="auto",
                   help="T_net backbone (mprnet is not ported yet)")
    p.add_argument("--sr-scale", type=int, default=0,
                   help="legacy SR mode of the MPRNet backbone (not ported yet)")
    p.add_argument("--spatial", type=int, default=0,
                   help="row sharding over N devices (not ported yet)")
    return p


def refuse_unported(args: argparse.Namespace) -> None:
    """The JAX tester's flags whose paths this package does not have yet
    (ROADMAP.md, Queue 1) stop the run instead of being ignored. Also
    cli.eval_all's, whose parser has only --dtype of them."""
    unported = [
        (args.dtype == "bfloat16", "--dtype bfloat16", "bf16 activations (item 4)"),
        (getattr(args, "backbone", "auto") == "mprnet", "--backbone mprnet",
         "the MPRNet backbone (item 6)"),
        (getattr(args, "sr_scale", 0) > 0, "--sr-scale", "the legacy SR mode (item 6)"),
        (getattr(args, "spatial", 0) > 1, "--spatial", "row sharding over devices (item 8)"),
    ]
    for given, flag, what in unported:
        if given:
            raise SystemExit(f"{flag}: {what} is not ported to rcot_torch yet "
                             "(ROADMAP.md, Queue 1)")


def fit_or_load_niqe(spec: str):
    """--niqe-model: 'fit:FOLDER' fits a surrogate pristine model on the
    folder's images, anything else is a params file."""
    if not spec.startswith("fit:"):
        return niqe_mod.load_niqe_model(spec)
    folder = spec[4:]
    imgs = [load_rgb(f).astype(np.float64) for f in list_image_folder(folder)]
    model = niqe_mod.fit_niqe_model(imgs)
    print(f"NIQE: surrogate model fit on {len(imgs)} images from {folder} "
          "(relative scores only)")
    return model


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
    refuse_unported(args)
    sd, model_cfg = load_state_dict(args.ckpt)
    restorer = make_restorer(sd, model_cfg, tile=args.tile,
                             tile_overlap=args.tile_overlap, device=args.device,
                             composition=args.composition,
                             attention_core=args.attention_core, depthwise=args.depthwise)

    rng = np.random.default_rng(args.seed)
    p_meter, s_meter = AverageMeter(), AverageMeter()
    l_meter, n_meter = AverageMeter(), AverageMeter()
    lpips_net = LPIPS(args.lpips_weights, args.device) if args.lpips else None
    niqe_model = fit_or_load_niqe(args.niqe_model) if args.niqe_model else None
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
            if lpips_net is not None:
                l_meter.update(float(lpips_dist(lpips_net, o[None], t[None])[0]))
            if niqe_model is not None:
                try:
                    n_meter.update(niqe_mod.niqe(np.asarray(out, np.float64), niqe_model))
                except ValueError as e:  # image smaller than one 96 px patch
                    print(f"niqe skip {name}: {e}")
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
    if lpips_net is not None:
        print(f"LPIPS: average {l_meter.avg:.5f}")
    if niqe_model is not None and n_meter.count:
        print(f"NIQE: average {n_meter.avg:.5f} ({n_meter.count} images)")
    if args.fid:
        from .fid import compute_fid_folders
        fid = compute_fid_folders(args.savetar, args.save,
                                  weights=args.inception_weights, device=args.device)
        print(f"FID value: {fid:.4f}")


if __name__ == "__main__":
    main()
