"""Where the time of an evaluation run goes, on one CUDA card.

    python tools/port_eval_times.py [--images 6] [--size 256] [--rounds 2]

Writes a seeded tree (rcot_torch.data.synthetic.write_eval_tree) and a
full-width T_net (ModelConfig(), seeded weights), builds the kernels, then
splits what `rcot_torch.cli.test --fid --lpips --niqe-model fit:<targets>`
does on the --images pairs, in its order and under PyTorch's default flags
(as the CLI runs): the restorer's set-up, the restores, PSNR and the
reference SSIM on the host, LPIPS per pair on the card, the NIQE fit and
the scores on the host, the Inception features of both folders (PIL
preprocessing included) and the Frechet distance (two statistics and a
sqrtm of a 2,048 x 2,048 product on the host); and the whole CLI. Each
stage's seconds (the card synchronised) for each round, and one JSON line
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", type=int, default=6)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch

    from rcot_torch.cli import fid as fid_cli
    from rcot_torch.cli import test as test_cli
    from rcot_torch.data.datasets import eval_pairs, list_image_folder, load_rgb
    from rcot_torch.data.synthetic import write_eval_tree
    from rcot_torch.kernels import build
    from rcot_torch.metrics import frechet, lpips, niqe
    from rcot_torch.metrics.quality import psnr, ssim_ref_single
    from rcot_torch.models.inference import make_restorer
    from rcot_torch.models.restormer import TNet
    from rcot_torch.utils.config import ModelConfig

    if not torch.cuda.is_available():
        print("port_eval_times: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    flags = {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    build.build()
    build.library()

    def timed(out: dict, key: str, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[key] = out.get(key, 0.0) + time.perf_counter() - t0
        return r

    rounds = []
    with tempfile.TemporaryDirectory() as tmp:
        write_eval_tree(tmp, seed=4, n=args.images, size=(args.size, args.size))
        deg, tar = f"{tmp}/paired/input/", f"{tmp}/paired/target/"
        ckpt = f"{tmp}/tnet.pt"
        torch.save(TNet(ModelConfig(), device="cpu", seed=5).state_dict(), ckpt)
        argv = ["--ckpt", ckpt, "--degset", deg, "--tarset", tar, "--save", f"{tmp}/out/",
                "--savetar", f"{tmp}/tar/", "--saveres", f"{tmp}/res/", "--fid", "--lpips",
                "--niqe-model", f"fit:{tar}"]
        for _ in range(args.rounds):
            s: dict = {}
            sd, cfg = timed(s, "load_and_build_restorer", lambda: test_cli.load_state_dict(ckpt))
            restorer = timed(s, "load_and_build_restorer",
                             lambda: make_restorer(sd, cfg, device="cuda"))
            net = timed(s, "lpips_net", lambda: lpips.LPIPS(None, "cuda"))
            model = timed(s, "niqe_fit", lambda: niqe.fit_niqe_model(
                [load_rgb(f).astype(np.float64) for f in list_image_folder(tar)]))
            outs = []
            for d, t in eval_pairs(deg, tar):
                x = timed(s, "read_pngs", lambda: load_rgb(d).astype(np.float32) / 255.0)
                y = timed(s, "read_pngs", lambda: load_rgb(t).astype(np.float32) / 255.0)
                o = timed(s, "restore", lambda: restorer(x))
                outs.append(o)
                ot, yt = torch.from_numpy(o), torch.from_numpy(y)
                timed(s, "psnr_ssim_host", lambda: (float(psnr(ot, yt)),
                                                    float(ssim_ref_single(ot * 255, yt * 255))))
                timed(s, "lpips", lambda: float(lpips.lpips(net, ot[None], yt[None])[0]))
                timed(s, "niqe_scores", lambda: niqe.niqe(o.astype(np.float64), model))
            feats = [timed(s, "inception_features", lambda f=f: fid_cli.folder_activations(
                f, device="cuda")) for f in (tar, deg)]
            stats = [timed(s, "frechet_statistics",
                           lambda a=a: frechet.activation_statistics(a)) for a in feats]
            timed(s, "frechet_sqrtm", lambda: frechet.frechet_distance(*stats[0], *stats[1]))
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                timed(s, "whole_cli", lambda: test_cli.main(argv))
            rounds.append(s)
            print(json.dumps({"round": len(rounds), **s}), flush=True)
    print(json.dumps({"card": card, "flags": flags, "images": args.images, "size": args.size,
                      "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
