"""Training CLI, the flags of the JAX package's rcot_tpu/cli/train.py.

    python -m rcot_torch.cli.train --preset derain --batch-size 3 --patch-size 128 \
        --n-epochs 51 --pairnum 10000000 --Sigma 10000 --sigma 1 \
        [--device cuda] [--composition auto|full|head|tail|off] \
        [--attention-core gram|mdta] [--depthwise fused|dwconv] [--bwd-bf16 0|all|block,gram,...]

Flags overlay a named preset (utils/config.py PRESETS, the reference's
README recipes). `--device cpu` runs the plain PyTorch path; the default,
cuda, raises without a card. `--composition`, `--attention-core` and
`--depthwise` pick the T_net blocks' kernels (ops/dispatch.py): "auto" is
the JAX trainer's default composition, "tail"; `--attention-core mdta` is
the JAX package's RCOT_PALLAS_MDTA=1, `--depthwise dwconv` its
RCOT_PALLAS_FUSED=0 RCOT_PALLAS_DWCONV=1. Validation serves in "full" with
the same attention core and depthwise tier. `--dtype bfloat16` trains on
bf16 batches (the JAX trainer's --dtype bfloat16) in any composition,
attention core and depthwise tier. `--bwd-bf16` is the JAX package's
RCOT_BWD_BF16: the backward kernels of the tiers named ("block" row 5,
"gram" rows 6-7, "fused" row 9; "all" or "1" every one) take bf16 operands
in their products, with fp32 sums, in fp32 and bf16 training alike; an
unknown tier name stops the run.
Flags of paths not ported yet (multi-GPU, MPRNet, --pretrained) raise
rather than being ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from ..ops.dispatch import ATTENTION_CORES, BWD_BF16_TIERS, COMPOSITIONS, DEPTHWISE
from ..utils.config import Config, get_preset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="rcot_torch trainer")
    p.add_argument("--preset", default="derain", help="named recipe preset")
    p.add_argument("--batch-size", "--batchSize", dest="batch_size", type=int)
    p.add_argument("--n-epochs", "--nEpochs", dest="num_epochs", type=int)
    p.add_argument("--lr", type=float)
    p.add_argument("--step", dest="lr_step", type=int)
    p.add_argument("--resume", default=None, help="checkpoint path to resume")
    p.add_argument("--pretrained", default=None,
                   help="reference .pth to port weights from (not ported yet)")
    p.add_argument("--pairnum", type=int)
    p.add_argument("--de-type", "--de_type", dest="de_type", nargs="+")
    p.add_argument("--denoise-dir", dest="denoise_dir")
    p.add_argument("--derain-dir", dest="derain_dir")
    p.add_argument("--dehaze-dir", dest="dehaze_dir")
    p.add_argument("--deblur-dir", dest="deblur_dir")
    p.add_argument("--lowlight-dir", dest="lowlight_dir")
    p.add_argument("--single-dir", dest="single_dir")
    p.add_argument("--data-file-dir", dest="data_file_dir")
    p.add_argument("--degset", default=None, help="validation degraded folder")
    p.add_argument("--tarset", default=None, help="validation target folder")
    p.add_argument("--Sigma", type=float)
    p.add_argument("--sigma", type=float)
    p.add_argument("--optimizer", choices=["RMSprop", "Adam"])
    p.add_argument("--type", dest="run_name")
    p.add_argument("--patch-size", "--patch_size", dest="patch_size", type=int)
    p.add_argument("--num-workers", dest="num_workers", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--dtype", choices=["float32", "bfloat16"])
    p.add_argument("--loss-math", dest="loss_math", choices=["reference", "clean"])
    p.add_argument("--fail-at-step", dest="fail_at_step", type=int,
                   help="fault injection: raise at this global step")
    p.add_argument("--ckpt-dir", dest="ckpt_dir")
    p.add_argument("--ckpt-every-steps", dest="ckpt_every_steps", type=int,
                   help="also checkpoint mid-epoch every N steps")
    p.add_argument("--log-file", default=None)
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-parallel mesh size (0 = single device; not ported yet)")
    p.add_argument("--profile-dir", default=None,
                   help="torch.profiler trace dir (steps 3-8 of the first epoch)")
    p.add_argument("--backbone", choices=["restormer", "mprnet"], default=None,
                   help="T_net backbone (default: the preset's; mprnet not ported yet)")
    p.add_argument("--coordinator", default=None,
                   help="multi-process coordinator address (not ported yet)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--composition", default="auto", choices=("auto",) + COMPOSITIONS,
                   help="kernels of the T_net blocks (auto = tail in training)")
    # absent from the namespace unless given (main() supplies the default),
    # so a parse of the JAX CLI's flags gives the JAX CLI's keys
    p.add_argument("--attention-core", choices=ATTENTION_CORES, default=argparse.SUPPRESS,
                   help="attention core of the T_net blocks (default gram; mdta = "
                        "the fused MDTA attend kernel)")
    p.add_argument("--depthwise", choices=DEPTHWISE, default=argparse.SUPPRESS,
                   help="depthwise tier of the T_net blocks' qkv and GDFN (default "
                        "fused; dwconv = the standalone depthwise kernel)")
    p.add_argument("--bwd-bf16", dest="bwd_bf16", default=argparse.SUPPRESS,
                   help="backward kernels whose products take bf16 operands, the JAX "
                        "package's RCOT_BWD_BF16: 0 (default) none, 1 or all every tier, "
                        "or a comma list of " + ", ".join(BWD_BF16_TIERS))
    return p


def overlay_config(cfg: Config, args: argparse.Namespace) -> Config:
    train_fields = {f.name for f in dataclasses.fields(cfg.train)}
    data_fields = {f.name for f in dataclasses.fields(cfg.data)}
    t_over, d_over = {}, {}
    for k, v in vars(args).items():
        if v is None:
            continue
        if k in train_fields:
            t_over[k] = v
        elif k in data_fields:
            d_over[k] = tuple(v) if k == "de_type" else v
    train = dataclasses.replace(cfg.train, **t_over)
    data = dataclasses.replace(cfg.data, **d_over)
    critic = cfg.critic
    if "patch_size" in d_over:
        critic = dataclasses.replace(critic, patch_size=d_over["patch_size"])
    model = cfg.model
    if args.backbone:
        model = dataclasses.replace(model, backbone=args.backbone)
    return cfg.replace(train=train, data=data, critic=critic, model=model)


def _refuse_unported(args: argparse.Namespace) -> None:
    """The JAX CLI's flags whose paths this package does not have yet
    (ROADMAP.md, Queue 1) stop the run instead of being ignored."""
    unported = [
        (args.mesh_data, "--mesh-data", "multi-GPU data parallelism"),
        (args.coordinator is not None or args.num_processes is not None
         or args.process_id is not None,
         "--coordinator/--num-processes/--process-id", "multi-process training"),
        (args.backbone == "mprnet", "--backbone mprnet", "the MPRNet backbone"),
        (args.pretrained is not None, "--pretrained",
         "porting a reference .pth (it needs the reference-weights port)"),
    ]
    for given, flag, what in unported:
        if given:
            raise SystemExit(f"{flag}: {what} is not ported to rcot_torch yet "
                             "(ROADMAP.md, Queue 1)")


def main(argv=None):
    """Run the CLI; returns the Trainer, its state as the run left it."""
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    cfg = overlay_config(get_preset(args.preset), args)

    from ..train.trainer import Trainer

    log_path = args.log_file or os.path.join("logs", f"{cfg.train.run_name}.jsonl")
    trainer = Trainer(cfg, log_path=log_path, device=args.device,
                      composition=args.composition,
                      attention_core=getattr(args, "attention_core", "gram"),
                      depthwise=getattr(args, "depthwise", "fused"),
                      bwd_bf16=getattr(args, "bwd_bf16", "0"))
    if args.resume:
        trainer.resume(args.resume)
    trainer.fit(eval_degset=args.degset, eval_tarset=args.tarset,
                profile_dir=args.profile_dir)
    return trainer


if __name__ == "__main__":
    main()
