"""Drive the rcot_torch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from rcot_torch/csrc with nvcc (sm_90a);
  3. hold each forward kernel against its plain PyTorch twin on the card at
     every block shape of a 256x256 forward, B = 1 and 2, both LayerNorm
     types, and the Gram's and the block head's and tail's two calls on one
     input against each other (bitwise: their sums run in a fixed order);
     the block head and tail against their float64 twins, there and at every
     training block shape (B = 1 and 2, both LayerNorm types), at each
     block shape of phase 4's 250x321 image and nine-tile 600x600 one, at
     C = 6, with every operand 4 bytes off its allocation, and on a W_out
     product of K = h = 1,021 terms that never cancel; and the block head
     and tail, forward and backward, at C = 576 and 768 (past the 512
     channels that the LayerNorm holds in registers), both LayerNorm types,
     against their float64 twins and bitwise against a second call;
  3b. hold each backward kernel against its plain twin at every block
     shape of the training path (128x128, B = 3), both LayerNorm types,
     and the MDTA and block backward kernels' two calls on one input
     against each other (bitwise: their sums run in a fixed order);
  3c. hold the fused dwconv tier's kernels (conv1x1_dw and gdfn_fused,
     forward and backward) against their plain twins at every training
     block shape (pixel sums against the float64 twin), each bitwise
     against a second call (their sums run in a fixed order), and the GDFN
     on terms that never cancel, through its W_out product at K = h = 1,021
     and its dx product at K = 2h = 2,042, against its float64 twin;
  3d. hold the opt-in tiers' kernels against their plain twins: the fused
     MDTA attend (mdta_attend, against its float64 twin and bitwise against
     a second call) and the depthwise kernel (dwconv3x3 at the qkv and the
     GDFN widths, and its backward's dwconv3x3_dx and dwconv3x3_dtaps
     launches, dtaps also bitwise against a second call) at every serving
     block shape, B = 1 and 2, and every training one, B = 3; the attend
     also at N = 80,250 (the 250x321 image unpadded: 4-byte copies) and an
     odd N;
  3e. hold the MDTA kernels (rows 3-4, 6-7 and 10) at heads wider than 128
     channels (192 and 384, ModelConfig(heads=(1, 1, 1, 1))'s, at serving
     and training shapes; 136; 150, no multiple of 4) against their float64
     twins and bitwise against a second call; and the pixel sums of rows 3,
     7 and 10 on terms that never cancel, over ranges of 512 pixels, against
     float64 (their errors printed);
  4. serve the full-width T_net (ModelConfig(), 46,853,150 parameters,
     seeded random weights) through make_restorer: restore_batch on 256^2
     images plus a 250x321 one, and a tiled 600x600 restore; check shapes,
     finiteness and that each kernel of serving's composition, "full"
     (block head, block tail, Gram, apply), ran 94 times per two-pass
     forward and no other kernel ran;
     compare a 128^2 forward with the same model on the CPU, and the
     reference golden (tests/goldens/tnet_full.npz) on the card;
  4b. serve the same T_net in composition "off" with the fused MDTA attend
     and the standalone depthwise kernel (make_restorer(...,
     composition="off", attention_core="mdta", depthwise="dwconv")): 94
     launches of mdta_attend and 188 of dwconv3x3 per two-pass forward and
     no other kernel, the outputs against the default's, img/s at 256 px,
     batch 1 and 8;
  5. time images/s at 256 px, batch 1 and 8 (with the peak of
     torch.cuda.max_memory_allocated at batch 8), and each kernel at every
     block shape of serving and of training (the latter before phase 6)
     beside its bound, its plain twin and, where one exists, a
     single PyTorch call computing the same product, each both as `ms`
     (CUDA events around 20 back-to-back calls: host work and launch gaps
     included) and as `device_ms` (the kernels', memsets' and copies'
     durations per call, torch.profiler, with `device_records`, their
     number per call, and `sm_mhz`, the SM clock after the window); the
     Gram's and dattn's pixel sums against float64 (`sum_rel_err`); split
     one 256 px forward into its four kernels (each timed at every block
     shape, times the blocks at that shape) and the rest;
  5b. serve in bf16 (make_restorer(dtype=torch.bfloat16), the JAX
     package's make_restorer(dtype=jnp.bfloat16)): rows 1-4 in bf16
     (block_head_bf16, block_tail_bf16, mdta_gram_fwd_bf16,
     attn_apply_fwd_bf16) against their plain bf16 twins at every block
     shape of a 256x256 forward, B = 1 and 2, and a head of 192 channels,
     each bitwise against a second call (the share of elements not bitwise
     equal to the twin printed); the full-width T_net at 256^2, batch 1 and
     8, through restore_batch: 94 launches of each bf16 kernel per forward
     and none of their fp32 forms, the outputs against the same weights in
     bf16 on the CPU; bf16 and fp32 img/s at batch 1 and 8 in turns and the
     peak memory at batch 8; rcot_torch.cli.test --dtype bfloat16 against a
     CPU run; the bf16 kernels timed as phase 5 times the fp32 ones;
  5c. bf16 training's kernels (conv1x1_dw_bf16, conv1x1_dw_bwd_bf16,
     block_tail_bwd_bf16, mdta_gram_bwd_bf16, attn_apply_bwd_bf16) against
     their plain bf16 twins at every training block shape (128x128, B = 3:
     each level, the decoder's and the refinement's), rows 6-7 also at the
     wide heads of phase 3e, each bitwise against a second call, and timed
     as phase 5 times the others, before the training phases;
  6. train at full width: create_train_state(Config()) (T_net 46,853,150
     and F_net 30,588,609 parameters, seeded) in the JAX trainer's default
     composition, "tail"; three minimax iterations (make_train_iteration)
     at 128^2, B = 3, de_id 0/3/4, paired then unpaired twice; check finite
     metrics, that every used parameter moved and that each kernel of the
     composition (conv1x1_dw, block_tail, the Gram and the apply, forward
     and backward) ran 94 times per iteration and no other kernel ran;
     compare the T_net and F_net gradients and one iteration's metrics with
     the same state on the CPU at 64^2, B = 1; time iterations/s in "tail"
     and in "full" in turns, every kernel at the training shapes, and split
     one iteration of each into forward kernels, backward kernels, the
     critic and the rest;
  6e. train in bf16 (cli.train --dtype bfloat16's path): a full-width
     state in "tail", three iterations at 128^2, B = 3 on bf16 batches,
     counted (94 launches an iteration of each of BF16_TRAIN_PATH and none
     of the fp32 rows 2-9), finite metrics, fp32 parameters that moved;
     fp32 and bf16 iterations/s in turns with the peak memory of each;
     the bf16 gradients and an lr = 0 iteration's metrics at 64^2, B = 1
     against the CPU's (the critic's sign pattern pinned); and the train
     CLI with --dtype bfloat16 for one epoch through --fail-at-step 3 and a
     resume, its validation in fp32;
  6b. from one full-width state at 64^2, B = 1, each of the compositions
     full, head, tail and off, in the default tiers and then with the
     fused MDTA attend and the depthwise kernel: its kernels launched 94
     times a block kind in one forward and backward (head and off run
     gdfn_fused), and every T_net and F_net gradient within GRAD_RTOL of
     full's (the critic's sign pattern pinned to full's; a temperature's
     gradient, a cancelling sum, within the floor SUM_ULPS sets);
  6c. train at full width in "tail" with the fused MDTA attend and the
     depthwise kernel: three iterations at 128^2, B = 3, counted (94
     launches each of dwconv3x3, dwconv3x3_dx, dwconv3x3_dtaps, block_tail,
     block_tail_bwd and mdta_attend per iteration, no other kernel), finite
     metrics, every used parameter moved; iterations/s in turns with "tail";
  6d. ModelConfig(heads=(1, 1, 1, 1)) at full width (heads of 192 and 384
     channels): served through make_restorer in full/gram/fused and
     off/mdta/dwconv against the same restorer on the CPU, and one 64^2,
     B = 1 iteration's gradients in tail/gram/fused and tail/mdta/dwconv
     against the CPU's within GRAD_RTOL, each run's launches its tiers';
  7. the train CLI (rcot_torch.cli.train.main) at full width on a seeded
     synthetic tree: a run stopped by --fail-at-step 5, resumed from
     latest.npz at the epoch step its metadata holds, both epochs with
     finite metrics and two validations with a finite PSNR, each kernel of
     "tail" launched 94 times per iteration and the validation's forwards
     in "full", and the final checkpoint loaded into a fresh Trainer equal
     to the state in memory;
  7b. the train CLI for one epoch with --attention-core mdta --depthwise
     dwconv, then rcot_torch.cli.test on its validation folder from its
     latest.npz with --composition off --attention-core mdta --depthwise
     dwconv: finite metrics and PSNRs, each run's launches its tiers';
  8. evaluation at full width on a seeded tree of 256^2 images and a
     ModelConfig() checkpoint from a seed: rcot_torch.cli.eval_all over
     every task (denoise at sigmas 15 and 50, derain, dehaze, deblur,
     lowlight, a --paired tree; each row finite with its n, 94 launches of
     each "full" kernel per forward, each task's seconds), cli.test with
     --fid --lpips --niqe-model fit:<clean folder> (finite averages), the
     Inception pool3, LPIPS and FID of its saved images on the card against
     the CPU, the metrics' costs, and the CLI's per-image PSNR against a CPU
     run, in this script's fp32 and under PyTorch's default flags (TF32 in
     cuDNN), each within 1e-3 dB.

TF32 is off for every matmul and cuDNN convolution in this script, so the
plain twins and the CPU reference run in full fp32. Kernel agreement is
checked as max|kernel - plain| <= 1e-5 * max(max|plain|, 1) (fp32 sums in
another order). The Gram's plain twin runs in float64: its sums run over
every pixel with cancelling terms, and in fp32 on the card the twin's own
rounding comes near the tolerance (printed as
gram_plain_fp32_vs_float64_rel_err), while the kernel (3xTF32 products,
fp32 sums in a fixed order) stays well inside it. The backward kernels are held the same way: their per-pixel
outputs (dx, da, d[q|k], dv) against the fp32 twin, their pixel sums
(weight, LayerNorm and dattn grads, summed over up to 3 * 128^2 pixels in
a fixed order) against the float64 twin, all at the same bound; d[q|k], a
3xTF32 product, also against its float64 twin. Card
against CPU in training: each parameter's gradient within GRAD_RTOL of its
largest entry (fp32 through the whole T_net and F_net, forward and
backward, in another order of sums; the worst seen was 4.1e-5) or, for
an MDTA temperature, within SUM_ULPS ulps of the sum of its terms'
magnitudes where that is larger (TemperatureTerms), with
the critic's LeakyReLU sign pattern pinned to the CPU's (LeakyPattern says
why), each metric m within METRIC_RTOL * max(|m|, 1) (f_wgan is a difference of mean
critic scores that nearly cancels at initialisation, |f_wgan| ~ 1e-5, so
an error relative to the metric alone says nothing there). f_gp, t_loss
and t_adv are read at the critic after one or two RMSprop steps, which
move every entry with a near-zero gradient by about +-10 lr with a sign
that the order of sums decides; they are held to STEPPED_RTOL (the worst
seen was 2.9e-4, t_adv).

The fused MDTA attend's output, whose Gram and norms are pixel sums over
every pixel, is held against its float64 twin like the Gram; the
depthwise backward's dtaps, a pixel sum, likewise. Every kernel sums in a
fixed order and is held bitwise against a second call.

The bf16 phases' gates, and why they are what they are: the notes above
BF16_RTOL, BF16_FLIP_RTOL and BF16_MODEL_RATIO.

Prints the kernels' JSON line (all twenty-five kernels: the sixteen fp32
ones, rows 1-4 in bf16 and bf16 training's five forms) and, last,
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from rcot_torch.cli import eval_all as eval_cli
from rcot_torch.cli import fid as fid_cli
from rcot_torch.cli import test as test_cli
from rcot_torch.cli import train as train_cli
from rcot_torch.data.datasets import list_image_folder, load_rgb
from rcot_torch.data.synthetic import write_eval_tree, write_synthetic_tree
from rcot_torch.kernels import build
from rcot_torch.metrics import inception
from rcot_torch.metrics import lpips as lpips_mod
from rcot_torch.metrics import niqe as niqe_mod
from rcot_torch.models import critic
from rcot_torch.models.inference import make_restorer
from rcot_torch.models.restormer import TNet, count_params
from rcot_torch.ops import block as kblock
from rcot_torch.ops import dwconv as kdw
from rcot_torch.ops import fused as kfused
from rcot_torch.ops import gram as kgram
from rcot_torch.ops import mdta as kmdta
from rcot_torch.ops.dispatch import COMPOSITIONS
from rcot_torch.train import losses
from rcot_torch.train.optim import step_decay_lr
from rcot_torch.train.steps import Batch, create_train_state, make_train_iteration
from rcot_torch.train.trainer import InjectedFailure, Trainer
from rcot_torch.utils.checkpoint import read_metadata
from rcot_torch.utils.config import Config, CriticConfig, ModelConfig, TrainConfig

PEAK_FLOPS = 67e12   # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
KERNEL_RTOL = 1e-5
MODEL_ATOL, MODEL_RTOL = 2e-4, 1e-3
FORWARD_LAUNCHES = 94  # blocks per two-pass forward at ModelConfig()
GRAD_RTOL = 2e-4      # card vs CPU gradients, of each parameter's largest
# A floor for the gradient of an MDTA temperature, a sum of cancelling terms
# (grad_allowance). Each term dlogits * g_hat is a product of a normalised
# Gram entry and a softmax cotangent, each a sum over up to 64^2 pixels that
# two fp32 runs round in another order: about sqrt(4096) = 64 ulps of the
# term apart. If every term differs by at most SUM_ULPS ulps, their sum
# differs by at most SUM_ULPS * eps * sum|terms|, however close to 0 the sum
# itself comes. Where the terms do not cancel (sum|terms| ~ |grad|) the floor
# is 7.6e-6 of the gradient, far below GRAD_RTOL; every other tensor has no
# floor.
SUM_ULPS = 64
FP32_EPS = float(np.finfo(np.float32).eps)
METRIC_RTOL = 1e-4    # card vs CPU metrics read before any step, of max(|m|, 1)
STEPPED_RTOL = 1e-3   # ... and those read at the critic after its steps
STEPPED_METRICS = ("f_gp", "t_loss", "t_adv")
# the training recipe's crop and batch (CriticConfig(), TrainConfig())
TRAIN_RES, TRAIN_B = CriticConfig().patch_size, TrainConfig().batch_size

# (name, resolution, C, heads) of every block group of a 256x256 forward
MAIN_SHAPES = [
    ("L1", 256, 48, 1), ("L2", 128, 96, 2), ("L3", 64, 192, 4),
    ("latent", 32, 384, 8), ("noise_level3", 32, 384, 4),
    ("noise_level2", 64, 192, 4), ("noise_level1", 128, 96, 4),
    ("decoder_level1", 256, 96, 1),
]
# blocks at each of those shapes in one two-pass forward: the encoder and
# the residual encoder once each, the decoder (with its conditioning blocks
# and the refinement) once per pass
BLOCKS_PER_FORWARD = {"L1": 8, "L2": 24, "L3": 24, "latent": 16, "noise_level3": 2,
                      "noise_level2": 2, "noise_level1": 2, "decoder_level1": 16}
assert sum(BLOCKS_PER_FORWARD.values()) == FORWARD_LAUNCHES
# the same block groups in training, at 128 px: one forward and one
# backward of each block per iteration
TRAIN_SHAPES = [(label, res * TRAIN_RES // 256, c, heads)
                for label, res, c, heads in MAIN_SHAPES]

FORWARD_KERNELS = {
    "block_head": ("rcot_torch/csrc/block_fwd.cu", "rcot_tpu/ops/pallas_block.py:586"),
    "block_tail": ("rcot_torch/csrc/block_fwd.cu", "rcot_tpu/ops/pallas_block.py:597"),
    "mdta_gram_fwd": ("rcot_torch/csrc/gram.cu", "rcot_tpu/ops/pallas_gram.py:99"),
    "attn_apply_fwd": ("rcot_torch/csrc/gram.cu", "rcot_tpu/ops/pallas_gram.py:178"),
    "conv1x1_dw": ("rcot_torch/csrc/fused_dwconv.cu", "rcot_tpu/ops/pallas_fused.py:238"),
    "gdfn_fused": ("rcot_torch/csrc/fused_dwconv.cu", "rcot_tpu/ops/pallas_fused.py:238"),
    "mdta_attend": ("rcot_torch/csrc/mdta.cu", "rcot_tpu/ops/pallas_mdta.py:88"),
    "dwconv3x3": ("rcot_torch/csrc/dwconv.cu", "rcot_tpu/ops/pallas_dwconv.py:73"),
}
BACKWARD_KERNELS = {
    "block_head_bwd": ("rcot_torch/csrc/block_bwd.cu", "rcot_tpu/ops/pallas_block.py:401"),
    "block_tail_bwd": ("rcot_torch/csrc/block_bwd.cu", "rcot_tpu/ops/pallas_block.py:401"),
    "mdta_gram_bwd": ("rcot_torch/csrc/gram.cu", "rcot_tpu/ops/pallas_gram.py:141"),
    "attn_apply_bwd": ("rcot_torch/csrc/gram.cu", "rcot_tpu/ops/pallas_gram.py:219"),
    "conv1x1_dw_bwd": ("rcot_torch/csrc/fused_dwconv.cu", "rcot_tpu/ops/pallas_fused.py:415"),
    "gdfn_fused_bwd": ("rcot_torch/csrc/fused_dwconv.cu", "rcot_tpu/ops/pallas_fused.py:415"),
    # the dwconv backward's dx: the forward kernel on the cotangent with the
    # taps rotated (pallas_dwconv.py:120 calls dwconv3x3_fwd)
    "dwconv3x3_dx": ("rcot_torch/csrc/dwconv.cu", "rcot_tpu/ops/pallas_dwconv.py:73"),
    # its dtaps, which the JAX backward sums in jnp (pallas_dwconv.py:121-134)
    "dwconv3x3_dtaps": ("rcot_torch/csrc/dwconv.cu", "rcot_tpu/ops/pallas_dwconv.py:121"),
}
KERNELS = {**FORWARD_KERNELS, **BACKWARD_KERNELS}
# the backward launches of each forward kernel; mdta_attend has none: its
# backward recomputes through the plain formula, as the JAX package's does
# (ops/mdta.py)
BWD_OF = {**{k: (bwd,) for k, bwd in zip(list(FORWARD_KERNELS)[:6], list(BACKWARD_KERNELS)[:6])},
          "dwconv3x3": ("dwconv3x3_dx", "dwconv3x3_dtaps")}
# the attention-side and the FFN-side kernel of each block composition in
# the default depthwise tier (ops/dispatch.py); "dwconv" replaces the fused
# tier's two by the depthwise kernel, and the attention core "gram" runs
# the Gram and the apply, "mdta" the fused attend
COMPOSITION_KERNELS = {"full": ("block_head", "block_tail"),
                       "head": ("block_head", "gdfn_fused"),
                       "tail": ("conv1x1_dw", "block_tail"),
                       "off": ("conv1x1_dw", "gdfn_fused")}
CORE_KERNELS = {"gram": ("mdta_gram_fwd", "attn_apply_fwd"), "mdta": ("mdta_attend",)}
DWCONV_TIER = {"conv1x1_dw": "dwconv3x3", "gdfn_fused": "dwconv3x3"}


def composition_kernels(mode: str, backward: bool = True, core: str = "gram",
                        depthwise: str = "fused") -> list:
    """The kernel launches of one block, a name once per launch."""
    sides = [DWCONV_TIER.get(k, k) if depthwise == "dwconv" else k
             for k in COMPOSITION_KERNELS[mode]]
    fwd = [*sides, *CORE_KERNELS[core]]
    return fwd + ([b for k in fwd for b in BWD_OF.get(k, ())] if backward else [])


def expected_launches(per: int, mode: str, backward: bool = True, core: str = "gram",
                      depthwise: str = "fused") -> dict:
    """{kernel: launches} of `per` blocks in this composition and tier."""
    want: dict = {}
    for k in composition_kernels(mode, backward, core, depthwise):
        want[k] = want.get(k, 0) + per
    return want


# where each kernel's launches in the kernels line are counted, and the
# shapes of its ms: serving's forward (phase 4, serve L1), the training
# iteration in "tail" (phase 6, train L1), one composition of phase 6b, or
# the opt-in tiers' serving (phase 4b, off/mdta/dwconv, serve L1) and
# training (phase 6c, tail/mdta/dwconv, train L1)
LAUNCHES_FROM = {"block_head": "serve", "block_tail": "serve", "mdta_gram_fwd": "serve",
                 "attn_apply_fwd": "serve", "block_head_bwd": "6b full",
                 "gdfn_fused": "6b head", "gdfn_fused_bwd": "6b head",
                 "mdta_attend": "serve opt-in", "dwconv3x3": "serve opt-in",
                 "dwconv3x3_dx": "train opt-in", "dwconv3x3_dtaps": "train opt-in"}
OPT_IN = dict(core="mdta", depthwise="dwconv")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=1)
def _nvml():
    """(NVML, handle of card 0), or None where NVML does not load."""
    try:
        lib = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    handle = ctypes.c_void_p()
    if lib.nvmlInit_v2() or lib.nvmlDeviceGetHandleByIndex_v2(0, ctypes.byref(handle)):
        return None
    return lib, handle


def sm_clock_mhz():
    """The card's SM clock at this moment (NVML_CLOCK_SM), or None."""
    nvml = _nvml()
    mhz = ctypes.c_uint()
    if nvml is None or nvml[0].nvmlDeviceGetClockInfo(nvml[1], 1, ctypes.byref(mhz)):
        return None
    return mhz.value


# ------------------------------------------------------------ inputs

def block_inputs(gen, b, res, c, ln_bias, w=None):
    """Block inputs at (b, res, w or res, c), weights at their init scales."""
    hid = int(c * 2.66)
    m = 3 * c

    def r(*shape, loc=0.0, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale + loc
    return dict(
        x=r(b, res, w or res, c), a=r(b, res, w or res, c),
        ln_w=r(c, loc=1.0, scale=0.1), ln_b=r(c, scale=0.1) if ln_bias else None,
        w_qkv=r(m, c, scale=c ** -0.5), dw_qkv=r(m, 3, 3, scale=0.3),
        w_proj=r(c, c, scale=c ** -0.5), w_in=r(2 * hid, c, scale=c ** -0.5),
        dw_in=r(2 * hid, 3, 3, scale=0.3), w_out=r(c, hid, scale=hid ** -0.5))


def head_args(p):
    return (p["x"], p["ln_w"], p["ln_b"], p["w_qkv"], p["dw_qkv"])


def tail_args(p):
    return tuple(p[k] for k in ("x", "a", "w_proj", "ln_w", "ln_b", "w_in",
                                "dw_in", "w_out"))


def check(name, got, want, errs) -> None:
    """Kernel outputs (a tensor or a tuple) against the plain twin's; the
    largest absolute and relative errors per kernel are kept in errs."""
    kernel = name.split()[0]
    for g, w in zip(*((t,) if torch.is_tensor(t) else t for t in (got, want))):
        if g.shape != w.shape:
            raise AssertionError(f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        worst = errs.setdefault(kernel, [0.0, 0.0])
        worst[0] = max(worst[0], err)
        worst[1] = max(worst[1], err / max(scale, 1.0))
        if not err <= KERNEL_RTOL * max(scale, 1.0):
            raise AssertionError(f"{name}: max|err| {err:.3e} > {KERNEL_RTOL:g} * "
                                 f"max|plain| {scale:.3e}")


# ------------------------------------------------------------ phases

def check_block_fwd(tag, p, errs) -> torch.Tensor:
    """Rows 1-2 on the block inputs p against their float64 twins, and two
    calls on one input bitwise equal (their sums run in a fixed order);
    returns the head's qkv."""
    out = {}
    for name, fn, plain, args in (
            ("block_head", kblock.block_head, kblock.block_head_plain, head_args(p)),
            ("block_tail", kblock.block_tail, kblock.block_tail_plain, tail_args(p))):
        got, again = fn(*args), fn(*args)
        torch.cuda.synchronize()
        check(f"{name} {tag}", got, plain(*_double(args)), errs)
        check_repeats(f"{name} {tag}", (got,), (again,))
        out[name] = got
    return out["block_head"]


def phase_kernels(gen) -> dict:
    """Every kernel against its plain twin at the main-path shapes."""
    errs: dict = {}
    for label, res, c, heads in MAIN_SHAPES:
        for b in (1, 2):
            for ln_bias in (True, False):
                p = block_inputs(gen, b, res, c, ln_bias)
                tag = f"{label} B={b} {'WithBias' if ln_bias else 'BiasFree'}"
                qkv = check_block_fwd(tag, p, errs)
            gram = kgram.mdta_gram_fwd(qkv, heads)
            again = kgram.mdta_gram_fwd(qkv, heads)
            torch.cuda.synchronize()
            exact = kgram.mdta_gram_plain(qkv.double(), heads)
            check(f"mdta_gram_fwd {label} B={b}", gram, exact, errs)
            if not all(torch.equal(x, y) for x, y in zip(gram, again)):
                raise AssertionError(f"mdta_gram_fwd {label} B={b}: two calls differ")
            # the fp32 twin's own rounding, for the record (docstring above)
            fp32_err = max(float((f - e).abs().max() / e.abs().max())
                           for f, e in zip(kgram.mdta_gram_plain(qkv, heads), exact))
            errs["gram_plain_fp32_rel"] = max(errs.get("gram_plain_fp32_rel", 0.0), fp32_err)
            ch = c // heads
            attn = torch.softmax(torch.randn(b, heads, ch, ch, device="cuda",
                                             generator=gen), -1)
            out = kgram.attn_apply_fwd(qkv, attn)
            torch.cuda.synchronize()
            check(f"attn_apply_fwd {label} B={b}", out,
                  kgram.attn_apply_plain(qkv, attn), errs)
            log(f"kernels ok at {label} {res}^2 C={c} heads={heads} B={b}")
    return errs


def shifted(t):
    """A copy of t that starts 4 bytes past its allocation (None stays None)."""
    if t is None:
        return None
    out = torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def drift_inputs(gen, c):
    """Tail inputs at (1, 32, 32, c) whose y is the W_out product alone (x
    = a = 0, so t = 0) over K = h positive terms: LN2(0) = ln_b > 0, and
    W_in, the taps and W_out positive, so that no term cancels and a
    tensor-core accumulation that drifts (rcot_torch/csrc/mm.cuh, mm_kernel)
    shows in full."""
    p = block_inputs(gen, 1, 32, 32, c, True)
    p["x"], p["a"] = torch.zeros_like(p["x"]), torch.zeros_like(p["a"])
    for k in ("ln_b", "w_in", "dw_in", "w_out"):
        p[k] = p[k].abs()
    return p


def phase_block_fwd(gen, errs) -> None:
    """Rows 1-2 beyond serving's shapes, on inputs of their own: every
    training block shape at B = 1 and 2 in both LayerNorm kinds; each block
    shape of the 250x321 image (padded to 256x328) and of the 600x600 image
    in nine 256 px tiles (B = 9) that phase 4 serves; C = 6 (h = 15);
    every operand 4 bytes past its allocation (4-byte copies); and the mma
    chain of the W_out product at K = h = 1,021 on terms that never cancel.
    Each against its float64 twin, two calls bitwise equal; the worst
    errors join errs."""
    cases = [(f"train {label} B={b} {'WithBias' if ln_bias else 'BiasFree'}",
              block_inputs(gen, b, res, c, ln_bias))
             for label, res, c, _ in TRAIN_SHAPES for b in (1, 2) for ln_bias in (True, False)]
    for label, res, c, _ in MAIN_SHAPES:
        f = 256 // res
        for tag, b, h, w in (("250x321", 1, 256 // f, 328 // f), ("600x600 tiles", 9, res, res)):
            cases.append((f"{tag} {label} {(b, h, w, c)}",
                          block_inputs(gen, b, h, c, True, w=w)))
    cases.append(("odd C=6 h=15 (2, 20, 19, 6)", block_inputs(gen, 2, 20, 6, True, w=19)))
    for label, res, c, _ in (TRAIN_SHAPES[0], TRAIN_SHAPES[3]):
        p = {k: shifted(v) for k, v in block_inputs(gen, 2, res, c, True).items()}
        cases.append((f"unaligned train {label} B=2", p))
    cases.append(("mma-chain drift K=h=1021 (1, 32, 32, 384)", drift_inputs(gen, 384)))
    for tag, p in cases:
        check_block_fwd(tag, p, errs)
    log(f"block forward kernels ok at {len(cases)} further cases")


# leading per-pixel outputs of each backward kernel (the rest are pixel sums)
PIXEL_OUTPUTS = {"block_head_bwd": 1, "block_tail_bwd": 2, "conv1x1_dw_bwd": 1,
                 "gdfn_fused_bwd": 1}


def _double(ts):
    return [None if t is None else t.double() for t in ts]


def check_bwd(name, got, plain32, plain64, errs) -> None:
    """Per-pixel outputs against the fp32 twin, pixel sums against the
    float64 twin; None (dln_b of a BiasFree LN) on both sides or neither."""
    kernel = name.split()[0]
    n_pix = PIXEL_OUTPUTS.get(kernel, 1)
    for i, (g, w32, w64) in enumerate(zip(got, plain32, plain64)):
        if (g is None) != (w64 is None):
            raise AssertionError(f"{name}: output {i} is None on one side only")
        if g is not None:
            check(f"{name} out{i}", g, w32 if i < n_pix else w64, errs)


def check_repeats(name, got, again) -> None:
    """Two calls on one input give the same bits (sums in a fixed order)."""
    if not all((x is None and y is None) or torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{name}: two calls differ")


def phase_backward(gen) -> dict:
    """Every backward kernel against its plain twins at the training shapes."""
    errs: dict = {}
    b = TRAIN_B
    for label, res, c, heads in TRAIN_SHAPES:
        for ln_bias in (True, False):
            p = block_inputs(gen, b, res, c, ln_bias)
            tag = f"{label} B={b} {'WithBias' if ln_bias else 'BiasFree'}"
            g = torch.randn(b, res, res, 3 * c, device="cuda", generator=gen)
            args = head_args(p) + (g,)
            got = kblock.block_head_bwd(*args)
            again = kblock.block_head_bwd(*args)
            torch.cuda.synchronize()
            check_bwd(f"block_head_bwd {tag}", got, kblock.block_head_bwd_plain(*args),
                      kblock.block_head_bwd_plain(*_double(args)), errs)
            check_repeats(f"block_head_bwd {tag}", got, again)
            g = torch.randn(b, res, res, c, device="cuda", generator=gen)
            args = tail_args(p) + (g,)
            got = kblock.block_tail_bwd(*args)
            again = kblock.block_tail_bwd(*args)
            torch.cuda.synchronize()
            check_bwd(f"block_tail_bwd {tag}", got, kblock.block_tail_bwd_plain(*args),
                      kblock.block_tail_bwd_plain(*_double(args)), errs)
            check_repeats(f"block_tail_bwd {tag}", got, again)
        ch = c // heads
        qkv = torch.randn(b, res, res, 3 * c, device="cuda", generator=gen)
        cot = [torch.randn(b, heads, ch, ch, device="cuda", generator=gen),
               torch.randn(b, heads, ch, device="cuda", generator=gen),
               torch.randn(b, heads, ch, device="cuda", generator=gen)]
        got = kgram.mdta_gram_bwd(qkv, *cot, heads)
        again = kgram.mdta_gram_bwd(qkv, *cot, heads)
        torch.cuda.synchronize()
        # a tensor-core product: against the fp32 twin and the float64 one
        check(f"mdta_gram_bwd {label} B={b}", got,
              kgram.mdta_gram_bwd_plain(qkv, *cot, heads), errs)
        check(f"mdta_gram_bwd {label} B={b} float64", got,
              kgram.mdta_gram_bwd_plain(*_double([qkv, *cot]), heads), errs)
        attn = torch.softmax(torch.randn(b, heads, ch, ch, device="cuda", generator=gen), -1)
        g = torch.randn(b, res, res, c, device="cuda", generator=gen)
        got_a = kgram.attn_apply_bwd(qkv, attn, g)
        again_a = kgram.attn_apply_bwd(qkv, attn, g)
        torch.cuda.synchronize()
        check_bwd(f"attn_apply_bwd {label} B={b}", got_a,
                  kgram.attn_apply_bwd_plain(qkv, attn, g),
                  kgram.attn_apply_bwd_plain(*_double([qkv, attn, g])), errs)
        # fixed-order sums: two calls on one input give the same bits
        check_repeats(f"mdta_gram_bwd {label} B={b}", (got,), (again,))
        check_repeats(f"attn_apply_bwd {label} B={b}", got_a, again_a)
        log(f"backward kernels ok at {label} {res}^2 C={c} heads={heads} B={b}")
    return errs


def fused_args(p, gdfn):
    """(x, w_in, dwk, w_out) of the qkv configuration or of the GDFN's."""
    if gdfn:
        return (p["x"], p["w_in"], p["dw_in"], p["w_out"])
    return (p["x"], p["w_qkv"], p["dw_qkv"], None)


def phase_fused(gen) -> dict:
    """The fused dwconv tier's kernels, both configurations, forward and
    backward, against their plain twins at every training block shape,
    each bitwise against a second call; then the GDFN's drift case."""
    errs: dict = {}
    b = TRAIN_B
    for label, res, c, heads in TRAIN_SHAPES:
        p = block_inputs(gen, b, res, c, False)
        for gdfn, name in ((False, "conv1x1_dw"), (True, "gdfn_fused")):
            args = fused_args(p, gdfn)
            tag = f"{label} B={b}"
            got, again = kfused.fused_dwconv_fwd(*args), kfused.fused_dwconv_fwd(*args)
            torch.cuda.synchronize()
            check(f"{name} {tag}", got, kfused.fused_dwconv_plain(*args), errs)
            check_repeats(f"{name} {tag}", (got,), (again,))
            g = torch.randn(*got.shape, device="cuda", generator=gen)
            got, again = (kfused.fused_dwconv_bwd(*args, g) for _ in range(2))
            torch.cuda.synchronize()
            check_bwd(f"{name}_bwd {tag}", got, kfused.fused_dwconv_bwd_plain(*args, g),
                      kfused.fused_dwconv_bwd_plain(*_double(args + (g,))), errs)
            check_repeats(f"{name}_bwd {tag}", got, again)
        log(f"fused kernels ok at {label} {res}^2 C={c} B={b}")
    # inputs of their own, so that `gen` reaches the later phases as before
    fused_drift(torch.Generator(device="cuda").manual_seed(5), errs)
    return errs


def fused_drift(gen, errs) -> None:
    """The GDFN at (1, 32, 32, 384) on terms that never cancel: x, W_in, the
    taps, W_out and the cotangent positive, so that conv, the gate, dgate,
    dconv and dh are too, and a tensor-core accumulation that drifts
    (rcot_torch/csrc/mm.cuh, mm_kernel) shows in full in the W_out product
    (K = h = 1,021) and the dx product (K = 2h = 2,042). Every output
    against the float64 twin."""
    p = {k: v.abs() if v is not None else None
         for k, v in block_inputs(gen, 1, 32, 384, False).items()}
    args = fused_args(p, True)
    tag = "mma-chain drift K=h=1021, 2h=2042 (1, 32, 32, 384)"
    got = kfused.fused_dwconv_fwd(*args)
    g = torch.rand(*got.shape, device="cuda", generator=gen)
    grads = kfused.fused_dwconv_bwd(*args, g)
    torch.cuda.synchronize()
    check(f"gdfn_fused {tag}", got, kfused.fused_dwconv_plain(*_double(args)), errs)
    check(f"gdfn_fused_bwd {tag}", grads,
          kfused.fused_dwconv_bwd_plain(*_double(args + (g,))), errs)
    log(f"fused kernels ok on the {tag}")


def phase_block_wide(gen, errs) -> None:
    """Rows 1-2 and 5 at C = 576 and 768 on (1, 12, 12, C), both LayerNorm
    kinds: past the 512 channels that a warp's registers hold, the
    LayerNorm walks its channels in device memory (and its backward keeps
    48-96 KB of partials in shared memory). Forward against the float64
    twin, backward as phase 3b holds it, two calls bitwise equal."""
    for c in (576, 768):
        for ln_bias in (True, False):
            p = block_inputs(gen, 1, 12, c, ln_bias)
            tag = f"wide C={c} (1, 12, 12, {c}) {'WithBias' if ln_bias else 'BiasFree'}"
            check_block_fwd(tag, p, errs)
            for name, fn, plain, args, width in (
                    ("block_head_bwd", kblock.block_head_bwd, kblock.block_head_bwd_plain,
                     head_args(p), 3 * c),
                    ("block_tail_bwd", kblock.block_tail_bwd, kblock.block_tail_bwd_plain,
                     tail_args(p), c)):
                g = torch.randn(1, 12, 12, width, device="cuda", generator=gen)
                got, again = fn(*args, g), fn(*args, g)
                torch.cuda.synchronize()
                check_bwd(f"{name} {tag}", got, plain(*args, g),
                          plain(*_double(args + (g,))), errs)
                check_repeats(f"{name} {tag}", got, again)
        log(f"block kernels ok at C={c} (1, 12, 12, {c})")


def phase_opt_in_kernels(gen) -> dict:
    """The opt-in tiers' kernels against their plain twins: mdta_attend
    (against its float64 twin: its Gram and norms are pixel sums over every
    pixel, as the Gram core's) at every serving block shape, B = 1 and 2,
    and every training one, B = 3, each bitwise against a second call (its
    sums run in a fixed order), then at the 250x321 image's N unpadded
    (80,250: N % 4 == 2, 4-byte copies; served, the image is padded to
    256x328) and at an odd N; dwconv3x3 at the qkv width (3C) and the
    GDFN's (2h) at the same shapes, and its backward there: dx (the
    dwconv3x3_dx launch) against the fp32 twin, dtaps (the dwconv3x3_dtaps
    launch, a pixel sum) against the float64 twin and bitwise against a
    second call (its sums run in a fixed order)."""
    errs: dict = {}
    cases = [(label, res, c, heads, b) for label, res, c, heads in MAIN_SHAPES
             for b in (1, 2)]
    cases += [(f"train {label}", res, c, heads, TRAIN_B)
              for label, res, c, heads in TRAIN_SHAPES]

    def r(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale
    for label, res, c, heads, b in cases:
        tag = f"{label} {res}^2 C={c} heads={heads} B={b}"
        q, k, v = (r(b, heads, c // heads, res * res) for _ in range(3))
        temp = torch.rand(heads, 1, 1, device="cuda", generator=gen) * 1.5 + 0.5
        got, again = kmdta.mdta_attend_fwd(q, k, v, temp), kmdta.mdta_attend_fwd(q, k, v, temp)
        torch.cuda.synchronize()
        check(f"mdta_attend {tag}", got, kmdta.mdta_attend_plain(*_double([q, k, v, temp])),
              errs)
        check_repeats(f"mdta_attend {tag}", (got,), (again,))
        for width in (3 * c, 2 * int(c * 2.66)):
            x, g = r(b, res, res, width), r(b, res, res, width)
            taps = r(width, 3, 3, scale=0.3)
            got = kdw.dwconv3x3_fwd(x, taps)
            torch.cuda.synchronize()
            check(f"dwconv3x3 {tag} width {width}", got, kdw.dwconv3x3_plain(x, taps), errs)
            dx, dtaps = kdw.dwconv3x3_bwd(x, taps, g)
            again = kdw.dwconv3x3_dtaps(x, g)
            torch.cuda.synchronize()
            check(f"dwconv3x3_dx {tag} width {width}", dx,
                  kblock._vjp_plain(kdw.dwconv3x3_plain, (x, taps), g)[0], errs)
            check(f"dwconv3x3_dtaps {tag} width {width}", dtaps,
                  kdw.dwconv3x3_dtaps_plain(x.double(), g.double()), errs)
            if not torch.equal(dtaps, again):
                raise AssertionError(f"dwconv3x3_dtaps {tag} width {width}: two calls differ")
        log(f"opt-in kernels ok at {tag}")
    for n in (250 * 321, 125 * 161):
        q, k, v = (r(1, 1, 48, n) for _ in range(3))
        temp = torch.rand(1, 1, 1, device="cuda", generator=gen) + 0.5
        got, again = kmdta.mdta_attend_fwd(q, k, v, temp), kmdta.mdta_attend_fwd(q, k, v, temp)
        torch.cuda.synchronize()
        tag = f"N={n} (1, 1, 48, {n})"
        check(f"mdta_attend {tag}", got, kmdta.mdta_attend_plain(*_double([q, k, v, temp])),
              errs)
        check_repeats(f"mdta_attend {tag}", (got,), (again,))
        log(f"mdta_attend ok at {tag}")
    return errs


# (label, (b, h, w), heads, ch) past 128 channels a head: ModelConfig(heads=
# (1, 1, 1, 1))'s level-3 and latent heads (192, 384) at 256 px, B = 1, and
# in training, 128 px, B = 3; two blocks of 68 (136), and of 75 (150, no
# multiple of 4: 4-byte copies)
WIDE_HEADS = [("serve L3 one head", (1, 64, 64), 1, 192),
              ("serve latent one head", (1, 32, 32), 1, 384),
              ("train L3 one head", (TRAIN_B, 32, 32), 1, 192),
              ("train latent one head", (TRAIN_B, 16, 16), 1, 384),
              ("ch=136", (2, 24, 20), 2, 136), ("ch=150", (2, 33, 7), 1, 150)]


def phase_wide_heads(gen, errs) -> None:
    """Rows 3-4, 6-7 and 10 at heads wider than 128 channels (WIDE_HEADS),
    which run as blocks of at most 128 (csrc/gram.cu, csrc/mdta.cu): every
    output against its float64 twin, two calls bitwise equal, one count a
    call. The worst errors join errs."""
    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    for label, (b, h, w), heads, ch in WIDE_HEADS:
        qkv, g = r(b, h, w, 3 * heads * ch), r(b, h, w, heads * ch)
        attn = torch.softmax(r(b, heads, ch, ch), -1)
        cot = [r(b, heads, ch, ch), r(b, heads, ch), r(b, heads, ch)]
        q, k, v = (r(b, heads, ch, h * w) for _ in range(3))
        temp = torch.rand(heads, 1, 1, device="cuda", generator=gen) + 0.5
        calls = {
            "mdta_gram_fwd": (lambda: kgram.mdta_gram_fwd(qkv, heads),
                              lambda: kgram.mdta_gram_plain(qkv.double(), heads)),
            "attn_apply_fwd": (lambda: kgram.attn_apply_fwd(qkv, attn),
                               lambda: kgram.attn_apply_plain(*_double([qkv, attn]))),
            "mdta_gram_bwd": (lambda: kgram.mdta_gram_bwd(qkv, *cot, heads),
                              lambda: kgram.mdta_gram_bwd_plain(*_double([qkv, *cot]), heads)),
            "attn_apply_bwd": (lambda: kgram.attn_apply_bwd(qkv, attn, g),
                               lambda: kgram.attn_apply_bwd_plain(*_double([qkv, attn, g]))),
            "mdta_attend": (lambda: kmdta.mdta_attend_fwd(q, k, v, temp),
                            lambda: kmdta.mdta_attend_plain(*_double([q, k, v, temp]))),
        }
        tag = f"{label} {(b, h, w)} heads={heads} ch={ch}"
        for name, (kernel, plain) in calls.items():
            n0 = build.LAUNCHES[name]
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            if build.LAUNCHES[name] != n0 + 2:
                raise AssertionError(f"{name} {tag}: {build.LAUNCHES[name] - n0} counts "
                                     "for two calls")
            check(f"{name} {tag}", got, plain(), errs)
            check_repeats(f"{name} {tag}", got if isinstance(got, tuple) else (got,),
                          again if isinstance(again, tuple) else (again,))
        log(f"MDTA kernels ok at {tag}")


def phase_sum_drift(gen, errs) -> dict:
    """The pixel sums of rows 3, 7 and 10 on terms that never cancel, the
    attention core's counterpart of drift_inputs: q, k, v and the cotangent
    uniform in [0, 1) at 256^2, B = 1, one head, so that each (b, head) is
    cut into 128 ranges of 512 pixels, the most a range holds, and a
    tensor-core accumulation that drifts toward zero shows in full: the
    Gram's G (row 3), dattn (row 7) and row 10's output, whose Gram is such
    a sum, each against its float64 twin at ch = 48, 96 and 128 (a warp's
    chain holds 128 pixels of a range at 48 and all 512 at 96 and 128).
    -> {"<kernel> ch=<ch>": max|err| / max(max|float64|, 1)}; the worst
    errors join errs."""
    out = {}
    for ch in (48, 96, 128):
        qkv = torch.rand(1, 256, 256, 3 * ch, device="cuda", generator=gen)
        g = torch.rand(1, 256, 256, ch, device="cuda", generator=gen)
        attn = torch.softmax(torch.randn(1, 1, ch, ch, device="cuda", generator=gen), -1)
        q, k, v = (t.reshape(1, 1, 256 * 256, ch).transpose(2, 3).contiguous()
                   for t in qkv.split(ch, dim=-1))
        temp = torch.ones(1, 1, 1, device="cuda")
        for name, got, want in (
                ("mdta_gram_fwd", kgram.mdta_gram_fwd(qkv, 1)[0],
                 kgram.mdta_gram_plain(qkv.double(), 1)[0]),
                ("attn_apply_bwd", kgram.attn_apply_bwd(qkv, attn, g)[1],
                 kgram.attn_apply_bwd_plain(*_double([qkv, attn, g]))[1]),
                ("mdta_attend", kmdta.mdta_attend_fwd(q, k, v, temp),
                 kmdta.mdta_attend_plain(*_double([q, k, v, temp])))):
            torch.cuda.synchronize()
            out[f"{name} ch={ch}"] = float((got.double() - want).abs().max()
                                           / max(float(want.abs().max()), 1.0))
            check(f"{name} sum drift 512-pixel ranges ch={ch}", got, want, errs)
    log(f"pixel sums on non-cancelling terms, max|err| / max(max|float64|, 1): "
        f"{json.dumps(out)}")
    return out


def phase_model(gen_np) -> dict:
    cfg = ModelConfig()
    t0 = time.perf_counter()
    net = TNet(cfg, device="cuda", seed=0).eval()
    n_params = count_params(net)
    if n_params != 46_853_150:
        raise AssertionError(f"T_net has {n_params} parameters, not 46,853,150")
    log(f"T_net built: {n_params} parameters, seeded weights "
        f"({time.perf_counter() - t0:.1f} s)")
    restorer = make_restorer(net, cfg, device="cuda")
    tiled = make_restorer(net, cfg, tile=256, tile_overlap=32, device="cuda")
    forwards = [0]
    for r in (restorer, tiled):
        fn = r.model_fn

        def counted(x, fn=fn):
            forwards[0] += 1
            return fn(x)
        r.model_fn = counted

    imgs = [gen_np.uniform(0, 1, (256, 256, 3)).astype(np.float32) for _ in range(3)]
    imgs.append(gen_np.uniform(0, 1, (250, 321, 3)).astype(np.float32))
    big = gen_np.uniform(0, 1, (600, 600, 3)).astype(np.float32)

    # ---- the main path, counted
    build.reset_launches()
    outs = restorer.restore_batch(imgs)
    out_big = tiled(big)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    n_fwd = forwards[0]
    for im, o in zip(imgs + [big], outs + [out_big]):
        if o.shape != im.shape or not np.isfinite(o).all():
            raise AssertionError(f"bad output {o.shape} for input {im.shape}")
    if n_fwd == 0:
        raise AssertionError("the restorer ran no forward")
    check_launches("serving", launches,
                   expected_launches(FORWARD_LAUNCHES * n_fwd, "full", backward=False))
    log(f"main path: {n_fwd} two-pass forwards, launches {launches}")

    # ---- agreement with the same model on the CPU
    x = torch.from_numpy(gen_np.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32))
    with torch.inference_mode():
        on_card = net(x.cuda())
        cpu_net = TNet(cfg, device="cpu", seed=None).eval()
        cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
        on_cpu = cpu_net(x)
    for name, a, b in zip(("out2", "out1", "res"), on_card, on_cpu):
        a = a.cpu()
        err = float((a - b).abs().max())
        log(f"card vs CPU 128^2 {name}: max|err| {err:.3e}")
        torch.testing.assert_close(a, b, atol=MODEL_ATOL, rtol=MODEL_RTOL)
    del cpu_net

    # ---- the reference golden (reference PyTorch model, tools/make_goldens.py)
    golden_err = golden_check()
    return dict(net=net, restorer=restorer, launches=launches, n_fwd=n_fwd,
                golden_err=golden_err)


def counting(restorer):
    """Wrap the restorer's model_fn; returns the list holding its count."""
    forwards = [0]
    fn = restorer.model_fn

    def counted(x):
        forwards[0] += 1
        return fn(x)
    restorer.model_fn = counted
    return forwards


def phase_serve_opt_in(gen_np, net, card) -> dict:
    """The same full-width T_net served through make_restorer in
    composition "off" with the fused MDTA attend and the standalone
    depthwise kernel (the JAX package's RCOT_INFER_BLOCK=off
    RCOT_PALLAS_FUSED=0 RCOT_PALLAS_DWCONV=1 RCOT_PALLAS_MDTA=1): 94
    launches of mdta_attend and 188 of dwconv3x3 per two-pass forward and
    no other kernel; the outputs against serving's default on the same
    weights; img/s at 256 px, batch 1 and 8."""
    cfg = ModelConfig()
    opt = make_restorer(net, cfg, device="cuda", composition="off",
                        attention_core="mdta", depthwise="dwconv")
    default = make_restorer(net, cfg, device="cuda")
    forwards = counting(opt)
    imgs = [gen_np.uniform(0, 1, (256, 256, 3)).astype(np.float32) for _ in range(2)]
    imgs.append(gen_np.uniform(0, 1, (250, 321, 3)).astype(np.float32))

    # ---- the main path of this tier, counted
    build.reset_launches()
    outs = opt.restore_batch(imgs)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    check_launches("serving off/mdta/dwconv", launches,
                   expected_launches(FORWARD_LAUNCHES * forwards[0], "off", False, **OPT_IN))
    log(f"serving off/mdta/dwconv: {forwards[0]} two-pass forwards, launches {launches}")
    worst = 0.0
    for im, o, w in zip(imgs, outs, default.restore_batch(imgs)):
        if o.shape != im.shape or not np.isfinite(o).all():
            raise AssertionError(f"bad output {o.shape} for input {im.shape}")
        worst = max(worst, float(np.abs(o - w).max()))
        torch.testing.assert_close(torch.from_numpy(o), torch.from_numpy(w),
                                   atol=MODEL_ATOL, rtol=MODEL_RTOL)
    log(f"serving off/mdta/dwconv vs full/gram/fused: max|err| {worst:.3e}")
    ips1 = images_per_sec(opt, gen_np, 1, 10)
    ips8 = images_per_sec(opt, gen_np, 8, 3)
    log(f"256px restore_batch in off/mdta/dwconv: {ips1:.3f} img/s at batch 1, "
        f"{ips8:.3f} img/s at batch 8 ({card})")
    return dict(launches=launches, n_fwd=forwards[0], max_abs_err_vs_default=worst,
                batch1_img_per_s=ips1, batch8_img_per_s=ips8)


def check_launches(tag: str, launches: dict, want: dict) -> None:
    """Each kernel launched as often as `want` says, every other none."""
    bad = {name: launches.get(name, 0) for name in ALL_KERNELS
           if launches.get(name, 0) != want.get(name, 0)}
    if bad:
        raise AssertionError(f"{tag}: launches {bad}, want {want} and none of the others")


def sum_launches(*wants: dict) -> dict:
    out: dict = {}
    for want in wants:
        for k, n in want.items():
            out[k] = out.get(k, 0) + n
    return out


def golden_check() -> float:
    z = np.load(Path(__file__).resolve().parent / "tests" / "goldens" / "tnet_full.npz")
    sd = {}
    for n, s in zip(z["names"], z["shapes"]):
        n = str(n)
        shape = tuple(int(v) for v in str(s).split(","))
        rng = np.random.default_rng(zlib.crc32(n.encode()) & 0xFFFFFFFF)
        sd[n] = torch.from_numpy((rng.standard_normal(shape) * 0.02).astype(np.float32))
    net = TNet(ModelConfig(), device="cuda", seed=None).eval()
    net.load_state_dict(sd, strict=True)
    x = torch.from_numpy(np.transpose(z["input"], (0, 2, 3, 1)).copy()).cuda()
    with torch.inference_mode():
        out2 = net(x)[0].permute(0, 3, 1, 2).cpu()
    want = torch.from_numpy(z["out2"])
    err = float((out2 - want).abs().max())
    log(f"golden 32^2 out2 on the card: max|err| {err:.3e}")
    torch.testing.assert_close(out2, want, atol=MODEL_ATOL, rtol=MODEL_RTOL)
    return err


# ------------------------------------------------------------ timing

def cuda_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3, tries=8) -> tuple:
    """(device time of one call, device records per call): the durations
    of the CUDA kernels, memsets and copies that `iters` back-to-back calls
    put on the card, read with torch.profiler (CUDA activity), and their
    number, each over `iters`. Launch gaps and the wrapper's host work are
    not in it; `cuda_ms` (events around the calls) keeps them. Every call
    puts the same records on the card, so a window whose records are not a
    whole number per call lost some: the profiler did so in a few windows
    of a run, in nearly every one after the training phases (so every
    kernel is timed before them), and in none at all about once in a few
    hundred (PERF.md). Such a window is taken again, up to `tries`,
    and the fullest is kept; `device_records` shows what was kept."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best: list = []
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(spans) > len(best):
            best = spans
        if spans and len(spans) % iters == 0:
            break
    if not best:
        raise RuntimeError(f"torch.profiler recorded no device activity in {tries} windows")
    return sum(best) / iters / 1e3, len(best) / iters


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_timings(gen, label, res, c, heads, b, names) -> dict:
    """Each kernel of `names` at one block shape: its time (`ms`, events
    around back-to-back calls, host included, and `device_ms`, the card's
    busy time alone), its plain twin's, its bound and, where one PyTorch
    call (or one per output) computes the same products, that call's time
    on pre-transposed tensors, both ways."""
    n = res * res
    p = block_inputs(gen, b, res, c, True)
    m, hid, ch, bh = 3 * c, int(c * 2.66), c // heads, b * heads
    qkv = kblock.block_head_fwd(*head_args(p))
    attn = torch.softmax(torch.randn(b, heads, ch, ch, device="cuda", generator=gen), -1)
    r = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)  # noqa: E731
    g_head, g_c = r(b, res, res, m), r(b, res, res, c)
    dgram, dnq, dnk = r(b, heads, ch, ch), r(b, heads, ch), r(b, heads, ch)

    def heads_t(t, transpose):  # (B,H,W,C) slice -> (bh, ch, n) or (bh, n, ch)
        t = t.reshape(b, n, heads, ch)
        return (t.permute(0, 2, 3, 1) if transpose else t.permute(0, 2, 1, 3)
                ).reshape(bh, *((ch, n) if transpose else (n, ch))).contiguous()
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    qt, kn, vt = heads_t(q, True), heads_t(k, False), heads_t(v, True)
    qn, vn, gn, gt = heads_t(q, False), heads_t(v, False), heads_t(g_c, False), heads_t(g_c, True)
    at, dg = attn.reshape(bh, ch, ch), dgram.reshape(bh, ch, ch)
    qd = 2 * qn * dnq.reshape(bh, 1, ch)
    kd = 2 * kn * dnk.reshape(bh, 1, ch)
    dgt = dg.transpose(1, 2).contiguous()
    f4 = 4.0
    w_head = m * c + 9 * m + 2 * c
    w_tail = c * c + 2 * c + 3 * hid * c + 18 * hid
    rows = {
        "block_head": (lambda: kblock.block_head_fwd(*head_args(p)),
                       lambda: kblock.block_head_plain(*head_args(p)), None,
                       b * n * (2 * c * m + 18 * m + 8 * c),
                       f4 * (b * n * (c + m) + w_head)),
        "block_tail": (lambda: kblock.block_tail_fwd(*tail_args(p)),
                       lambda: kblock.block_tail_plain(*tail_args(p)), None,
                       b * n * (2 * c * c + 4 * c * hid + 2 * hid * c + 36 * hid
                                + 10 * hid + 10 * c),
                       f4 * (3 * b * n * c + w_tail)),
        "mdta_gram_fwd": (lambda: kgram.mdta_gram_fwd(qkv, heads),
                          lambda: kgram.mdta_gram_plain(qkv, heads),
                          lambda: torch.bmm(qt, kn),
                          b * n * (2 * c * ch + 4 * c),
                          f4 * (b * n * 2 * c + bh * (ch * ch + 2 * ch))),
        "attn_apply_fwd": (lambda: kgram.attn_apply_fwd(qkv, attn),
                           lambda: kgram.attn_apply_plain(qkv, attn),
                           lambda: torch.bmm(at, vt),
                           b * n * 2 * c * ch,
                           f4 * (2 * b * n * c + bh * ch * ch)),
        # recompute of the forward included; stencils 18 flops per tap set
        "block_head_bwd": (lambda: kblock.block_head_bwd(*head_args(p), g_head),
                           lambda: kblock.block_head_bwd_plain(*head_args(p), g_head), None,
                           b * n * (6 * c * m + 36 * m + 18 * c),
                           f4 * (b * n * (2 * c + m) + 2 * w_head)),
        "block_tail_bwd": (lambda: kblock.block_tail_bwd(*tail_args(p), g_c),
                           lambda: kblock.block_tail_bwd_plain(*tail_args(p), g_c), None,
                           b * n * (6 * c * c + 16 * c * hid + 128 * hid + 18 * c),
                           f4 * (5 * b * n * c + 2 * w_tail)),
        "mdta_gram_bwd": (lambda: kgram.mdta_gram_bwd(qkv, dgram, dnq, dnk, heads),
                          lambda: kgram.mdta_gram_bwd_plain(qkv, dgram, dnq, dnk, heads),
                          lambda: (torch.baddbmm(qd, kn, dgt), torch.baddbmm(kd, qn, dg)),
                          b * n * (4 * c * ch + 4 * c),
                          f4 * (4 * b * n * c + bh * (ch * ch + 2 * ch))),
        "attn_apply_bwd": (lambda: kgram.attn_apply_bwd(qkv, attn, g_c),
                           lambda: kgram.attn_apply_bwd_plain(qkv, attn, g_c),
                           lambda: (torch.bmm(gn, at), torch.bmm(gt, vn)),
                           b * n * 4 * c * ch,
                           f4 * (3 * b * n * c + 2 * bh * ch * ch)),
        # the fused dwconv tier: the qkv configuration (M = 3C) and the
        # GDFN's (2h, gelu ~10 flops per gate); backwards with the recompute
        "conv1x1_dw": (lambda: kfused.fused_dwconv_fwd(*fused_args(p, False)),
                       lambda: kfused.fused_dwconv_plain(*fused_args(p, False)), None,
                       b * n * (2 * c * m + 18 * m),
                       f4 * (b * n * (c + m) + m * c + 9 * m)),
        "gdfn_fused": (lambda: kfused.fused_dwconv_fwd(*fused_args(p, True)),
                       lambda: kfused.fused_dwconv_plain(*fused_args(p, True)), None,
                       b * n * (4 * c * hid + 36 * hid + 10 * hid + 2 * hid * c),
                       f4 * (2 * b * n * c + 3 * hid * c + 18 * hid)),
        "conv1x1_dw_bwd": (lambda: kfused.fused_dwconv_bwd(*fused_args(p, False), g_head),
                           lambda: kfused.fused_dwconv_bwd_plain(*fused_args(p, False),
                                                                 g_head), None,
                           b * n * (6 * c * m + 36 * m),
                           f4 * (b * n * (2 * c + m) + 2 * (m * c + 9 * m))),
        "gdfn_fused_bwd": (lambda: kfused.fused_dwconv_bwd(*fused_args(p, True), g_c),
                           lambda: kfused.fused_dwconv_bwd_plain(*fused_args(p, True), g_c),
                           None,
                           b * n * (16 * c * hid + 128 * hid),
                           f4 * (3 * b * n * c + 2 * (3 * hid * c + 18 * hid))),
    }
    # the opt-in tiers: the fused attend on the transposed heads, and the
    # depthwise kernel and its dx at the GDFN width (2h) and the qkv width
    # (3C), and its dtaps at 3C, the width the training path runs it at;
    # their inputs come from a generator of their own, so that `gen`
    # reaches the later phases in the state it did before these rows were
    # added
    q4, k4, v4 = (t.reshape(b, heads, ch, n) for t in (qt, heads_t(k, True), vt))
    own = torch.Generator(device="cuda").manual_seed(res * 1000 + c + b)
    temp = torch.rand(heads, 1, 1, device="cuda", generator=own) + 0.5
    qh = qt / qt.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    kh = kn / kn.norm(dim=1, keepdim=True).clamp_min(1e-12)
    x_g, g_g, taps_g = (torch.randn(*shape, device="cuda", generator=own) for shape in
                        ((b, res, res, 2 * hid), (b, res, res, 2 * hid), (2 * hid, 3, 3)))
    x_m, taps_m = qkv, p["dw_qkv"]

    def dw_row(x, taps, kern):
        w = x.shape[-1]
        return (lambda: kern(x, taps), lambda: kdw.dwconv3x3_plain(x, taps),
                lambda: F.conv2d(x.permute(0, 3, 1, 2), taps.reshape(w, 1, 3, 3),
                                 padding=1, groups=w),
                b * n * 18 * w, f4 * (2 * b * n * w + 9 * w))

    def dtaps_row(x, g, taps):  # the library: cuDNN's weight gradient alone
        w = x.shape[-1]
        xn, gn, w4 = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2), taps.reshape(w, 1, 3, 3)
        return (lambda: kdw.dwconv3x3_dtaps(x, g), lambda: kdw.dwconv3x3_dtaps_plain(x, g),
                lambda: torch.ops.aten.convolution_backward(
                    gn, xn, w4, None, [1, 1], [1, 1], [1, 1], False, [0, 0], w,
                    [False, True, False]),
                b * n * 18 * w, f4 * (2 * b * n * w + 9 * w))
    rows.update({
        # no one call computes the attend: two_bmm_ms below times q_hat k_hat^T
        # and attn v on pre-normalised, pre-transposed heads, as rows 3-4 do
        "mdta_attend": (lambda: kmdta.mdta_attend_fwd(q4, k4, v4, temp),
                        lambda: kmdta.mdta_attend_plain(q4, k4, v4, temp), None,
                        b * n * (4 * c * ch + 4 * c), f4 * (4 * b * n * c + heads)),
        "dwconv3x3": dw_row(x_g, taps_g, kdw.dwconv3x3_fwd),
        "dwconv3x3_qkv": dw_row(x_m, taps_m, kdw.dwconv3x3_fwd),
        "dwconv3x3_dx": dw_row(g_g, taps_g, kdw.dwconv3x3_dx),
        "dwconv3x3_dx_qkv": dw_row(g_head, taps_m, kdw.dwconv3x3_dx),
        "dwconv3x3_dtaps": dtaps_row(x_m, g_head, taps_m),
    })
    # the sums over a block's pixel range (G, dattn, dtaps): their error
    # against the float64 twin, max|kernel - float64| / max|float64|
    sums = {"dwconv3x3_dtaps": (lambda: kdw.dwconv3x3_dtaps(x_m, g_head),
                                lambda: kdw.dwconv3x3_dtaps_plain(x_m.double(),
                                                                  g_head.double())),
            "mdta_gram_fwd": (lambda: kgram.mdta_gram_fwd(qkv, heads)[0],
                              lambda: kgram.mdta_gram_plain(qkv.double(), heads)[0]),
            "attn_apply_bwd": (lambda: kgram.attn_apply_bwd(qkv, attn, g_c)[1],
                               lambda: kgram.attn_apply_bwd_plain(
                                   *_double([qkv, attn, g_c]))[1])}
    out = {}
    for name in names:
        kern, plain, lib, flops, nbytes = rows[name]
        bms, by = bound(flops, nbytes)
        ms = cuda_ms(kern)
        dev, records = device_ms(kern)
        # sm_mhz: the SM clock read just after the device_ms window
        out[name] = dict(shape=f"{label} {res}^2 C={c} heads={heads} B={b}",
                         ms=ms, device_ms=dev, device_records=records, sm_mhz=sm_clock_mhz(),
                         plain_ms=cuda_ms(plain, iters=5), bound_ms=bms, bound_by=by,
                         library_ms=cuda_ms(lib) if lib else None,
                         library_device_ms=device_ms(lib)[0] if lib else None)
        if name in sums:
            got, want = (f() for f in sums[name])
            out[name]["sum_rel_err"] = float((got.double() - want).abs().max()
                                             / want.abs().max())
    if "mdta_attend" in names:
        out["mdta_attend"]["two_bmm_ms"] = cuda_ms(lambda: (torch.bmm(qh, kh),
                                                            torch.bmm(at, vt)))
    return out


def images_per_sec(restorer, gen_np, batch, iters) -> float:
    imgs = [gen_np.uniform(0, 1, (256, 256, 3)).astype(np.float32) for _ in range(batch)]
    for _ in range(2):
        restorer.restore_batch(imgs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        restorer.restore_batch(imgs)
    torch.cuda.synchronize()
    return batch * iters / (time.perf_counter() - t0)


def forward_breakdown(gen, net, timings) -> dict:
    """Device time of one two-pass forward at 256 px, batch 1, beside each
    kernel's time at every block shape times the blocks at that shape; the
    rest is the convolutions, resamplers, glue and launch gaps outside them."""
    x = torch.rand(1, 256, 256, 3, device="cuda", generator=gen)
    with torch.inference_mode():
        fwd = cuda_ms(lambda: net(x), iters=10, warmup=2)
    per_kernel, per_kernel_device = ({
        name: sum(BLOCKS_PER_FORWARD[label] * timings[label][name][key]
                  for label in BLOCKS_PER_FORWARD)
        for name in composition_kernels("full", backward=False)} for key in ("ms", "device_ms"))
    return dict(forward_ms=fwd, kernels_ms=per_kernel, kernels_device_ms=per_kernel_device,
                outside_kernels_ms=fwd - sum(per_kernel.values()))


# ------------------------------------------------------------ bf16 serving

# bf16 serving's kernels (rows 1-4 in bf16: csrc/block_fwd_bf16.cu,
# csrc/gram_bf16.cu), counted apart from the fp32 rows
BF16_KERNELS = {
    "block_head_bf16": ("rcot_torch/csrc/block_fwd_bf16.cu", "rcot_tpu/ops/pallas_block.py:586"),
    "block_tail_bf16": ("rcot_torch/csrc/block_fwd_bf16.cu", "rcot_tpu/ops/pallas_block.py:597"),
    "mdta_gram_fwd_bf16": ("rcot_torch/csrc/gram_bf16.cu", "rcot_tpu/ops/pallas_gram.py:99"),
    "attn_apply_fwd_bf16": ("rcot_torch/csrc/gram_bf16.cu", "rcot_tpu/ops/pallas_gram.py:178"),
}
# bf16 training's forms (csrc/fused_dwconv_bf16.cu, block_bwd_bf16.cu,
# gram_bwd_bf16.cu), and every kernel of one bf16 "tail" iteration
BF16_TRAIN_KERNELS = {
    "conv1x1_dw_bf16": ("rcot_torch/csrc/fused_dwconv_bf16.cu",
                        "rcot_tpu/ops/pallas_fused.py:238"),
    "conv1x1_dw_bwd_bf16": ("rcot_torch/csrc/fused_dwconv_bf16.cu",
                            "rcot_tpu/ops/pallas_fused.py:415"),
    "block_tail_bwd_bf16": ("rcot_torch/csrc/block_bwd_bf16.cu",
                            "rcot_tpu/ops/pallas_block.py:401"),
    "mdta_gram_bwd_bf16": ("rcot_torch/csrc/gram_bwd_bf16.cu",
                           "rcot_tpu/ops/pallas_gram.py:141"),
    "attn_apply_bwd_bf16": ("rcot_torch/csrc/gram_bwd_bf16.cu",
                            "rcot_tpu/ops/pallas_gram.py:219"),
}
BF16_TRAIN_PATH = ("conv1x1_dw_bf16", "block_tail_bf16", "mdta_gram_fwd_bf16",
                   "attn_apply_fwd_bf16", "block_tail_bwd_bf16", "mdta_gram_bwd_bf16",
                   "attn_apply_bwd_bf16", "conv1x1_dw_bwd_bf16")
ALL_KERNELS = {**KERNELS, **BF16_KERNELS, **BF16_TRAIN_KERNELS}
PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16 on the tensor cores, dense
# Gates of the bf16 phase. A bf16 output of
# a kernel rounds where its plain twin rounds, from fp32 sums taken in
# another order: where a sum falls next to a rounding boundary the two
# round apart, by one bf16 ulp there, and later stages carry that on. So a
# bf16 output is held within BF16_RTOL * max(max|plain|, 1), four bf16 ulps
# of the largest value (the share of elements that differ at all is
# printed); the Gram's outputs are fp32 sums of exact products, held within
# KERNEL_RTOL against the float64 twin as the fp32 rows are. The forward on
# the card against the CPU (both bf16) is held, as the CPU tests hold the
# port against the JAX package (tests/test_torch_bf16.py), to a quarter of
# what bf16 changes on the mean: mean|card - CPU| <= mean|fp32 - bf16| / 4
# (a flip that reaches the bf16 output makes its difference an ulp there,
# about max|fp32 - bf16|, so the largest difference is held to BF16_RTOL
# alone), and the CLI's per-image PSNR to BF16_PSNR_DB.
BF16_RTOL = 2.0 ** -6
BF16_PSNR_DB = 0.02
BF16 = torch.bfloat16
# bf16 training's fp32 outputs are held against the float64 twin: row 7's
# dattn (a pixel sum of widened bf16 values, no rounding point before it)
# within KERNEL_RTOL of max(max|twin|, 1), row 5's dln_w and dln_b within
# BF16_FLIP_RTOL of it. Those follow bf16 rounding points (t, u, h), and
# where the kernel's, the twin's and float64's fp32 sums fall on either side
# of a rounding boundary they round a value one bf16 ulp apart, which the
# pixel sums carry: 1.2e-4 of the largest entry on the card at C = 192, the
# fp32 twin itself 2.9e-4 from float64 there.
BF16_FLIP_RTOL = 1e-3
BF16_TRAIN_F32_RTOL = {"block_tail_bwd_bf16": BF16_FLIP_RTOL,
                       "attn_apply_bwd_bf16": KERNEL_RTOL}
# bf16 training on the whole model (the card against the CPU): the quarter
# rule on the mean taken over every gradient entry together, sum|card - CPU
# bf16| <= BF16_MODEL_RATIO * sum|CPU fp32 - CPU bf16|. Per tensor it cannot
# hold: an MDTA temperature's gradient is a cancelling sum of a few entries,
# and the flips above, through both passes and the backward, reach almost
# every gradient entry (measured on the card 1.6 of the gap at a
# temperature, 0.17 at the median tensor, 0.016 summed; a run in fp32 by
# mistake reads about 1).
BF16_MODEL_RATIO = 0.25


def bf16_block_inputs(p):
    """Block inputs p in serving's bf16: activations and weights bf16, the
    LayerNorm's fp32."""
    return {k: v if v is None or k.startswith("ln_") else v.to(BF16) for k, v in p.items()}


def check_bf16_out(name, got, want, errs) -> None:
    """A bf16 kernel output against its plain twin within BF16_RTOL; keeps
    the worst error and the share of elements not bitwise equal."""
    err = float((got.float() - want.float()).abs().max())
    scale = max(float(want.float().abs().max()), 1.0)
    worst = errs.setdefault(name.split()[0], {"max_abs_err": 0.0, "max_rel_err": 0.0,
                                              "share_not_equal": 0.0})
    worst["max_abs_err"] = max(worst["max_abs_err"], err)
    worst["max_rel_err"] = max(worst["max_rel_err"], err / scale)
    worst["share_not_equal"] = max(worst["share_not_equal"],
                                   float((got != want).float().mean()))
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} against "
                             f"{want.dtype} {tuple(want.shape)}")
    if not err <= BF16_RTOL * scale:
        raise AssertionError(f"{name}: max|err| {err:.3e} > {BF16_RTOL:g} * {scale:.3e}")


def check_bf16_gram(name, gen, qkv, heads, errs) -> None:
    """The bf16 Gram (fp32 outputs, against the float64 twin as the fp32
    rows are) and apply on qkv against their twins, each bitwise against a
    second call."""
    gram, again = kgram.mdta_gram_fwd(qkv, heads), kgram.mdta_gram_fwd(qkv, heads)
    torch.cuda.synchronize()
    check(f"mdta_gram_fwd_bf16 {name}", gram, kgram.mdta_gram_plain(qkv.double(), heads), errs)
    check_repeats(f"mdta_gram_fwd_bf16 {name}", gram, again)
    ch = qkv.shape[-1] // 3 // heads
    attn = torch.softmax(torch.randn(qkv.shape[0], heads, ch, ch, device="cuda",
                                     generator=gen), -1)
    out, again = kgram.attn_apply_fwd(qkv, attn), kgram.attn_apply_fwd(qkv, attn)
    torch.cuda.synchronize()
    check_bf16_out(f"attn_apply_fwd_bf16 {name}", out, kgram.attn_apply_plain(qkv, attn), errs)
    check_repeats(f"attn_apply_fwd_bf16 {name}", (out,), (again,))


def phase_bf16_kernels(gen) -> dict:
    """Rows 1-4 in bf16 against their plain bf16 twins at every block shape
    of a 256x256 forward, B = 1 and 2, and at a head of 192 channels, each
    bitwise against a second call."""
    errs: dict = {}
    for label, res, c, heads in MAIN_SHAPES:
        for b in (1, 2):
            p = bf16_block_inputs(block_inputs(gen, b, res, c, True))
            tag = f"{label} B={b}"
            for name, fn, plain, args in (
                    ("block_head_bf16", kblock.block_head, kblock.block_head_plain,
                     head_args(p)),
                    ("block_tail_bf16", kblock.block_tail, kblock.block_tail_plain,
                     tail_args(p))):
                got, again = fn(*args), fn(*args)
                torch.cuda.synchronize()
                check_bf16_out(f"{name} {tag}", got, plain(*args), errs)
                check_repeats(f"{name} {tag}", (got,), (again,))
                if name == "block_head_bf16":
                    qkv = got
            check_bf16_gram(tag, gen, qkv, heads, errs)
    # a head of 192 channels: two channel blocks of 96
    qkv = torch.randn(1, 64, 64, 3 * 192, device="cuda", generator=gen).to(BF16)
    check_bf16_gram("serve L3 one head ch=192", gen, qkv, 1, errs)
    errs["mdta_gram_fwd_bf16"] = dict(zip(("max_abs_err", "max_rel_err"),
                                          errs["mdta_gram_fwd_bf16"]))
    log(f"bf16 kernels against their plain bf16 twins at the 16 block shapes and ch=192: "
        f"{json.dumps(errs)}")
    return errs


def bf16_timings(gen, label, res, c, heads, b) -> dict:
    """Rows 1-4 in bf16 at one block shape, as kernel_timings times the fp32
    rows; the bound takes bf16 bytes and the products at the bf16
    tensor-core rate (the stencils, LN and gate at the fp32 rate, the
    larger of those times and the bytes' time); the library for rows 3-4 is
    bmm on bf16 heads."""
    n = res * res
    p = bf16_block_inputs(block_inputs(gen, b, res, c, True))
    m, hid, ch, bh = 3 * c, int(c * 2.66), c // heads, b * heads
    qkv = kblock.block_head(*head_args(p))
    attn = torch.softmax(torch.randn(b, heads, ch, ch, device="cuda", generator=gen), -1)

    def heads_t(t, transpose):
        t = t.reshape(b, n, heads, ch)
        return (t.permute(0, 2, 3, 1) if transpose else t.permute(0, 2, 1, 3)
                ).reshape(bh, *((ch, n) if transpose else (n, ch))).contiguous()
    qt, kn, vt = heads_t(qkv[..., :c], True), heads_t(qkv[..., c:2 * c], False), heads_t(
        qkv[..., 2 * c:], True)
    at = attn.reshape(bh, ch, ch).to(BF16)
    w_head = 2 * (m * c + 9 * m) + 4 * 2 * c
    w_tail = 2 * (c * c + 3 * hid * c + 18 * hid) + 4 * 2 * c
    rows = {  # kernel, plain, library, product flops, other flops, bytes
        "block_head_bf16": (lambda: kblock.block_head(*head_args(p)),
                            lambda: kblock.block_head_plain(*head_args(p)), None,
                            b * n * 2 * c * m, b * n * (18 * m + 8 * c),
                            2 * b * n * (c + m) + w_head),
        "block_tail_bf16": (lambda: kblock.block_tail(*tail_args(p)),
                            lambda: kblock.block_tail_plain(*tail_args(p)), None,
                            b * n * (2 * c * c + 6 * c * hid), b * n * (46 * hid + 10 * c),
                            2 * 3 * b * n * c + w_tail),
        "mdta_gram_fwd_bf16": (lambda: kgram.mdta_gram_fwd(qkv, heads),
                               lambda: kgram.mdta_gram_plain(qkv, heads),
                               lambda: torch.bmm(qt, kn),
                               b * n * 2 * c * ch, b * n * 4 * c,
                               2 * b * n * 2 * c + 4 * bh * (ch * ch + 2 * ch)),
        "attn_apply_fwd_bf16": (lambda: kgram.attn_apply_fwd(qkv, attn),
                                lambda: kgram.attn_apply_plain(qkv, attn),
                                lambda: torch.bmm(at, vt),
                                b * n * 2 * c * ch, 0,
                                2 * 2 * b * n * c + 4 * bh * ch * ch),
    }
    out = {}
    for name, (kern, plain, lib, mm_flops, flops, nbytes) in rows.items():
        times = {"bytes": nbytes / PEAK_BYTES * 1e3,
                 "operations": max(mm_flops / PEAK_BF16_FLOPS, flops / PEAK_FLOPS) * 1e3}
        by = max(times, key=times.get)
        dev, records = device_ms(kern)
        out[name] = dict(shape=f"{label} {res}^2 C={c} heads={heads} B={b}",
                         ms=cuda_ms(kern), device_ms=dev, device_records=records,
                         sm_mhz=sm_clock_mhz(), plain_ms=cuda_ms(plain, iters=5),
                         bound_ms=times[by], bound_by=by,
                         library_ms=cuda_ms(lib) if lib else None,
                         library_device_ms=device_ms(lib)[0] if lib else None)
    return out


def phase_bf16(gen, gen_np, net, card) -> dict:
    """bf16 serving (make_restorer(dtype=torch.bfloat16), the JAX package's
    make_restorer(dtype=jnp.bfloat16)): rows 1-4 in bf16 against their
    twins; the full-width T_net at 256^2, batch 1 and 8, through
    restore_batch, each kernel of rows 1-4 in bf16 launched 94 times a
    forward and none of their fp32 forms, against the same weights in bf16
    on the CPU within a quarter of max|fp32 - bf16|; bf16 and fp32 img/s at
    batch 1 and 8 in turns and the peak memory at batch 8; cli.test
    --dtype bfloat16 against a CPU run; the bf16 kernels' times."""
    errs = phase_bf16_kernels(gen)
    cfg = ModelConfig()
    r16 = make_restorer(net, cfg, device="cuda", dtype=BF16)
    r32 = make_restorer(net, cfg, device="cuda")
    forwards = counting(r16)
    imgs = [gen_np.uniform(0, 1, (256, 256, 3)).astype(np.float32) for _ in range(8)]

    # ---- the main path of bf16 serving, counted
    build.reset_launches()
    out1 = r16.restore_batch(imgs[:1])
    out8 = r16.restore_batch(imgs)
    torch.cuda.synchronize()
    launches, n_fwd = dict(build.LAUNCHES), forwards[0]
    check_launches("serving bf16", launches,
                   {name: FORWARD_LAUNCHES * n_fwd for name in BF16_KERNELS})
    log(f"serving bf16: {n_fwd} two-pass forwards, launches {launches}")
    for o in out1 + out8:
        if o.shape != (256, 256, 3) or not np.isfinite(o).all():
            raise AssertionError(f"bad bf16 output {o.shape}")

    # ---- against the same weights in bf16 on the CPU
    cpu_net = TNet(cfg, device="cpu", seed=None).eval()
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    cpu16 = make_restorer(cpu_net, cfg, device="cpu", dtype=BF16)
    vs_cpu = {}
    for tag, (img, got) in {"batch 1": (imgs[0], out1[0]),
                            "batch 8, image 5": (imgs[5], out8[5])}.items():
        ref = cpu16.restore_batch([img])[0]
        gap = np.abs(r32.restore_batch([img])[0] - ref)
        err = np.abs(got - ref)
        vs_cpu[tag] = row = {"mean_abs_err": float(err.mean()), "mean_fp32_bf16_gap": float(
            gap.mean()), "max_abs_err": float(err.max()), "max_fp32_bf16_gap": float(gap.max()),
            "share_not_equal": float((err > 0).mean())}
        log(f"bf16 card vs CPU 256^2 {tag}: {json.dumps(row)}")
        if not (row["mean_abs_err"] <= row["mean_fp32_bf16_gap"] / 4
                and row["max_abs_err"] <= BF16_RTOL * max(float(np.abs(ref).max()), 1.0)):
            raise AssertionError(f"bf16 card vs CPU {tag}: {row}")
    del cpu16, cpu_net

    # ---- img/s in turns, fp32 and bf16, and the peak memory at batch 8
    rate = {"fp32": {1: [], 8: []}, "bf16": {1: [], 8: []}}
    peak = {}
    for tag in ("fp32", "bf16", "bf16", "fp32"):
        r = r16 if tag == "bf16" else r32
        rate[tag][1].append(images_per_sec(r, gen_np, 1, 10))
        torch.cuda.reset_peak_memory_stats()
        rate[tag][8].append(images_per_sec(r, gen_np, 8, 3))
        peak[tag] = torch.cuda.max_memory_allocated()
    log(f"256px restore_batch, in turns fp32/bf16/bf16/fp32: {json.dumps(rate)}, "
        f"peak memory at batch 8 {json.dumps(peak)} ({card})")

    # ---- cli.test --dtype bfloat16 on the card against the CPU
    with tempfile.TemporaryDirectory() as tmp:
        write_eval_tree(tmp, seed=8, n=2, size=(256, 256))
        ckpt = os.path.join(tmp, "tnet.pt")
        torch.save({k: v.cpu() for k, v in net.state_dict().items()}, ckpt)
        argv = ["--ckpt", ckpt, "--degset", f"{tmp}/paired/input/", "--tarset",
                f"{tmp}/paired/target/", "--dtype", "bfloat16"]
        build.reset_launches()
        card_psnr = printed_psnrs(run_cli(test_cli.main, argv)[1])
        cli_launches = dict(build.LAUNCHES)
        cpu_psnr = printed_psnrs(run_cli(test_cli.main, argv + ["--device", "cpu"])[1])
    if not card_psnr or card_psnr.keys() != cpu_psnr.keys():
        raise AssertionError(f"cli.test --dtype bfloat16: {card_psnr} against {cpu_psnr}")
    if not all(n % FORWARD_LAUNCHES == 0 and n > 0 for n in cli_launches.values()) or set(
            cli_launches) != set(BF16_KERNELS):
        raise AssertionError(f"cli.test --dtype bfloat16 launched {cli_launches}")
    psnr_gap = max(abs(card_psnr[k] - cpu_psnr[k]) for k in card_psnr)
    log(f"cli.test --dtype bfloat16 per-image PSNR, card {card_psnr}, CPU {cpu_psnr}: "
        f"max gap {psnr_gap:.4f} dB")
    if not psnr_gap <= BF16_PSNR_DB:
        raise AssertionError(f"cli.test bf16 PSNR gap {psnr_gap} dB > {BF16_PSNR_DB}")

    timings = {label: bf16_timings(gen, label, res, c, heads, 1)
               for label, res, c, heads in MAIN_SHAPES}
    return dict(errs=errs, launches=launches, n_fwd=n_fwd, vs_cpu=vs_cpu,
                img_per_s=rate, batch8_max_memory_allocated=peak, cli_psnr_gap_db=psnr_gap,
                cli_launches=cli_launches, timings=timings, card=card)


# ------------------------------------------------------------ bf16 training

def bf16_block_calls(p, r):
    """{name: (kernel, bf16 twin, the twin's arithmetic in float64 or None)}
    of rows 8-9 (qkv) and 5 (tail) in bf16 training on bf16 block inputs p,
    cotangents drawn by r."""
    b, res, _, c = p["x"].shape
    g_m, g_c = r(b, res, res, 3 * c).to(BF16), r(b, res, res, c).to(BF16)
    qkv_args, tail = fused_args(p, False), tail_args(p)
    rounded = functools.partial(kblock._block_tail_rounded, BF16)
    return {
        "conv1x1_dw_bf16": (lambda: (kfused.fused_dwconv_fwd(*qkv_args),),
                            lambda: (kfused.fused_dwconv_plain(*qkv_args),), None),
        "conv1x1_dw_bwd_bf16": (lambda: kfused.fused_dwconv_bwd(*qkv_args, g_m)[:3],
                                lambda: kfused.fused_dwconv_bwd_plain(*qkv_args, g_m)[:3],
                                None),
        "block_tail_bwd_bf16": (lambda: kblock.block_tail_bwd(*tail, g_c),
                                lambda: kblock.block_tail_bwd_plain(*tail, g_c),
                                lambda: kblock._vjp_plain(rounded, _double(tail),
                                                          g_c.double())),
    }


def bf16_mdta_calls(qkv, heads, r):
    """The same for rows 6-7 on a bf16 qkv."""
    ch = qkv.shape[-1] // 3 // heads
    b = qkv.shape[0]
    g_v = r(*qkv.shape[:3], heads * ch).to(BF16)
    dgram, dnq, dnk = r(b, heads, ch, ch), r(b, heads, ch), r(b, heads, ch)
    attn = torch.softmax(r(b, heads, ch, ch), -1)
    return {
        "mdta_gram_bwd_bf16": (lambda: (kgram.mdta_gram_bwd(qkv, dgram, dnq, dnk, heads),),
                               lambda: (kgram.mdta_gram_bwd_plain(qkv, dgram, dnq, dnk,
                                                                  heads),), None),
        "attn_apply_bwd_bf16": (lambda: kgram.attn_apply_bwd(qkv, attn, g_v),
                                lambda: kgram.attn_apply_bwd_plain(qkv, attn, g_v),
                                lambda: kgram.attn_apply_bwd_plain(*_double([qkv, attn, g_v]))),
    }


def check_bf16_train_call(name, tag, calls, errs) -> None:
    """One bf16 training form: two calls bitwise equal and one count each;
    its bf16 outputs against the bf16 twin (check_bf16_out), its fp32
    outputs against the float64 twin within BF16_TRAIN_F32_RTOL of
    max(max|twin|, 1)."""
    kernel, plain, plain64 = calls[name]
    n0 = build.LAUNCHES[name]
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    if build.LAUNCHES[name] != n0 + 2:
        raise AssertionError(f"{name} {tag}: {build.LAUNCHES[name] - n0} counts for two calls")
    check_repeats(f"{name} {tag}", tuple(t for t in got if t is not None),
                  tuple(t for t in again if t is not None))
    want, want64 = plain(), plain64() if plain64 else None
    worst = errs.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": 0.0,
                                   "share_not_equal": 0.0})
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None:
            continue
        if g.dtype == BF16:
            check_bf16_out(f"{name} {tag} output {i}", g, w, errs)
            continue
        w64 = want64[i]
        err = float((g.double() - w64).abs().max())
        twin = float((w.double() - w64).abs().max())
        scale = max(float(w64.abs().max()), 1.0)
        worst["fp32_max_rel_err"] = max(worst.get("fp32_max_rel_err", 0.0), err / scale)
        worst["fp32_twin_rel_err"] = max(worst.get("fp32_twin_rel_err", 0.0), twin / scale)
        if not (g.dtype == torch.float32 and err <= BF16_TRAIN_F32_RTOL[name] * scale):
            raise AssertionError(f"{name} {tag} output {i}: max|err| {err:.3e} against float64 "
                                 f"> {BF16_TRAIN_F32_RTOL[name]:g} * {scale:.3e} (the bf16 "
                                 f"twin's {twin:.3e})")


def phase_bf16_train_kernels(gen) -> dict:
    """The five bf16 training forms against their twins at every training
    block shape (128^2, B = 3: every level, the decoder's and the
    refinement's), rows 6-7 also at the wide heads of phase 3e; each
    bitwise against a second call."""
    errs: dict = {}

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    for label, res, c, heads in TRAIN_SHAPES:
        p = bf16_block_inputs(block_inputs(gen, TRAIN_B, res, c, True))
        qkv = kblock.block_head(*head_args(p))
        calls = {**bf16_block_calls(p, r), **bf16_mdta_calls(qkv, heads, r)}
        tag = f"{label} {res}^2 C={c} heads={heads} B={TRAIN_B}"
        for name in BF16_TRAIN_KERNELS:
            check_bf16_train_call(name, tag, calls, errs)
        log(f"bf16 training kernels ok at {tag}")
    for label, (b, h, w), heads, ch in WIDE_HEADS:
        calls = bf16_mdta_calls(r(b, h, w, 3 * heads * ch).to(BF16), heads, r)
        tag = f"{label} {(b, h, w)} heads={heads} ch={ch}"
        for name in ("mdta_gram_bwd_bf16", "attn_apply_bwd_bf16"):
            check_bf16_train_call(name, tag, calls, errs)
        log(f"bf16 MDTA backward kernels ok at {tag}")
    log(f"bf16 training kernels against their twins: {json.dumps(errs)}")
    return errs


def bf16_train_timings(gen, label, res, c, heads, b) -> dict:
    """The five bf16 training forms at one block shape, as bf16_timings
    times the serving ones: the bound takes bf16 activations' bytes (fp32
    for the LN weights, G's cotangents, attn and dattn), the bf16 products of
    a recompute at the bf16 tensor-core rate and every other product,
    stencil and sum at the fp32 rate (the backward products run 3xTF32, as
    JAX takes them in fp32); the library for rows 6-7 is bmm on bf16 heads."""
    n = res * res
    p = bf16_block_inputs(block_inputs(gen, b, res, c, True))
    m, hid, ch, bh = 3 * c, int(c * 2.66), c // heads, b * heads

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    qkv = kblock.block_head(*head_args(p))
    calls = {**bf16_block_calls(p, r), **bf16_mdta_calls(qkv, heads, r)}
    g_c = r(b, res, res, c).to(BF16)
    attn = torch.softmax(r(b, heads, ch, ch), -1)
    dgram = r(b, heads, ch, ch)

    def heads_t(t, transpose):
        t = t.reshape(b, n, heads, ch)
        return (t.permute(0, 2, 3, 1) if transpose else t.permute(0, 2, 1, 3)
                ).reshape(bh, *((ch, n) if transpose else (n, ch))).contiguous()
    kn, qn, vn = (heads_t(qkv[..., i * c:(i + 1) * c], False) for i in range(3))
    gn, gt = heads_t(g_c, False), heads_t(g_c, True)
    at, dg = attn.reshape(bh, ch, ch).to(BF16), dgram.reshape(bh, ch, ch).to(BF16)
    w_qkv = 2 * (m * c + 9 * m)
    w_tail = 2 * (c * c + 3 * hid * c + 18 * hid) + 4 * 2 * c
    rows = {  # library, bf16 product flops, other flops, bytes
        "conv1x1_dw_bf16": (None, b * n * 2 * c * m, b * n * 18 * m,
                            2 * b * n * (c + m) + w_qkv),
        "conv1x1_dw_bwd_bf16": (None, b * n * 2 * c * m, b * n * (4 * c * m + 36 * m),
                                2 * b * n * (2 * c + m) + 2 * w_qkv),
        "block_tail_bwd_bf16": (None, b * n * (2 * c * c + 4 * c * hid),
                                b * n * (4 * c * c + 12 * c * hid + 128 * hid + 18 * c),
                                2 * 5 * b * n * c + 2 * w_tail),
        "mdta_gram_bwd_bf16": (lambda: (torch.bmm(kn, dg), torch.bmm(qn, dg)), 0,
                               b * n * (4 * c * ch + 4 * c),
                               2 * 4 * b * n * c + 4 * bh * (ch * ch + 2 * ch)),
        "attn_apply_bwd_bf16": (lambda: (torch.bmm(gn, at), torch.bmm(gt, vn)), 0,
                                b * n * 4 * c * ch,
                                2 * 3 * b * n * c + 4 * 2 * bh * ch * ch),
    }
    out = {}
    for name, (lib, mm_flops, flops, nbytes) in rows.items():
        kern, plain, _ = calls[name]
        times = {"bytes": nbytes / PEAK_BYTES * 1e3,
                 "operations": max(mm_flops / PEAK_BF16_FLOPS, flops / PEAK_FLOPS) * 1e3}
        by = max(times, key=times.get)
        dev, records = device_ms(kern)
        out[name] = dict(shape=f"{label} {res}^2 C={c} heads={heads} B={b}",
                         ms=cuda_ms(kern), device_ms=dev, device_records=records,
                         sm_mhz=sm_clock_mhz(), plain_ms=cuda_ms(plain, iters=5),
                         bound_ms=times[by], bound_by=by,
                         library_ms=cuda_ms(lib) if lib else None,
                         library_device_ms=device_ms(lib)[0] if lib else None)
    return out


def bf16_batches(batches, alphas):
    """The same batches and GP draws rounded to bf16, as the JAX trainer
    makes them in bf16 training."""
    return ([Batch(bt.degraded.to(BF16), bt.target.to(BF16), bt.de_id) for bt in batches],
            [a.to(BF16) for a in alphas])


def phase_bf16_train(gen, card) -> dict:
    """bf16 training at full width (cli.train --dtype bfloat16's path):
    create_train_state(Config(train=TrainConfig(dtype="bfloat16"))) in
    "tail", three iterations at 128^2, B = 3 on bf16 batches, counted: each
    of BF16_TRAIN_PATH launched 94 times an iteration and no fp32 form of
    rows 2-9; finite metrics, fp32 parameters that moved. Then fp32 and bf16
    iterations/s in turns (fp32, bf16, bf16, fp32) from that state, with the
    peak max_memory_allocated of each run."""
    cfg = Config(train=TrainConfig(dtype="bfloat16"))
    state = create_train_state(cfg, seed=0, device="cuda")
    if state.t_net.composition != "tail":
        raise AssertionError(f"bf16 training composition {state.t_net.composition!r}")
    batches, alphas = train_inputs(gen, cfg)
    batches16, alphas16 = bf16_batches(batches, alphas)
    state, metrics, launches = counted_iterations(
        state, cfg, batches16, alphas16, "training bf16",
        {name: FORWARD_LAUNCHES for name in BF16_TRAIN_PATH})
    for net in (state.t_net, state.f_net):
        if any(q.dtype != torch.float32 for q in net.parameters()):
            raise AssertionError("bf16 training left a parameter out of fp32")
    iteration = make_train_iteration(cfg)
    lr = step_decay_lr(cfg.train.lr, 0, cfg.train.lr_step)
    rates, peak = {"fp32": [], "bf16": []}, {"fp32": [], "bf16": []}
    for tag in ("fp32", "bf16", "bf16", "fp32"):
        bs, als = (batches16, alphas16) if tag == "bf16" else (batches, alphas)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(5):
            state, _ = iteration(state, bs[i % 3], als[i % 3], False, lr)
        torch.cuda.synchronize()
        rates[tag].append(5 / (time.perf_counter() - t0))
        peak[tag].append(torch.cuda.max_memory_allocated())
    log(f"training {TRAIN_RES}px B={TRAIN_B} in tail, in turns fp32/bf16/bf16/fp32: "
        f"iterations/s {json.dumps(rates)}, peak memory {json.dumps(peak)} ({card})")
    return dict(launches=launches, metrics=metrics, it_per_s_runs=rates,
                it_per_s={k: sum(v) / len(v) for k, v in rates.items()},
                max_memory_allocated=peak, card=card)


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(v))) - 7) if v else 2.0 ** -133


def phase_bf16_train_vs_cpu(gen_np) -> dict:
    """bf16 training's gradients and one iteration's metrics on the card
    against the CPU's, from one seed at 64^2, B = 1, critic patch 64, the
    critic's sign pattern pinned to the CPU's bf16 run (LeakyPattern; the
    CPU's fp32 run records its own): the gradients, all together, within
    a quarter of what bf16 changes on the CPU, sum|card - CPU bf16| <=
    BF16_MODEL_RATIO * sum|CPU fp32 - CPU bf16|; each metric of an iteration
    at lr = 0 within two bf16 ulps of the CPU's (at lr = 0 the critic does
    not move: after an RMSprop step every entry with a near-zero gradient
    has moved by +-10 lr with a sign that the order of sums decides, and in
    bf16 that reaches the scores read after it)."""
    cfg = Config(critic=CriticConfig(patch_size=64),
                 train=TrainConfig(batch_size=1, dtype="bfloat16"))
    b, res = cfg.train.batch_size, cfg.critic.patch_size
    deg, tgt = (torch.from_numpy(gen_np.uniform(0, 1, (b, res, res, 3)).astype(np.float32))
                .to(BF16) for _ in range(2))
    alpha = torch.full((b, 1, 1, 1), 0.37).to(BF16)
    sides, seconds = {}, {}
    pattern = LeakyPattern()
    for key, dev, dtype in (("cpu bf16", "cpu", BF16), ("cpu fp32", "cpu", torch.float32),
                            ("card bf16", "cuda", BF16)):
        t0 = time.perf_counter()
        state = create_train_state(cfg, seed=1, device=dev)
        batch = Batch(deg.to(dev, dtype), tgt.to(dev, dtype), torch.tensor([0] * b, device=dev))
        a = alpha.to(dev, dtype)
        ctx = (pattern.recording() if key == "cpu bf16" else
               pattern.replaying() if dev == "cuda" else LeakyPattern().recording())
        with ctx:
            grads = {k: v.float().cpu() for k, v in train_grads(state, batch, a, cfg).items()}
            _, m = make_train_iteration(cfg)(state, batch, a, True, 0.0)
        sides[key] = (grads, {k: float(v) for k, v in m.items()})
        seconds[key] = time.perf_counter() - t0
        del state
    (g16, m16), (g32, m32), (gc, mc) = sides["cpu bf16"], sides["cpu fp32"], sides["card bf16"]
    if not set(gc) == set(g16) == set(g32):
        raise AssertionError(f"card and CPU differ in which parameters get a gradient: "
                             f"{set(gc) ^ set(g16)} {set(g16) ^ set(g32)}")
    err = sum(float((gc[k] - g16[k]).abs().sum()) for k in gc)
    gap = sum(float((g32[k] - g16[k]).abs().sum()) for k in gc)
    per = sorted(((float((gc[k] - g16[k]).abs().mean() / (g32[k] - g16[k]).abs().mean()
                         .clamp_min(1e-30)), k) for k in gc), reverse=True)
    m_ulps = {k: abs(mc[k] - m16[k]) / _bf16_ulp(m16[k]) for k in m16}
    log(f"bf16 training card vs CPU 64^2 ({len(gc)} gradients; seconds {json.dumps(seconds)}): "
        f"sum|card - CPU| / sum|fp32 - bf16| {err / gap:.4f}, per tensor on the mean: median "
        f"{per[len(per) // 2][0]:.4f}, largest {per[:3]}; metrics at lr 0 card "
        f"{json.dumps(mc)}, CPU bf16 {json.dumps(m16)}, CPU fp32 {json.dumps(m32)}, "
        f"bf16 ulps apart {json.dumps(m_ulps)}")
    if not err <= BF16_MODEL_RATIO * gap:
        raise AssertionError(f"bf16 gradients card vs CPU: {err / gap:.4f} of the fp32 - bf16 "
                             f"gap summed, > {BF16_MODEL_RATIO}")
    bad = {k: v for k, v in m_ulps.items() if not v <= 2}
    if bad:
        raise AssertionError(f"bf16 metrics card vs CPU more than two bf16 ulps apart: {bad}")
    return dict(grad_ratio=err / gap, grad_ratio_median_tensor=per[len(per) // 2][0],
                metric_ulps=m_ulps, cpu_seconds=seconds)


def phase_bf16_train_cli(card: str) -> dict:
    """rcot_torch.cli.train --dtype bfloat16 at full width for one epoch on
    the seeded tree of phase 7: stopped by --fail-at-step 3, resumed from
    latest.npz; each kernel of bf16 "tail" launched 94 times an iteration,
    the validation's forwards in fp32 "full"; finite metrics, fp32
    checkpoints; imgs_per_sec as the CLI logs it."""
    with tempfile.TemporaryDirectory() as tmp:
        root, run = f"{tmp}/tree", f"{tmp}/run"
        write_synthetic_tree(root, seed=0, n_denoise=3, n_rain=0, n_haze=6, size=192,
                             val_sizes=((192, 192), (250, 321)))
        argv = train_cli_argv(root, run) + ["--dtype", "bfloat16"]
        argv[argv.index("--n-epochs") + 1] = "1"
        build.reset_launches()
        try:
            train_cli.main(argv + ["--fail-at-step", "3"])
        except InjectedFailure as e:
            log(f"bf16 train CLI stopped as asked: {e}")
        else:
            raise AssertionError("--fail-at-step 3 did not stop the run")
        latest = f"{run}/ckpt/latest.npz"
        meta = read_metadata(latest)
        trainer = train_cli.main(argv + ["--resume", latest])
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        with open(f"{run}/log.jsonl") as f:
            events = [json.loads(line) for line in f]
        steps = [e for e in events if e["event"] == "train_step"]
        names = ("f_wgan", "f_gp", "t_loss", "t_adv", "rmse", "fourier", "paired_l1")
        vals = [e for e in events if e["event"] == "validation"]
        if not steps or not all(np.isfinite(e[k]) for e in steps for k in names) or \
                trainer.host_step != 7 or len(vals) != 1 or not np.isfinite(vals[0]["psnr"]):
            raise AssertionError(f"bf16 train CLI: step {trainer.host_step}, {steps}, {vals}")
        if any(q.dtype != torch.float32 for q in trainer.state.t_net.parameters()):
            raise AssertionError("bf16 train CLI: a T_net parameter is not fp32")
        n_iter = 3 + 7 - meta["epoch_step"]
        want = sum_launches({name: FORWARD_LAUNCHES * n_iter for name in BF16_TRAIN_PATH},
                            expected_launches(FORWARD_LAUNCHES * 2, "full", False))
        check_launches(f"bf16 train CLI ({n_iter} iterations, 2 forwards in fp32 full)",
                       launches, want)
        ips = [e["imgs_per_sec"] for e in steps]
        log(f"bf16 train CLI at full width: resumed at step {meta['epoch_step']}, 7 steps, "
            f"PSNR {vals[0]['psnr']:.4f}, imgs_per_sec at logged steps {ips} ({card})")
        return dict(resumed_at=meta["epoch_step"], imgs_per_sec=ips, psnr=vals[0]["psnr"],
                    launches=launches, card=card)


# ------------------------------------------------------------ training

class LeakyPattern:
    """Pins the critic's LeakyReLU(0.2) sign pattern across two runs of one
    computation. A fp32 gradient of the critic jumps where a pre-activation
    crosses 0: a change of 1e-7 in its input (the card against the CPU, or
    one block composition against another) moved F's WGAN gradients by up
    to 6.9e-2 of their largest entry on the card, at one input in six.
    `recording()` runs the reference side and keeps each call's x >= 0 in
    call order; `replaying()` runs the other side, each call taking the next
    recorded pattern. Both sides then differentiate one smooth branch, and
    a difference beyond rounding is a difference in what was computed."""

    def __init__(self):
        self.masks: list = []

    @contextlib.contextmanager
    def _patched(self, leaky):
        real = critic._leaky
        critic._leaky = leaky
        try:
            yield
        finally:
            critic._leaky = real

    def recording(self):
        self.masks = []

        def leaky(x):
            self.masks.append((x >= 0).detach().cpu())
            return torch.where(self.masks[-1].to(x.device), x, 0.2 * x)
        return self._patched(leaky)

    @contextlib.contextmanager
    def replaying(self):
        left = list(self.masks)

        def leaky(x):
            if not left or left[0].shape != x.shape:
                raise AssertionError(f"replay: critic call of shape {tuple(x.shape)} "
                                     "has no recorded pattern in this place")
            return torch.where(left.pop(0).to(x.device), x, 0.2 * x)
        with self._patched(leaky):
            yield
        if left:
            raise AssertionError(f"replay: {len(left)} recorded critic calls not made")


class TemperatureTerms:
    """Records, for each MDTA temperature of `net` that the Gram core
    differentiates, sum|terms| of its gradient. The temperature scales the
    logits, logits = g_hat * t, so dt is the sum of dlogits * g_hat over
    the (ch, ch) entries (and the batch): `recording()` hands ops/gram.py's
    glue the temperature expanded to (heads, ch, ch), whose gradient is
    those terms (summed over the batch), and adds up their magnitudes per
    head. The products are the same; only the sum is taken in another place,
    so the recorded run stays a plain fp32 run of the same function."""

    def __init__(self, net, tag: str = "T"):
        self.names = {p.data_ptr(): f"{tag} {n}" for n, p in net.named_parameters()
                      if n.endswith("temperature")}
        self.sums: dict = {}

    def _add(self, name, g):
        s = g.detach().abs().sum(dim=(1, 2), keepdim=True)
        self.sums[name] = self.sums[name] + s if name in self.sums else s

    @contextlib.contextmanager
    def recording(self):
        real = kgram._glue

        def glue(gram, nq, nk, temperature):
            name = self.names.get(temperature.data_ptr())
            if name is None or not (torch.is_grad_enabled() and temperature.requires_grad):
                return real(gram, nq, nk, temperature)
            t = temperature.expand(gram.shape[1:]).clone()
            t.register_hook(lambda g: self._add(name, g))
            return real(gram, nq, nk, t)
        kgram._glue = glue
        try:
            yield self
        finally:
            kgram._glue = real


def grad_allowance(ref: torch.Tensor, terms_abs=None) -> torch.Tensor:
    """The largest |grad - ref| allowed per entry: GRAD_RTOL of ref's
    largest entry or, for a sum of terms whose magnitudes sum to terms_abs,
    SUM_ULPS ulps of that, whichever is larger (SUM_ULPS says why)."""
    allowed = torch.full_like(ref, GRAD_RTOL * float(ref.abs().max()))
    if terms_abs is not None:
        allowed = torch.maximum(allowed, SUM_ULPS * FP32_EPS * terms_abs.to(ref))
    return allowed.clamp_min(1e-30)


def grad_errors(grads: dict, ref: dict, terms: dict) -> tuple:
    """-> ({name: max|err| / max|ref|}, {name: (that, max|ref|, the largest
    floor)} for each gradient beyond grad_allowance)."""
    rel, bad = {}, {}
    for k, g in grads.items():
        r = ref[k]
        err = (g - r).abs()
        largest = float(r.abs().max())
        rel[k] = float(err.max()) / max(largest, 1e-30)
        if not bool((err <= grad_allowance(r, terms.get(k))).all()):
            floor = terms.get(k)
            bad[k] = (rel[k], largest, None if floor is None
                      else SUM_ULPS * FP32_EPS * float(floor.max()))
    return rel, bad


# modules defined by the reference but never called: their grads are zero
PARITY_MODULES = ("res_patch_embed.", "chnl_reduce", "reduce_noise_channel_",
                  "resdown3_4.", "resnoise_level3.", "resreduce_noise_level3.")


def seeded_batch(gen, b, res, de_id) -> Batch:
    def img():
        return torch.rand(b, res, res, 3, device="cuda", generator=gen)
    return Batch(img(), img(), torch.tensor(de_id, device="cuda"))


def phase_train(gen) -> dict:
    """Three full-width minimax iterations on the card in the training
    composition, "tail" (the training path, counted), then iterations/s in
    "tail" and in "full" in turns (tail, full, full, tail)."""
    cfg = Config()
    t0 = time.perf_counter()
    state = create_train_state(cfg, seed=0, device="cuda")
    n_t, n_f = count_params(state.t_net), count_params(state.f_net)
    if (n_t, n_f) != (46_853_150, 30_588_609):
        raise AssertionError(f"T_net {n_t} and F_net {n_f} parameters, not "
                             "46,853,150 and 30,588,609")
    if state.t_net.composition != "tail":
        raise AssertionError(f"training composition {state.t_net.composition!r}, not tail")
    log(f"train state built: T_net {n_t}, F_net {n_f} parameters, composition "
        f"{state.t_net.composition} ({time.perf_counter() - t0:.1f} s)")
    batches, alphas = train_inputs(gen, cfg)
    state, metrics, launches = counted_iterations(
        state, cfg, batches, alphas, "training",
        expected_launches(FORWARD_LAUNCHES, "tail"))

    # ---- iterations/s in both compositions, in turns
    rates = timed_in_turns(state, cfg, batches, alphas, {
        "tail": dict(composition="tail"), "full": dict(composition="full")})
    state.t_net.composition = "tail"
    critic_ms = cuda_ms(lambda: critic_work(state, batches[0], alphas[0], cfg), iters=5)
    return dict(launches=launches, metrics=metrics,
                it_per_s={mode: sum(v) / len(v) for mode, v in rates.items()},
                it_per_s_runs=rates, critic_ms=critic_ms)


def train_inputs(gen, cfg):
    """Three seeded batches (de_id 0/3/4) and GP alphas at the recipe's size."""
    b, res = cfg.train.batch_size, cfg.critic.patch_size
    batches = [seeded_batch(gen, b, res, [0, 3, 4]) for _ in range(3)]
    alphas = [torch.rand(b, 1, 1, 1, device="cuda", generator=gen) for _ in range(3)]
    return batches, alphas


def counted_iterations(state, cfg, batches, alphas, tag, want_per_iteration):
    """The training path, counted: three minimax iterations (paired, then
    unpaired twice) with the counts set to 0 just before; finite metrics,
    each kernel launched as `want_per_iteration` says per iteration and no
    other, every used parameter moved."""
    iteration = make_train_iteration(cfg)
    lr = step_decay_lr(cfg.train.lr, 0, cfg.train.lr_step)
    nets = {"T": state.t_net, "F": state.f_net}
    before = {(k, n): p.detach().clone() for k, net in nets.items()
              for n, p in net.named_parameters()}
    build.reset_launches()
    metrics = []
    for batch, alpha, paired in zip(batches, alphas, (True, False, False)):
        state, m = iteration(state, batch, alpha, paired, lr)
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    for i, m in enumerate(metrics):
        log(f"{tag} iteration {i}: {json.dumps(m)}")
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{tag} iteration {i}: metrics not finite: {m}")
    check_launches(tag, launches, {k: n * len(metrics) for k, n in want_per_iteration.items()})
    log(f"{tag} path: {len(metrics)} iterations, launches {launches}")
    check_moved(state, before)
    return state, metrics, launches


def timed_in_turns(state, cfg, batches, alphas, settings: dict, n_timed: int = 5) -> dict:
    """Iterations/s of each named setting of the T_net's kernel choices,
    five iterations each, in turns A B B A; -> {name: [rate, rate]}."""
    iteration = make_train_iteration(cfg)
    lr = step_decay_lr(cfg.train.lr, 0, cfg.train.lr_step)
    a, b = settings
    rates = {a: [], b: []}
    for name in (a, b, b, a):
        for attr, value in settings[name].items():
            setattr(state.t_net, attr, value)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_timed):
            state, _ = iteration(state, batches[i % 3], alphas[i % 3], False, lr)
        torch.cuda.synchronize()
        rates[name].append(n_timed / (time.perf_counter() - t0))
    return rates


def phase_train_opt_in(gen, card) -> dict:
    """Training at full width with the fused MDTA attend and the standalone
    depthwise kernel in the JAX trainer's default composition, "tail" (the
    JAX package's RCOT_PALLAS_MDTA=1 RCOT_PALLAS_FUSED=0
    RCOT_PALLAS_DWCONV=1): three iterations at 128^2, B = 3, counted (94
    launches each of dwconv3x3, dwconv3x3_dx, dwconv3x3_dtaps, block_tail,
    block_tail_bwd and mdta_attend per iteration, no other kernel);
    iterations/s in turns with today's "tail" (Gram core, fused tier)."""
    cfg = Config()
    state = create_train_state(cfg, seed=0, device="cuda", attention_core="mdta",
                               depthwise="dwconv")
    if (state.t_net.composition, state.t_net.attention_core, state.t_net.depthwise) != \
            ("tail", "mdta", "dwconv"):
        raise AssertionError("the opt-in training state is not in tail/mdta/dwconv")
    batches, alphas = train_inputs(gen, cfg)
    state, metrics, launches = counted_iterations(
        state, cfg, batches, alphas, "training tail/mdta/dwconv",
        expected_launches(FORWARD_LAUNCHES, "tail", **OPT_IN))
    rates = timed_in_turns(state, cfg, batches, alphas, {
        "tail/mdta/dwconv": dict(attention_core="mdta", depthwise="dwconv"),
        "tail": dict(attention_core="gram", depthwise="fused")})
    it_per_s = {k: sum(v) / len(v) for k, v in rates.items()}
    log(f"training {TRAIN_RES}px B={TRAIN_B}: {it_per_s['tail/mdta/dwconv']:.4f} "
        f"iterations/s in tail/mdta/dwconv, {it_per_s['tail']:.4f} in tail ({card})")
    return dict(launches=launches, metrics=metrics, it_per_s=it_per_s, it_per_s_runs=rates)


def phase_compositions(gen_np) -> dict:
    """The four block compositions from one full-width state at 64^2, B = 1,
    in the default tiers and then with the fused MDTA attend and the
    standalone depthwise kernel (mdta/dwconv): each run's T and F gradients
    of one iteration (train_grads) against "full"'s, the critic's sign
    pattern pinned to full's (LeakyPattern), and each run's kernels
    launched 94 times a block kind in its forward and backward (the counts
    reset just before each)."""
    cfg = Config(critic=CriticConfig(patch_size=64), train=TrainConfig(batch_size=1))
    b, res = cfg.train.batch_size, cfg.critic.patch_size
    state = create_train_state(cfg, seed=2, device="cuda")
    deg, tgt = (torch.from_numpy(gen_np.uniform(0, 1, (b, res, res, 3)).astype(np.float32))
                .cuda() for _ in range(2))
    batch = Batch(deg, tgt, torch.tensor([3] * b, device="cuda"))
    alpha = torch.full((b, 1, 1, 1), 0.37, device="cuda")
    grads, launches = {}, {}
    pattern = LeakyPattern()
    terms = TemperatureTerms(state.t_net)
    runs = [(mode, "gram", "fused") for mode in COMPOSITIONS]
    runs += [(mode, "mdta", "dwconv") for mode in COMPOSITIONS]
    for mode, core, tier in runs:  # full first: it records the critic's pattern
        key = mode if core == "gram" else f"{mode}/{core}/{tier}"
        state.t_net.composition = mode
        state.t_net.attention_core, state.t_net.depthwise = core, tier
        build.reset_launches()
        with (pattern.recording() if key == "full" else pattern.replaying()), \
                (terms.recording() if key == "full" else contextlib.nullcontext()):
            grads[key] = train_grads(state, batch, alpha, cfg)
        torch.cuda.synchronize()
        launches[key] = dict(build.LAUNCHES)
        check_launches(f"composition {key}", launches[key],
                       expected_launches(FORWARD_LAUNCHES, mode, core=core, depthwise=tier))
    worst = {}
    for mode in list(grads)[1:]:
        if set(grads[mode]) != set(grads["full"]):
            raise AssertionError(f"{mode}: other parameters get a gradient than in full")
        rel, bad = grad_errors(grads[mode], grads["full"], terms.sums)
        if bad:
            raise AssertionError(f"{mode} vs full: gradients off by more than "
                                 f"{GRAD_RTOL} of their largest (or a temperature's "
                                 f"floor): {{name: (error relative to the largest, "
                                 f"largest, floor)}} {bad}")
        worst[mode] = max(rel.items(), key=lambda kv: kv[1])
        log(f"composition {mode} vs full 64^2: {len(rel)} gradients, worst "
            f"max|err|/max|grad| {worst[mode]}")
    return dict(launches=launches, worst=worst)


def train_cli_argv(root: str, run: str) -> list:
    return ["--preset", "dehaze", "--de-type", "denoise_15", "dehaze",
            "--patch-size", str(TRAIN_RES), "--batch-size", str(TRAIN_B), "--pairnum", "6",
            "--n-epochs", "2", "--ckpt-every-steps", "2",
            "--denoise-dir", f"{root}/Train/Denoise/", "--dehaze-dir", f"{root}/Train/Dehaze/",
            "--data-file-dir", f"{root}/manifests/", "--degset", f"{root}/val/input/",
            "--tarset", f"{root}/val/target/", "--ckpt-dir", f"{run}/ckpt",
            "--log-file", f"{run}/log.jsonl"]


def phase_train_cli(card: str) -> dict:
    """rcot_torch.cli.train at full width on a seeded synthetic tree (3
    denoise images x5 and 6 hazy pairs, 192^2: 21 samples, 7 steps an
    epoch, 2 of them paired; validation on a 192^2 and a 250x321 image):
    a run stopped by --fail-at-step 5, then resumed from latest.npz through
    both epochs and their validations; the final checkpoint loads back
    into a fresh Trainer equal to the state in memory."""
    with tempfile.TemporaryDirectory() as tmp:
        root, run = f"{tmp}/tree", f"{tmp}/run"
        write_synthetic_tree(root, seed=0, n_denoise=3, n_rain=0, n_haze=6, size=192,
                             val_sizes=((192, 192), (250, 321)))
        argv = train_cli_argv(root, run)
        build.reset_launches()
        t0 = time.perf_counter()
        try:
            train_cli.main(argv + ["--fail-at-step", "5"])
        except InjectedFailure as e:
            log(f"train CLI stopped as asked: {e}")
        else:
            raise AssertionError("--fail-at-step 5 did not stop the run")
        with open(f"{run}/log.jsonl") as f:
            n_first = len(f.readlines())
        latest = f"{run}/ckpt/latest.npz"
        meta = read_metadata(latest)
        trainer = train_cli.main(argv + ["--resume", latest])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        with open(f"{run}/log.jsonl") as f:
            events = [json.loads(line) for line in f]
        first, second = events[:n_first], events[n_first:]

        skipped = [e["epoch_step"] for e in first if e["event"] == "ckpt_skipped_inflight"]
        want_step = 2 if 4 in skipped else 4
        resumed = [e for e in second if e["event"] == "resumed"]
        if [(e["epoch"], e["epoch_step"]) for e in resumed] != [(1, meta["epoch_step"])] \
                or meta["epoch_step"] != want_step:
            raise AssertionError(f"resumed {resumed}, latest.npz {meta.get('epoch')}/"
                                 f"{meta.get('epoch_step')}, skipped saves at {skipped}")
        steps = [e for e in events if e["event"] == "train_step"]
        names = ("f_wgan", "f_gp", "t_loss", "t_adv", "rmse", "fourier", "paired_l1")
        if not steps or not all(np.isfinite(e[k]) for e in steps for k in names):
            raise AssertionError(f"train_step metrics missing or not finite: {steps}")
        ends = [e["epoch"] for e in second if e["event"] == "epoch_end"]
        vals = [e for e in second if e["event"] == "validation"]
        if ends != [1, 2] or [v["epoch"] for v in vals] != [1, 2] \
                or not all(v["psnr"] is not None and np.isfinite(v["psnr"]) for v in vals):
            raise AssertionError(f"epoch ends {ends}, validations {vals}")
        if trainer.host_step != 14 or not os.path.exists(latest) or \
                read_metadata(latest)["epoch"] != 3:
            raise AssertionError(f"the run ended at step {trainer.host_step}, latest "
                                 f"{read_metadata(latest)}")
        # steps 0-4 before the failure, then from the resume point to 14;
        # each validation image is one forward in "full"
        n_iter = 5 + 14 - meta["epoch_step"]
        n_val = 2 * len(vals)
        want = sum_launches(expected_launches(FORWARD_LAUNCHES * n_iter, "tail"),
                            expected_launches(FORWARD_LAUNCHES * n_val, "full", False))
        check_launches(f"train CLI ({n_iter} iterations in tail, {n_val} forwards in full)",
                       launches, want)
        fresh = Trainer(trainer.cfg)
        fresh.resume(latest)
        check_same_state(fresh.state, trainer.state)
        ips = [e["imgs_per_sec"] for e in steps]
        pps = [e["patches_per_sec"] for e in second if e["event"] == "epoch_end"]
        log(f"train CLI at full width: resumed at epoch 1 step {meta['epoch_step']} "
            f"(periodic saves skipped in flight at epoch steps {skipped}), 14 steps, "
            f"PSNR {[round(v['psnr'], 4) for v in vals]}, imgs_per_sec at logged steps {ips}, "
            f"patches_per_sec by epoch {pps} ({card})")
        return dict(resumed_at=meta["epoch_step"], skipped_inflight=skipped,
                    imgs_per_sec=ips, patches_per_sec=pps,
                    psnr=[v["psnr"] for v in vals], launches=launches,
                    seconds=seconds, card=card)


def phase_cli_opt_in(card) -> dict:
    """rcot_torch.cli.train for one epoch on a seeded synthetic tree with
    --attention-core mdta --depthwise dwconv (its iterations in
    tail/mdta/dwconv, its validation forwards in full/mdta), then
    rcot_torch.cli.test on the validation folder from the run's
    latest.npz with --composition off --attention-core mdta --depthwise
    dwconv: finite metrics and PSNRs, and each run's launches those of its
    tiers."""
    flags = ["--attention-core", "mdta", "--depthwise", "dwconv"]
    with tempfile.TemporaryDirectory() as tmp:
        root, run = f"{tmp}/tree", f"{tmp}/run"
        write_synthetic_tree(root, seed=1, n_denoise=3, n_rain=0, n_haze=6, size=192,
                             val_sizes=((192, 192), (250, 321)))
        argv = train_cli_argv(root, run)
        argv[argv.index("--n-epochs") + 1] = "1"
        build.reset_launches()
        trainer = train_cli.main(argv + flags)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        with open(f"{run}/log.jsonl") as f:
            events = [json.loads(line) for line in f]
        steps = [e for e in events if e["event"] == "train_step"]
        names = ("f_wgan", "f_gp", "t_loss", "t_adv", "rmse", "fourier", "paired_l1")
        if not steps or not all(np.isfinite(e[k]) for e in steps for k in names):
            raise AssertionError(f"train_step metrics missing or not finite: {steps}")
        vals = [e for e in events if e["event"] == "validation"]
        if [v["epoch"] for v in vals] != [1] or not np.isfinite(vals[0]["psnr"]):
            raise AssertionError(f"validations {vals}")
        n_iter, n_val = trainer.host_step, 2
        check_launches(f"train CLI mdta/dwconv ({n_iter} iterations, {n_val} validation "
                       "forwards)", launches,
                       sum_launches(expected_launches(FORWARD_LAUNCHES * n_iter, "tail",
                                                      **OPT_IN),
                                    expected_launches(FORWARD_LAUNCHES * n_val, "full", False,
                                                      **OPT_IN)))
        build.reset_launches()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            test_cli.main(["--ckpt", f"{run}/ckpt/latest.npz", "--degset", f"{root}/val/input/",
                           "--tarset", f"{root}/val/target/", "--save", f"{tmp}/out/",
                           "--savetar", f"{tmp}/tar/", "--saveres", f"{tmp}/res/",
                           "--composition", "off"] + flags)
        torch.cuda.synchronize()
        test_launches = dict(build.LAUNCHES)
        psnrs = [float(v) for v in re.findall(r": psnr (\S+) ssim", printed.getvalue())]
        if len(psnrs) != 2 or not all(np.isfinite(psnrs)):
            raise AssertionError(f"cli.test printed {printed.getvalue()!r}")
        check_launches("test CLI off/mdta/dwconv (2 forwards)", test_launches,
                       expected_launches(FORWARD_LAUNCHES * 2, "off", False, **OPT_IN))
        log(f"train CLI mdta/dwconv at full width: {n_iter} steps, PSNR {vals[0]['psnr']:.4f}; "
            f"test CLI off/mdta/dwconv: PSNR {psnrs} ({card})")
        return dict(steps=n_iter, val_psnr=vals[0]["psnr"], test_psnr=psnrs,
                    imgs_per_sec=[e["imgs_per_sec"] for e in steps],
                    launches=launches, test_launches=test_launches)


EVAL_RES = 256
EVAL_SIGMAS = ("15", "50")
EVAL_PER_TASK = 2     # images a task; the denoise folder runs once a sigma
EVAL_TASKS = [f"denoise_sigma{s}" for s in EVAL_SIGMAS] + [
    "derain", "dehaze", "deblur", "lowlight", "val"]
TEST_IMAGES = 6       # cli.test's folder: FID's covariances need a few
POOL3_RTOL, POOL3_ATOL = 2e-3, 2e-4  # as tests/test_fid_torch_parity.py
LPIPS_ATOL = 1e-5
FID_REL = 2e-2
PSNR_GATE_DB = 1e-3   # card vs CPU per-image PSNR, as tests/test_torch_inference.py


def run_cli(main, argv) -> tuple:
    """(what main returned, its standard output)."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        ret = main(argv)
    torch.cuda.synchronize()
    return ret, printed.getvalue()


def printed_psnrs(text: str) -> dict:
    return {name: float(v) for name, v in re.findall(r"^(\S+): psnr (\S+) ssim", text, re.M)}


def printed_average(text: str, metric: str) -> float:
    m = re.search(rf"^{metric}: average (\S+)", text, re.M)
    if m is None or not np.isfinite(float(m.group(1))):
        raise AssertionError(f"no finite {metric} average in {text!r}")
    return float(m.group(1))


def phase_eval(card, default_flags) -> dict:
    """The evaluation surface at full width on a seeded tree of 256^2
    images (rcot_torch.data.synthetic.write_eval_tree) and a ModelConfig()
    checkpoint drawn from a seed: rcot_torch.cli.eval_all over every task
    (denoise at two sigmas, derain, dehaze, deblur, lowlight, a --paired
    tree), each row finite with its n, 94 launches of each "full" kernel per
    forward; rcot_torch.cli.test with --fid --lpips --niqe-model fit:<the
    clean folder>, finite averages; the Inception, LPIPS and FID of its saved
    images on the card against the CPU; the cost of each metric; and the
    CLI's per-image PSNR against the CPU's, in this script's fp32 and under
    PyTorch's default flags (default_flags: TF32 for cuDNN convolutions)."""
    with tempfile.TemporaryDirectory() as tmp:
        root, test = f"{tmp}/eval", f"{tmp}/test"
        write_eval_tree(root, seed=3, n=EVAL_PER_TASK, size=(EVAL_RES, EVAL_RES))
        write_eval_tree(test, seed=4, n=TEST_IMAGES, size=(EVAL_RES, EVAL_RES))
        ckpt = f"{tmp}/tnet.pt"
        torch.save(TNet(ModelConfig(), device="cpu", seed=5).state_dict(), ckpt)

        # ---- cli.eval_all over every task, counted; each task timed
        task_s: dict = {}
        plain_items = eval_cli._eval_items

        def timed_items(restorer, items, task):
            t0 = time.perf_counter()
            row = plain_items(restorer, items, task)
            torch.cuda.synchronize()
            task_s[task] = time.perf_counter() - t0
            return row
        eval_cli._eval_items = timed_items
        build.reset_launches()
        try:
            rc, _ = run_cli(eval_cli.main, [
                "--ckpt", ckpt, "--denoise-path", f"{root}/denoise", "--sigmas", *EVAL_SIGMAS,
                "--derain-path", f"{root}/derain", "--dehaze-path", f"{root}/dehaze",
                "--deblur-dir", f"{root}/deblur", "--lowlight-dir", f"{root}/lowlight",
                "--paired", "val", f"{root}/paired", "--json-out", f"{tmp}/eval.json"])
        finally:
            eval_cli._eval_items = plain_items
        launches = dict(build.LAUNCHES)
        with open(f"{tmp}/eval.json") as f:
            results = json.load(f)["results"]
        if rc != 0 or list(results) != EVAL_TASKS:
            raise AssertionError(f"eval_all returned {rc}, tasks {list(results)}")
        for key, row in results.items():
            if row.get("n") != EVAL_PER_TASK or "skipped" in row or not all(
                    np.isfinite(row[k]) for k in ("psnr", "ssim", "input_psnr", "input_ssim")):
                raise AssertionError(f"eval_all {key}: {row}")
        n_fwd = sum(row["n"] for row in results.values())
        check_launches(f"eval_all ({n_fwd} forwards in full)", launches,
                       expected_launches(FORWARD_LAUNCHES * n_fwd, "full", backward=False))
        log(f"eval_all at full width: {json.dumps(results)}; seconds by task "
            f"{json.dumps(task_s)} ({card})")

        # ---- cli.test with every metric, counted
        out, tar = f"{tmp}/out/", f"{tmp}/tar/"
        argv = ["--ckpt", ckpt, "--degset", f"{test}/paired/input/", "--tarset",
                f"{test}/paired/target/", "--save", out, "--savetar", tar,
                "--saveres", f"{tmp}/res/"]
        build.reset_launches()
        t0 = time.perf_counter()
        _, text = run_cli(test_cli.main, argv + ["--fid", "--lpips", "--niqe-model",
                                              f"fit:{test}/paired/target"])
        test_s = time.perf_counter() - t0
        test_launches = dict(build.LAUNCHES)
        check_launches(f"test CLI ({TEST_IMAGES} forwards in full)", test_launches,
                       expected_launches(FORWARD_LAUNCHES * TEST_IMAGES, "full", False))
        card_psnr = printed_psnrs(text)
        averages = {m: printed_average(text, m) for m in ("PSNR", "SSIM", "LPIPS", "NIQE")}
        fid_line = re.search(r"^FID value: (\S+)$", text, re.M)
        if len(card_psnr) != TEST_IMAGES or f"({TEST_IMAGES} images)" not in text \
                or fid_line is None or not np.isfinite(float(fid_line.group(1))):
            raise AssertionError(f"cli.test printed {text!r}")
        log(f"test CLI at full width with --fid --lpips --niqe-model fit: {averages}, "
            f"FID {fid_line.group(1)}, {test_s:.3f} s for {TEST_IMAGES} images ({card})")

        # ---- the metrics of the saved images, card against CPU
        outs, tars = list_image_folder(out), list_image_folder(tar)
        batch = np.stack([fid_cli._load_and_preprocess(f) for f in outs])
        nets = {dev: inception.InceptionV3(None, dev) for dev in ("cuda", "cpu")}
        feats = {dev: inception.inception_pool3(net, batch).cpu() for dev, net in nets.items()}
        torch.testing.assert_close(feats["cuda"], feats["cpu"], rtol=POOL3_RTOL, atol=POOL3_ATOL)
        pool3_err = float((feats["cuda"] - feats["cpu"]).abs().max())
        x = np.stack([load_rgb(f) for f in outs]).astype(np.float32) / 255.0
        y = np.stack([load_rgb(f) for f in tars]).astype(np.float32) / 255.0
        lp = {dev: lpips_mod.LPIPS(None, dev) for dev in ("cuda", "cpu")}
        dist = {dev: lpips_mod.lpips(net, x, y).cpu() for dev, net in lp.items()}
        lpips_err = float((dist["cuda"] - dist["cpu"]).abs().max())
        if not lpips_err <= LPIPS_ATOL:
            raise AssertionError(f"LPIPS card vs CPU: max|err| {lpips_err:.3e} > {LPIPS_ATOL:g}")
        fid_card, fid_cpu = (fid_cli.compute_fid_folders(tar, out, device=dev)
                             for dev in ("cuda", "cpu"))
        fid_rel = abs(fid_card - fid_cpu) / abs(fid_cpu)
        if not fid_rel <= FID_REL or abs(fid_card - float(fid_line.group(1))) > 1e-4:
            raise AssertionError(f"FID card {fid_card} vs CPU {fid_cpu}, "
                                 f"cli.test printed {fid_line.group(1)}")
        log(f"metrics card vs CPU on the saved images: pool3 max|err| {pool3_err:.3e}, "
            f"LPIPS max|err| {lpips_err:.3e}, FID {fid_card!r} vs {fid_cpu!r} "
            f"(rel {fid_rel:.3e})")

        # ---- what evaluation costs
        x50 = torch.rand(50, EVAL_RES, EVAL_RES, 3, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(8))
        inception.inception_pool3(nets["cuda"], x50)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            inception.inception_pool3(nets["cuda"], x50)
        torch.cuda.synchronize()
        inception_img_s = 5 * 50 / (time.perf_counter() - t0)
        xa, ya = x50[:1].contiguous(), x50[1:2].contiguous()
        lpips_ms = cuda_ms(lambda: lpips_mod.lpips(lp["cuda"], xa, ya))
        model = niqe_mod.fit_niqe_model([load_rgb(f).astype(np.float64) for f in tars])
        img = load_rgb(outs[0]).astype(np.float64)
        t0 = time.perf_counter()
        for _ in range(3):
            niqe_mod.niqe(img, model)
        niqe_ms = (time.perf_counter() - t0) / 3 * 1e3
        del nets, lp, x50
        log(f"eval costs: Inception pool3 {inception_img_s:.3f} img/s at batch 50 "
            f"({EVAL_RES}^2 in), LPIPS {lpips_ms:.4f} ms per {EVAL_RES}^2 pair, NIQE "
            f"{niqe_ms:.3f} ms per {EVAL_RES}^2 image on the host ({card})")

        # ---- the CLI's numeric mode: per-image PSNR against the CPU's, in
        # fp32 and under PyTorch's default flags
        cpu_psnr = printed_psnrs(run_cli(test_cli.main, argv + ["--device", "cpu"])[1])
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = default_flags
        try:
            default_psnr = printed_psnrs(run_cli(test_cli.main, argv)[1])
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        if not card_psnr.keys() == cpu_psnr.keys() == default_psnr.keys():
            raise AssertionError(f"PSNR lines {card_psnr}, {cpu_psnr}, {default_psnr}")
        gap_fp32 = max(abs(card_psnr[k] - cpu_psnr[k]) for k in cpu_psnr)
        gap_default = max(abs(default_psnr[k] - cpu_psnr[k]) for k in cpu_psnr)
        log(f"test CLI per-image PSNR vs the CPU: max gap {gap_fp32:.4f} dB in fp32, "
            f"{gap_default:.4f} dB under PyTorch's default flags (matmul.allow_tf32, "
            f"cudnn.allow_tf32 = {default_flags}); printed to 4 decimals")
        if not max(gap_fp32, gap_default) <= PSNR_GATE_DB:
            raise AssertionError(f"card vs CPU PSNR gap {gap_fp32} / {gap_default} dB "
                                 f"> {PSNR_GATE_DB}")
        return dict(eval_all=results, eval_all_seconds_by_task=task_s,
                    eval_all_launches=launches, test_cli=averages,
                    test_cli_fid=float(fid_line.group(1)), test_cli_seconds=test_s,
                    test_cli_launches=test_launches, pool3_max_abs_err=pool3_err,
                    lpips_max_abs_err=lpips_err, fid_card=fid_card, fid_cpu=fid_cpu,
                    inception_img_per_s_b50=inception_img_s, lpips_ms_per_pair=lpips_ms,
                    niqe_ms_per_image_host=niqe_ms, psnr_gap_db_fp32=gap_fp32,
                    psnr_gap_db_default_flags=gap_default,
                    default_flags=dict(zip(("matmul.allow_tf32", "cudnn.allow_tf32"),
                                           default_flags)), card=card)


def check_same_state(a, b) -> None:
    """Parameters, optimizer slots and step of two TrainStates are equal."""
    for tag, na, nb, oa, ob in (("T", a.t_net, b.t_net, a.t_opt, b.t_opt),
                                ("F", a.f_net, b.f_net, a.f_opt, b.f_opt)):
        for (n, p), q in zip(na.named_parameters(), nb.parameters()):
            if not torch.equal(p, q):
                raise AssertionError(f"{tag} {n}: loaded parameter differs")
            sa, sb = oa.state[p], ob.state[q]
            if sa.keys() != sb.keys() or not all(torch.equal(sa[k].cpu(), sb[k].cpu())
                                                 for k in sa):
                raise AssertionError(f"{tag} {n}: loaded optimizer state differs")
    if a.step != b.step:
        raise AssertionError(f"step {a.step} != {b.step}")


def check_moved(state, before) -> None:
    """Every used parameter got a gradient (its RMSprop square_avg is not
    all zero) and, where that gradient is above 1e-7 (a step of at least
    0.9 lr, far above fp32's resolution at 1.0), moved. Unused: the parity
    modules of T, and F's linear-head biases (fc2.bias cancels in the WGAN
    difference and does not reach the input gradient; fc.bias and fc1.bias
    get a gradient only once real and fake images differ in the head's
    LeakyReLU pattern)."""
    unused_f = ("fc.bias", "fc1.bias", "fc2.bias")
    no_grad, still, small = [], [], 0
    for tag, net, opt in (("T", state.t_net, state.t_opt), ("F", state.f_net, state.f_opt)):
        for n, p in net.named_parameters():
            if (tag == "T" and n.startswith(PARITY_MODULES)) or (tag == "F" and n in unused_f):
                continue
            rms = float(opt.state[p]["square_avg"].max().sqrt())
            if rms == 0.0:
                no_grad.append(f"{tag} {n}")
            elif rms <= 1e-7:
                small += 1
            elif torch.equal(p.detach(), before[(tag, n)]):
                still.append(f"{tag} {n}")
    if no_grad or still:
        raise AssertionError(f"no gradient: {no_grad}; gradient but did not move: {still}")
    log(f"every used parameter got a gradient and moved ({small} with gradients "
        f"<= 1e-7 not held to moving)")


def critic_work(state, batch, alpha, cfg) -> None:
    """The critic's share of an iteration without the optimizer steps: the
    WGAN loss and its grads, the GP and its grads, and the score of a fake
    batch differentiated into its input (the T step's path through F)."""
    f = state.f_net
    params = list(f.parameters())
    fake = batch.degraded
    b = fake.shape[0]
    scores = f(torch.cat([batch.target, fake]))
    torch.autograd.grad(losses.wgan_critic_loss(scores[:b], scores[b:]), params)
    gp = losses.gradient_penalty(f, batch.target, fake, alpha, cfg.train.gp_weight)
    torch.autograd.grad(gp, params, allow_unused=True)
    out = fake.clone().requires_grad_()
    torch.autograd.grad(f(out).mean(), out)


def train_grads(state, batch, alpha, cfg) -> dict:
    """T's gradient of the T loss and F's of the WGAN loss and of the GP,
    all at the given state (no step in between)."""
    tc = cfg.train
    t_named = list(state.t_net.named_parameters())
    f_named = list(state.f_net.named_parameters())
    out2 = state.t_net(batch.degraded)[0]
    loss, _ = losses.t_loss(out2, batch.degraded, batch.target, batch.de_id,
                            state.f_net(out2), sigma=tc.sigma, Sigma=tc.Sigma,
                            paired=True, loss_math=tc.loss_math)
    grads = {}

    def put(tag, named, value):
        gs = torch.autograd.grad(value, [p for _, p in named], allow_unused=True)
        grads.update({f"{tag} {n}": g for (n, _), g in zip(named, gs) if g is not None})
    put("T", t_named, loss)
    fake = out2.detach()
    b = fake.shape[0]
    scores = state.f_net(torch.cat([batch.target, fake]))
    put("F-wgan", f_named, losses.wgan_critic_loss(scores[:b], scores[b:]))
    put("F-gp", f_named, losses.gradient_penalty(state.f_net, batch.target, fake, alpha,
                                                 tc.gp_weight))
    return grads


def phase_train_vs_cpu(gen_np) -> dict:
    """The full-width nets from one seed on the card and on the CPU, at 64^2,
    B = 1, critic patch 64: every gradient, then one iteration's metrics,
    the critic's sign pattern pinned to the CPU's (LeakyPattern)."""
    cfg = Config(critic=CriticConfig(patch_size=64), train=TrainConfig(batch_size=1))
    b, res = cfg.train.batch_size, cfg.critic.patch_size
    deg, tgt = (gen_np.uniform(0, 1, (b, res, res, 3)).astype(np.float32) for _ in range(2))
    alpha = np.full((b, 1, 1, 1), 0.37, np.float32)
    lr = step_decay_lr(cfg.train.lr, 0, cfg.train.lr_step)
    sides = {}
    pattern = LeakyPattern()
    for dev in ("cpu", "cuda"):  # the CPU records the critic's pattern and terms
        state = create_train_state(cfg, seed=1, device=dev)
        batch = Batch(torch.from_numpy(deg).to(dev), torch.from_numpy(tgt).to(dev),
                      torch.tensor([0] * b, device=dev))
        a = torch.from_numpy(alpha).to(dev)
        if dev == "cpu":
            terms = TemperatureTerms(state.t_net)
        with pattern.recording() if dev == "cpu" else pattern.replaying():
            with terms.recording() if dev == "cpu" else contextlib.nullcontext():
                grads = {k: v.cpu() for k, v in train_grads(state, batch, a, cfg).items()}
            _, m = make_train_iteration(cfg)(state, batch, a, True, lr)
        sides[dev] = (grads, {k: float(v) for k, v in m.items()})
        del state
    (g_card, m_card), (g_cpu, m_cpu) = sides["cuda"], sides["cpu"]
    if set(g_card) != set(g_cpu):
        raise AssertionError("card and CPU differ in which parameters get a gradient")
    rel, bad_grads = grad_errors(g_card, g_cpu, terms.sums)
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    log(f"card vs CPU 64^2 gradients ({len(rel)} tensors): worst max|err|/max|grad| {worst}")
    m_rel = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1.0) for k in m_cpu}
    log(f"card vs CPU 64^2 metrics: CPU {json.dumps(m_cpu)}, "
        f"|card - CPU| / max(|CPU|, 1) {json.dumps(m_rel)}")
    if bad_grads:
        raise AssertionError(f"gradients off by more than {GRAD_RTOL} of their largest (or "
                             f"a temperature's floor): {{name: (error relative to the "
                             f"largest, largest, floor)}} {bad_grads}")
    bad = [k for k, v in m_rel.items()
           if not v <= (STEPPED_RTOL if k in STEPPED_METRICS else METRIC_RTOL)]
    if bad:
        raise AssertionError(f"metrics off by more than their tolerance: {bad} {m_rel}")
    return dict(grad_worst_rel=worst[0][1], metric_worst_rel=max(m_rel.values()))


ONE_HEAD = ModelConfig(heads=(1, 1, 1, 1))  # heads of 48, 96, 192 and 384 channels
ONE_HEAD_TIERS = (("gram", "fused"), ("mdta", "dwconv"))


def phase_one_head(gen_np) -> dict:
    """ModelConfig(heads=(1, 1, 1, 1)) at full width (seeded weights): the
    level-3 and latent heads are 192 and 384 channels wide, past the 128 a
    block of the MDTA kernels takes, and run as channel blocks. Serving:
    make_restorer(...).restore_batch on a 128^2 image in full/gram/fused
    and in off/mdta/dwconv (94 launches of the attention core's kernels a
    forward), each against the same restorer on the CPU within the forward
    gate (MODEL_ATOL, MODEL_RTOL). Training: one 64^2, B = 1 iteration's T
    and F gradients (train_grads) in tail/gram/fused and tail/mdta/dwconv
    against the CPU's in the same tiers, each within GRAD_RTOL of its
    largest entry, the critic's sign pattern pinned to the CPU's
    (LeakyPattern) and a temperature held to the floor its terms set
    (TemperatureTerms, recorded in the CPU's gram run: the mdta run's
    temperatures are the same sums)."""
    out: dict = {}
    img = gen_np.uniform(0, 1, (128, 128, 3)).astype(np.float32)
    for core, tier, mode in (("gram", "fused", "full"), ("mdta", "dwconv", "off")):
        key = f"{mode}/{core}/{tier}"
        nets = {"cuda": TNet(ONE_HEAD, device="cuda", seed=0).eval(),
                "cpu": TNet(ONE_HEAD, device="cpu", seed=None).eval()}
        nets["cpu"].load_state_dict({k: v.cpu() for k, v in nets["cuda"].state_dict().items()})
        restorers = {dev: make_restorer(net, ONE_HEAD, device=dev, composition=mode,
                                        attention_core=core, depthwise=tier)
                     for dev, net in nets.items()}
        forwards = counting(restorers["cuda"])
        build.reset_launches()
        got = restorers["cuda"].restore_batch([img])[0]
        torch.cuda.synchronize()
        check_launches(f"one head serving {key}", dict(build.LAUNCHES),
                       expected_launches(FORWARD_LAUNCHES * forwards[0], mode, False,
                                         core=core, depthwise=tier))
        want = restorers["cpu"].restore_batch([img])[0]
        err = float(np.abs(got - want).max())
        torch.testing.assert_close(torch.from_numpy(got), torch.from_numpy(want),
                                   atol=MODEL_ATOL, rtol=MODEL_RTOL)
        out[f"serve {key} max_abs_err"] = err
        log(f"one head a level, serving {key}: card vs CPU 128^2 max|err| {err:.3e}")
        del nets, restorers

    model = ONE_HEAD
    cfg = Config(model=model, critic=CriticConfig(patch_size=64), train=TrainConfig(batch_size=1))
    b, res = cfg.train.batch_size, cfg.critic.patch_size
    deg, tgt = (gen_np.uniform(0, 1, (b, res, res, 3)).astype(np.float32) for _ in range(2))
    alpha = np.full((b, 1, 1, 1), 0.37, np.float32)
    terms = None
    for core, tier in ONE_HEAD_TIERS:
        key = f"tail/{core}/{tier}"
        pattern = LeakyPattern()
        sides = {}
        for dev in ("cpu", "cuda"):  # the CPU records the critic's pattern (and the terms)
            state = create_train_state(cfg, seed=1, device=dev, attention_core=core,
                                       depthwise=tier)
            if state.t_net.composition != "tail":
                raise AssertionError(f"training composition {state.t_net.composition!r}")
            batch = Batch(torch.from_numpy(deg).to(dev), torch.from_numpy(tgt).to(dev),
                          torch.tensor([0] * b, device=dev))
            record = dev == "cpu" and terms is None
            if record:
                terms = TemperatureTerms(state.t_net)
            build.reset_launches()
            with pattern.recording() if dev == "cpu" else pattern.replaying():
                with terms.recording() if record else contextlib.nullcontext():
                    sides[dev] = {k: v.cpu() for k, v in train_grads(
                        state, batch, torch.from_numpy(alpha).to(dev), cfg).items()}
            if dev == "cuda":
                torch.cuda.synchronize()
                check_launches(f"one head training {key}", dict(build.LAUNCHES),
                               expected_launches(FORWARD_LAUNCHES, "tail", core=core,
                                                 depthwise=tier))
            del state
        rel, bad = grad_errors(sides["cuda"], sides["cpu"], terms.sums)
        if set(sides["cuda"]) != set(sides["cpu"]) or bad:
            raise AssertionError(f"one head a level, training {key}: gradients off by more "
                                 f"than {GRAD_RTOL} of their largest (or a temperature's "
                                 f"floor): {bad}")
        worst = max(rel.items(), key=lambda kv: kv[1])
        out[f"train {key} worst_grad_rel"] = worst
        log(f"one head a level, training {key}: card vs CPU 64^2, {len(rel)} gradients, "
            f"worst max|err|/max|grad| {worst}")
    return out


def iteration_breakdown(it_per_s, critic_ms, timings, mode) -> dict:
    """One iteration at 128^2, B = 3 in `mode` (host clock, synchronised)
    beside each of its kernels' time at every block shape times the blocks
    at that shape, and the critic's share timed alone; the rest is T's
    convolutions, resamplers, glue (and, in "tail", LN1 and its backward),
    the losses, the optimizer steps and launch gaps."""
    it_ms = 1e3 / it_per_s
    names = composition_kernels(mode)
    per_kernel = {name: sum(BLOCKS_PER_FORWARD[label] * timings[label][name]["ms"]
                            for label in BLOCKS_PER_FORWARD) for name in names}
    fwd = sum(per_kernel[k] for k in names if k in FORWARD_KERNELS)
    bwd = sum(per_kernel[k] for k in names if k in BACKWARD_KERNELS)
    return dict(composition=mode, iteration_ms=it_ms, forward_kernels_ms=fwd,
                backward_kernels_ms=bwd, critic_ms=critic_ms,
                rest_ms=it_ms - fwd - bwd - critic_ms, kernels_ms=per_kernel)


# ------------------------------------------------------------ main

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "measures the CUDA port and has nothing to run here", file=sys.stderr)
        return 1
    # PyTorch's own flags, which a user's CLI run sees (phase 8 runs under them once)
    default_flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    log(f"kernels built: {lib.name} in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    gen_np = np.random.default_rng(0)
    # the opt-in phases (3d, 4b, 6c) draw from generators of their own: the
    # earlier phases see the inputs they saw before those phases existed
    gen_opt = torch.Generator(device="cuda").manual_seed(1)
    gen_np_opt = np.random.default_rng(1)
    errs = phase_kernels(gen)
    # rows 1-2 beyond serving's shapes draw from a generator of their own
    phase_block_fwd(torch.Generator(device="cuda").manual_seed(3), errs)
    errs.update(phase_backward(gen))
    # rows 1-2 and 5 past 512 channels, on inputs of their own
    phase_block_wide(torch.Generator(device="cuda").manual_seed(4), errs)
    errs.update(phase_fused(gen))
    errs.update(phase_opt_in_kernels(gen_opt))
    # heads past 128 channels and the pixel sums' drift, on inputs of their own
    phase_wide_heads(torch.Generator(device="cuda").manual_seed(6), errs)
    drift = phase_sum_drift(torch.Generator(device="cuda").manual_seed(7), errs)
    model = phase_model(gen_np)
    serve_opt = phase_serve_opt_in(gen_np_opt, model["net"], card)

    ips1 = images_per_sec(model["restorer"], gen_np, 1, 10)
    torch.cuda.reset_peak_memory_stats()
    ips8 = images_per_sec(model["restorer"], gen_np, 8, 3)
    peak8 = torch.cuda.max_memory_allocated()
    log(f"256px restore_batch: {ips1:.3f} img/s at batch 1, {ips8:.3f} img/s "
        f"at batch 8, peak memory {peak8} bytes ({card})")

    serve_kernels = composition_kernels("full", backward=False) + [
        "mdta_attend", "dwconv3x3", "dwconv3x3_qkv"]
    timings = {label: kernel_timings(gen, label, res, c, heads, 1, serve_kernels)
               for label, res, c, heads in MAIN_SHAPES}
    breakdown = forward_breakdown(gen, model["net"], timings)
    # bf16 serving, on inputs of its own, timed before the training phases
    bf16 = phase_bf16(torch.Generator(device="cuda").manual_seed(9), np.random.default_rng(9),
                      model["net"], card)
    del model["restorer"], model["net"]
    # bf16 training's kernels, on inputs of their own, checked and timed
    # before the training phases
    gen_bf16 = torch.Generator(device="cuda").manual_seed(10)
    bf16_train_errs = phase_bf16_train_kernels(gen_bf16)
    bf16_train_times = {label: bf16_train_timings(gen_bf16, label, res, c, heads, TRAIN_B)
                        for label, res, c, heads in TRAIN_SHAPES}
    # the training shapes are timed before the training phases, on inputs of
    # their own: after those phases the profiler loses device records
    gen_timing = torch.Generator(device="cuda").manual_seed(2)
    train_timings = {label: kernel_timings(gen_timing, label, res, c, heads, TRAIN_B,
                                           [*KERNELS, "dwconv3x3_qkv",
                                            "dwconv3x3_dx_qkv"])
                     for label, res, c, heads in TRAIN_SHAPES}

    train = phase_train(gen)
    log(f"training {TRAIN_RES}px B={TRAIN_B}: {train['it_per_s']['tail']:.4f} "
        f"iterations/s in tail, {train['it_per_s']['full']:.4f} in full ({card})")
    vs_cpu = phase_train_vs_cpu(gen_np)
    bf16_train = phase_bf16_train(torch.Generator(device="cuda").manual_seed(11), card)
    bf16_train_vs_cpu = phase_bf16_train_vs_cpu(np.random.default_rng(11))
    compositions = phase_compositions(gen_np)
    train_opt = phase_train_opt_in(gen_opt, card)
    one_head = phase_one_head(np.random.default_rng(2))
    cli = phase_train_cli(card)
    cli_opt = phase_cli_opt_in(card)
    bf16_cli = phase_bf16_train_cli(card)
    evals = phase_eval(card, default_flags)
    splits = {mode: iteration_breakdown(train["it_per_s"][mode], train["critic_ms"],
                                        train_timings, mode) for mode in ("tail", "full")}

    launch_runs = {"serve": model["launches"], "train": train["launches"],
                   **{f"6b {m}": compositions["launches"][m] for m in COMPOSITIONS},
                   "serve opt-in": serve_opt["launches"], "train opt-in": train_opt["launches"]}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        path = LAUNCHES_FROM.get(name, "train")
        # a kernel's ms are at its main path's shapes: serving's forward at
        # 256 px, B = 1; every other at the training shapes, 128 px, B = 3
        t = timings if path.startswith("serve") else train_timings
        # the training path runs the depthwise backward at the qkv width
        row = "dwconv3x3_dx_qkv" if name == "dwconv3x3_dx" else name
        l1, lat = t["L1"][row], t["latent"][row]
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launch_runs[path][name], launches_counted_in=path,
            launches_per_train_iteration_tail=train["launches"].get(name, 0) // len(
                train["metrics"]),
            launches_per_train_iteration_tail_mdta_dwconv=train_opt["launches"].get(
                name, 0) // len(train_opt["metrics"]),
            max_abs_err=errs[name][0], max_rel_err=errs[name][1],
            ms=l1["ms"], device_ms=l1["device_ms"], plain_ms=l1["plain_ms"],
            bound_ms=l1["bound_ms"], bound_by=l1["bound_by"],
            library_ms=l1["library_ms"], library_device_ms=l1["library_device_ms"],
            at=l1["shape"], latent=lat,
            train_L1=train_timings["L1"][row])
        if name == "dwconv3x3":
            entry.update(width="GDFN (2h)", qkv_width=t["L1"]["dwconv3x3_qkv"],
                         train_L1_qkv_width=train_timings["L1"]["dwconv3x3_qkv"])
        elif name == "dwconv3x3_dx":
            entry.update(width="qkv (3C)", gdfn_width=train_timings["L1"][name])
        elif name == "dwconv3x3_dtaps":
            entry.update(width="qkv (3C)")
        kernels.append(entry)
    for name, (source, replaces) in BF16_KERNELS.items():
        l1, err = bf16["timings"]["L1"][name], bf16["errs"][name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=bf16["launches"][name], launches_counted_in="serve bf16", **err,
            ms=l1["ms"], device_ms=l1["device_ms"], plain_ms=l1["plain_ms"],
            bound_ms=l1["bound_ms"], bound_by=l1["bound_by"], library_ms=l1["library_ms"],
            library_device_ms=l1["library_device_ms"], at=l1["shape"],
            latent=bf16["timings"]["latent"][name],
            launches_per_train_iteration_bf16=bf16_train["launches"].get(name, 0) // len(
                bf16_train["metrics"])))
    for name, (source, replaces) in BF16_TRAIN_KERNELS.items():
        t = bf16_train_times["L1"][name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=bf16_train["launches"][name], launches_counted_in="train bf16",
            launches_per_train_iteration_bf16=bf16_train["launches"][name] // len(
                bf16_train["metrics"]), **bf16_train_errs[name],
            ms=t["ms"], device_ms=t["device_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"],
            library_device_ms=t["library_device_ms"], at=t["shape"],
            decoder_L1=bf16_train_times["decoder_level1"][name],
            latent=bf16_train_times["latent"][name]))
    for tag, tt in (("serve", timings), ("train", train_timings),
                    ("serve bf16", bf16["timings"]), ("train bf16", bf16_train_times)):
        for label in BLOCKS_PER_FORWARD:
            log(json.dumps({"shape": f"{tag} {label}", **{
                name: {k: v for k, v in t.items() if k != "shape"}
                for name, t in tt[label].items()}}))
    log(json.dumps({"e2e_256px": {"batch1_img_per_s": ips1, "batch8_img_per_s": ips8,
                                  "batch8_max_memory_allocated": peak8, "card": card},
                    "forward_256px_b1": breakdown,
                    "train_128px_b3": {"iterations_per_s": train["it_per_s"],
                                       "iterations_per_s_runs": train["it_per_s_runs"],
                                       "card": card, "split": splits,
                                       "metrics": train["metrics"]},
                    "train_card_vs_cpu_64px": vs_cpu,
                    "compositions_vs_full_64px": compositions["worst"],
                    "train_cli": {k: v for k, v in cli.items() if k != "launches"},
                    "train_cli_launches": cli["launches"],
                    "opt_in": {"serve_off_mdta_dwconv_256px": serve_opt,
                               "train_tail_mdta_dwconv_128px_b3": {
                                   "iterations_per_s": train_opt["it_per_s"],
                                   "iterations_per_s_runs": train_opt["it_per_s_runs"],
                                   "metrics": train_opt["metrics"],
                                   "launches": train_opt["launches"], "card": card},
                               "compositions_vs_full_64px": {
                                   k: v for k, v in compositions["worst"].items()
                                   if "/" in k},
                               "clis": cli_opt},
                    "one_head_a_level": one_head,
                    "bf16_serving_256px": {k: v for k, v in bf16.items()
                                           if k not in ("timings", "errs")},
                    "bf16_training_128px_b3": {
                        **{k: v for k, v in bf16_train.items() if k != "launches"},
                        "card_vs_cpu_64px": bf16_train_vs_cpu,
                        "cli": {k: v for k, v in bf16_cli.items() if k != "launches"},
                        "kernel_errs": bf16_train_errs},
                    "eval_256px": evals,
                    "pixel_sum_drift_512_pixel_ranges": drift,
                    "gram_plain_fp32_vs_float64_rel_err": errs["gram_plain_fp32_rel"],
                    "golden_max_abs_err": model["golden_err"],
                    "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
