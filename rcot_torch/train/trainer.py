"""The trainer: epochs of minimax iterations, validation,
checkpoints, resume.

Counterpart of rcot_tpu/train/trainer.py:175-636 (reference: trainer.py
main/train/evaluate):
- each step takes the loader's uint8 patches on the device, augments and
  degrades them there and runs one minimax iteration (train/steps.py),
  every random draw keyed by (seed, step), so a run resumed from a
  checkpoint repeats the uninterrupted one;
- iterations < pairnum // batch_size get the paired L1 term; the learning
  rate is step_decay_lr(lr, epoch - 1, lr_step), as the reference passes it;
- per-epoch PSNR validation over a folder through make_restorer (padded,
  not skipped; a shape mismatch between a pair is skipped loudly), itself
  skipped when this run's log already holds it and the config matched;
- checkpoints each `ckpt_every` epochs and every `ckpt_every_steps` steps
  (written on a thread; a periodic save is skipped while one is in
  flight), on SIGTERM/SIGINT (the loop saves at the next step boundary and
  stops), and `fail_at_step` raises InjectedFailure for recovery tests;
- one JSONL log of events: epoch_start, train_step (sec_per_step,
  imgs_per_sec and the metrics), epoch_end, validation, resumed,
  preempted, ckpt_skipped_inflight, ...

T's bias-free blocks run in `composition` ("auto" = the JAX trainer's
default, "tail"), `attention_core`, `depthwise` and `bwd_bf16` (the tiers
whose backward products take bf16 operands, RCOT_BWD_BF16; ops/dispatch.py);
validation serves in "full" with the same attention core and depthwise
tier, as the JAX package's kernel switches hold in its inference scope too
(bwd_bf16 changes nothing there: serving runs no backward). The JAX
trainer's own switch to RCOT_BWD_BF16=all at a per-chip batch of 8 or more
(rcot_tpu/train/trainer.py:78-110) is a TPU measurement and is not taken:
the option is the caller's.
With TrainConfig.dtype "bfloat16" the batches (and the sample dump's
forward) are bf16, in any composition, attention core and depthwise tier
(the dwconv tier's taps and their gradients fp32); validation serves
in fp32 (rcot_tpu/train/trainer.py:507 makes its restorer without a
dtype), and the parameters, optimizer state and checkpoints stay fp32.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..data.datasets import eval_pairs, load_rgb
from ..data.pipeline import device_prefetch, TrainLoader
from ..metrics.quality import psnr
from ..models.inference import make_restorer
from ..ops.dispatch import (resolve_attention_core, resolve_bwd_bf16, resolve_composition,
                            resolve_depthwise)
from ..utils.checkpoint import AsyncCheckpointer, load_checkpoint, snapshot_state
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.image_io import save_sample_grid
from ..utils.logging import MetricsLogger, StepTimer, profile_trace
from .optim import step_decay_lr
from .steps import (TrainState, batch_dtype, create_train_state, make_train_iteration,
                    step_inputs)


class InjectedFailure(RuntimeError):
    """Raised by --fail-at-step fault injection."""


class Preempted(Exception):
    """Internal: a SIGTERM/SIGINT arrived, the loop checkpointed and
    stopped; fit() returns normally."""


class Trainer:
    def __init__(self, cfg: Config, *, log_path: Optional[str] = None,
                 device="cuda", composition: str = "auto",
                 attention_core: str = "gram", depthwise: str = "fused", bwd_bf16="0"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.composition = resolve_composition(composition, training=True)
        self.attention_core = resolve_attention_core(attention_core)
        self.depthwise = resolve_depthwise(depthwise)
        self.bwd_bf16 = resolve_bwd_bf16(bwd_bf16)
        self.dtype = batch_dtype(cfg)
        self.log = MetricsLogger(log_path)
        self.loader = TrainLoader(cfg, seed=cfg.train.seed)
        self.iteration = make_train_iteration(cfg)
        self._restorer = None  # built at the first validation
        self.state: Optional[TrainState] = None
        self.start_epoch = 1
        self.start_step = 0  # mid-epoch resume point
        # {epoch: degset} of validations already in the resumed log; fit()
        # skips one only when the config hash matched at resume and the
        # degset is this run's
        self._validated_epochs: dict = {}
        self._resume_config_ok = False
        self._last_log = None  # (wall time, host_step) at the last train_step
        self.host_step = 0
        # set by the SIGTERM/SIGINT handler; the loop saves and stops
        self._preempted = False
        self._async_ckpt = AsyncCheckpointer()

    # ------------------------------------------------------------ state

    def _kernels(self) -> dict:
        return dict(composition=self.composition, attention_core=self.attention_core,
                    depthwise=self.depthwise, bwd_bf16=self.bwd_bf16)

    def init_state(self) -> TrainState:
        self.state = create_train_state(self.cfg, seed=self.cfg.train.seed,
                                        device=self.device, **self._kernels())
        self.host_step = 0
        return self.state

    def resume(self, path: str) -> None:
        """Load a checkpoint of either package (config hash checked, a
        mismatch logged) and continue from its epoch and epoch_step."""
        self.state = create_train_state(self.cfg, seed=None, device=self.device,
                                        **self._kernels())
        meta = load_checkpoint(path, self.state)
        self.host_step = self.state.step
        self.start_epoch = int(meta.get("epoch", 1))
        self.start_step = int(meta.get("epoch_step", 0))
        known = (self.cfg.hash(), self.cfg.hash_legacy())
        self._resume_config_ok = meta.get("config_hash") in known
        if meta.get("config_hash") not in (None,) + known:
            self.log.log("resume_config_mismatch", ckpt=path,
                         ckpt_hash=meta.get("config_hash"), run_hash=self.cfg.hash())
        self._validated_epochs = self._logged_validations()
        self.log.log("resumed", path=path, epoch=self.start_epoch,
                     epoch_step=self.start_step,
                     validated_epochs=sorted(self._validated_epochs))

    def _logged_validations(self) -> dict:
        """{epoch: degset} of the validation events already in this run's
        log (a torn last line of a killed process is skipped)."""
        path = self.log.path
        if not path or not os.path.exists(path):
            return {}
        epochs = {}
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("event") == "validation" and rec.get("epoch") is not None:
                    epochs[int(rec["epoch"])] = rec.get("degset")
        return epochs

    def save(self, epoch: int, epoch_step: int = 0, *, blocking: bool = False,
             skip_if_busy: bool = False) -> str:
        """Checkpoint <ckpt_dir>/<run_name>_step<N>.npz on the writer thread;
        blocking waits for it to be durable. skip_if_busy (periodic saves)
        skips, and logs it, while an earlier write is in flight."""
        t = self.cfg.train
        path = os.path.join(t.ckpt_dir, f"{t.run_name}_step{self.host_step}")
        if skip_if_busy and self._async_ckpt.busy:  # before the snapshot's copies
            self.log.log("ckpt_skipped_inflight", epoch=epoch,
                         epoch_step=epoch_step, step=self.host_step)
            return ""
        metadata = {"epoch": epoch, "epoch_step": epoch_step,
                    "config_hash": self.cfg.hash(), "config": self.cfg.to_dict()}
        out = self._async_ckpt.save(path, snapshot_state(self.state),
                                    metadata=metadata, keep_n=t.ckpt_keep)
        if blocking:
            self._async_ckpt.wait()
        return out

    # ------------------------------------------------------------ loop

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_epoch(self, epoch: int, start_step: int = 0,
                    profile_dir: Optional[str] = None) -> dict:
        cfg = self.cfg
        t = cfg.train
        lr = step_decay_lr(t.lr, epoch - 1, t.lr_step)
        self.log.log("epoch_start", epoch=epoch, lr=lr)
        paired_until = t.pairnum // t.batch_size
        timer = StepTimer(warmup=2)
        last_metrics = {}
        n_imgs = 0
        self._last_log = None  # epoch boundary: no eval or ckpt gap folded in
        batch = None  # stays None on an empty epoch
        with contextlib.ExitStack() as profiling:
            for i, b in enumerate(device_prefetch(self.loader.epoch(epoch, start_step),
                                                  size=cfg.data.prefetch,
                                                  device=self.device)):
                step_idx = start_step + i
                if t.fail_at_step >= 0 and self.host_step >= t.fail_at_step:
                    raise InjectedFailure(f"injected failure at step {self.host_step}")
                # profiler window: steps [3, 8) of the epoch
                if profile_dir and step_idx == 3:
                    profiling.enter_context(profile_trace(profile_dir))
                if profile_dir and step_idx == 8:
                    self._sync()
                    profiling.close()
                    self.log.log("profile_trace", dir=profile_dir)
                timer.start()
                inputs, alpha = step_inputs(t.seed, self.host_step, b.clean, b.degraded,
                                            b.de_id, self.dtype)
                self.state, metrics = self.iteration(self.state, inputs, alpha,
                                                     step_idx < paired_until, lr)
                batch = b
                self.host_step += 1
                if self._preempted:
                    path = self.save(epoch, epoch_step=step_idx + 1, blocking=True)
                    self.log.log("preempted", epoch=epoch, step=self.host_step, ckpt=path)
                    raise Preempted(path)
                if t.ckpt_every_steps and (step_idx + 1) % t.ckpt_every_steps == 0:
                    self.save(epoch, epoch_step=step_idx + 1, skip_if_busy=True)
                if step_idx % t.log_every == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}  # syncs
                    dt = timer.stop(t.batch_size)
                    # a rolling mean over the steps since the last log point:
                    # the float() above waits for all of them
                    now = time.perf_counter()
                    if self._last_log is not None:
                        lt, ls = self._last_log
                        dt = (now - lt) / max(1, self.host_step - ls)
                    self._last_log = (now, self.host_step)
                    self.log.log("train_step", epoch=epoch, step=self.host_step,
                                 epoch_step=step_idx, sec_per_step=dt,
                                 imgs_per_sec=t.batch_size / dt if dt else None,
                                 **metrics)
                    last_metrics = metrics
                else:
                    timer.stop(t.batch_size)
                n_imgs += t.batch_size
        self._sync()
        self.log.log("epoch_end", epoch=epoch, images=n_imgs,
                     mean_sec_per_step=(timer.mean_step_time()
                                        if timer.steps_timed else None),
                     patches_per_sec=timer.items_per_sec())
        if t.sample_every and epoch % t.sample_every == 0 and batch is not None:
            self._dump_samples(epoch, batch)
        return last_metrics

    @torch.no_grad()
    def _dump_samples(self, epoch: int, batch) -> None:
        """Output, degraded, target and 2 x residual grids of the last batch,
        its augmented inputs made again from the step's own draws, through
        the training forward in the batch's dtype."""
        t = self.cfg.train
        inputs, _ = step_inputs(t.seed, self.host_step - 1, batch.clean, batch.degraded,
                                batch.de_id, self.dtype)
        out, _, res = self.state.t_net(inputs.degraded)

        def host(x):
            return x.float().cpu().numpy()
        save_sample_grid(os.path.join(t.sample_dir, t.run_name), f"epoch{epoch}",
                         output=host(out), degraded=host(inputs.degraded),
                         target=host(inputs.target), res=2.0 * host(res))

    def evaluate_folder(self, degset: str, tarset: str) -> float:
        """Mean full-size PSNR over a validation folder (reference:
        trainer.py:179-227), padded instead of skipped."""
        if self._restorer is None:
            self._restorer = make_restorer(self.state.t_net, self.cfg.model,
                                           device=self.device,
                                           attention_core=self.attention_core,
                                           depthwise=self.depthwise)
        total, n, skipped = 0.0, 0, 0
        for deg_path, tar_path in eval_pairs(degset, tarset):
            deg = load_rgb(deg_path).astype(np.float32) / 255.0
            tar = load_rgb(tar_path).astype(np.float32) / 255.0
            if deg.shape != tar.shape:
                skipped += 1
                self.log.log("eval_skip", degraded=deg_path, target=tar_path,
                             reason="shape_mismatch", deg_shape=list(deg.shape),
                             tar_shape=list(tar.shape))
                continue
            out = self._restorer(deg)
            total += float(psnr(torch.from_numpy(out), torch.from_numpy(tar), 1.0))
            n += 1
        self.state.t_net.train()
        if skipped:
            self.log.log("eval_skipped_total", skipped=skipped, evaluated=n)
        return total / n if n else float("nan")

    def fit(self, *, eval_degset: Optional[str] = None,
            eval_tarset: Optional[str] = None,
            profile_dir: Optional[str] = None) -> TrainState:
        # a bad validation setup fails before the first epoch, not after it
        if (eval_degset is None) != (eval_tarset is None):
            raise ValueError("eval_degset and eval_tarset must be given together "
                             f"(got degset={eval_degset!r}, tarset={eval_tarset!r})")
        for name, path in (("eval_degset", eval_degset), ("eval_tarset", eval_tarset)):
            if path and not os.path.isdir(path):
                raise FileNotFoundError(f"{name} is not a directory: {path!r}")
        if self.state is None:
            self.init_state()
        t = self.cfg.train
        restore = self._install_preemption_handlers()
        try:
            for epoch in range(self.start_epoch, t.num_epochs + 1):
                start = self.start_step if epoch == self.start_epoch else 0
                self.train_epoch(epoch, start,
                                 profile_dir if epoch == self.start_epoch else None)
                if eval_degset and epoch % t.eval_every == 0:
                    if (self._resume_config_ok
                            and self._validated_epochs.get(epoch) == eval_degset):
                        # training is step-exact, so the PSNR would repeat
                        self.log.log("validation_skipped", epoch=epoch,
                                     reason="already_in_log")
                    else:
                        p = self.evaluate_folder(eval_degset, eval_tarset)
                        self.log.log("validation", epoch=epoch, psnr=p,
                                     patch_size=self.cfg.data.patch_size,
                                     batch_size=t.batch_size, degset=eval_degset)
                if epoch % t.ckpt_every == 0:
                    self.save(epoch + 1)  # a resume starts at the next epoch
        except Preempted:
            pass  # checkpointed and logged at the step boundary
        finally:
            restore()
            # the write in flight must be durable before the process exits;
            # its failure must not replace an exception already unwinding
            primary = sys.exc_info()[1]
            try:
                self._async_ckpt.wait()
            except Exception as ckpt_err:
                if primary is None:
                    raise
                self.log.log("async_ckpt_error_suppressed", error=repr(ckpt_err)[:300])
        return self.state

    def _install_preemption_handlers(self):
        """SIGTERM and SIGINT set a flag; the loop checkpoints at the next
        step boundary and stops. A second SIGINT raises KeyboardInterrupt.
        Returns restore(); off the main thread it installs nothing."""
        def on_signal(signum, frame):
            if signum == signal.SIGINT and self._preempted:
                raise KeyboardInterrupt
            self._preempted = True

        previous = {}
        try:
            for s in (signal.SIGTERM, signal.SIGINT):
                previous[s] = signal.signal(s, on_signal)
        except ValueError:  # not the main thread
            pass

        def restore():
            for s, h in previous.items():
                signal.signal(s, h)

        return restore
