"""The port's trainer and train CLI (rcot_torch/train/trainer.py,
rcot_torch/cli/train.py) on the CPU, with a tiny T_net (dim 8, one block
per level), patch 32, batch 3, on a seeded synthetic tree of 1 denoise
image (x5) and 2 hazy pairs: 7 samples, 2 steps an epoch.

- Config.hash() and hash_legacy() equal the JAX package's for every preset
  (checkpoints carry the hash; resume checks it).
- The CLI takes the JAX CLI's flags, and refuses the flags of paths that
  are not ported.
- fit() logs the JAX trainer's events and leaves latest.npz.
- A run stopped by --fail-at-step and resumed from its latest checkpoint
  ends with parameters and optimizer state bitwise equal to an
  uninterrupted run's (every draw is keyed by (seed, step); the CPU
  kernels are deterministic).
- The preemption flag checkpoints at the step boundary and stops.
- A validation already in the resumed log is skipped.
- The JSONL log stays strict JSON, and the profiler window writes a trace.
- The sample grids equal the JAX package's, pixel for pixel.
"""

import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from rcot_torch.cli import train as tcli
from rcot_torch.data.synthetic import write_synthetic_tree
from rcot_torch.train import steps as tsteps
from rcot_torch.train.trainer import InjectedFailure, Trainer
from rcot_torch.utils import checkpoint as tckpt
from rcot_torch.utils import config as tconfig
from rcot_torch.utils.logging import MetricsLogger, profile_trace
from rcot_tpu.cli import train as jcli
from rcot_tpu.utils import config as jconfig


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads for these tiny nets. Under pytest-xdist several
    workers share the cores, and torch's default of one thread per core
    spins them against each other: two of these tests that take 16 s alone
    took 199 s beside five busy cores, and 17 s there with two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_config_hash_matches_jax(name):
    j, t = jconfig.PRESETS[name], tconfig.PRESETS[name]
    assert t.to_dict() == j.to_dict()
    assert t.hash() == j.hash()
    assert t.hash_legacy() == j.hash_legacy()
    assert tconfig.config_from_dict(j.to_dict()) == t


JAX_FLAGS = ["--preset", "all_in_one", "--batch-size", "4", "--n-epochs", "3", "--lr", "2e-4",
             "--step", "5", "--pairnum", "30", "--de-type", "derain", "dehaze",
             "--denoise-dir", "a/", "--derain-dir", "b/", "--dehaze-dir", "c/",
             "--deblur-dir", "d/", "--lowlight-dir", "e/", "--single-dir", "f/",
             "--data-file-dir", "g/", "--degset", "h/", "--tarset", "i/", "--Sigma", "5",
             "--sigma", "2", "--optimizer", "Adam", "--type", "Run", "--patch-size", "64",
             "--num-workers", "2", "--seed", "4", "--dtype", "float32", "--loss-math", "clean",
             "--fail-at-step", "9", "--ckpt-dir", "j/", "--ckpt-every-steps", "3",
             "--log-file", "k.jsonl", "--profile-dir", "l/", "--backbone", "restormer",
             "--resume", "m.npz"]


def test_cli_takes_the_jax_flags():
    got = tcli.build_parser().parse_args(JAX_FLAGS)
    want = jcli.build_parser().parse_args(JAX_FLAGS)
    assert {k: v for k, v in vars(got).items() if k not in ("device", "composition")} == vars(want)
    assert (got.device, got.composition) == ("cuda", "auto")
    t_cfg = tcli.overlay_config(tconfig.get_preset(got.preset), got)
    j_cfg = jcli.overlay_config(jconfig.get_preset(want.preset), want)
    assert t_cfg.hash() == j_cfg.hash()


@pytest.mark.parametrize("flags", [["--mesh-data", "2"], ["--coordinator", "h:1"],
                                   ["--num-processes", "2"], ["--backbone", "mprnet"],
                                   ["--dtype", "bfloat16", "--composition", "full"],
                                   ["--pretrained", "w.pth"]],
                         ids=lambda f: f[0])
def test_cli_refuses_unported_flags(flags):
    with pytest.raises(SystemExit, match="not ported"):
        tcli.main(flags + ["--device", "cpu"])


TINY_MODEL = tconfig.ModelConfig(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                                 parity_params=False)


@pytest.fixture
def tree(tmp_path):
    root = tmp_path / "tree"
    write_synthetic_tree(str(root), seed=1, n_denoise=1, n_rain=0, n_haze=2, size=48,
                         val_sizes=((32, 32), (20, 27)))
    return root


def _flags(tree, run, *extra):
    return ["--device", "cpu", "--preset", "dehaze", "--de-type", "denoise_15", "dehaze",
            "--patch-size", "32", "--batch-size", "3", "--pairnum", "3", "--n-epochs", "2",
            "--num-workers", "2", "--denoise-dir", f"{tree}/Train/Denoise/",
            "--dehaze-dir", f"{tree}/Train/Dehaze/", "--data-file-dir", f"{tree}/manifests/",
            "--ckpt-dir", f"{run}/ckpt", "--log-file", f"{run}/log.jsonl", *extra]


def _config(argv):
    args = tcli.build_parser().parse_args(argv)
    cfg = tcli.overlay_config(tconfig.get_preset(args.preset), args)
    return cfg.replace(model=TINY_MODEL,
                       train=tconfig.dataclasses.replace(cfg.train, log_every=1))


@pytest.fixture
def tiny_presets(monkeypatch):
    """The CLI's presets with the tiny T_net and a log line every step."""
    real = tconfig.get_preset

    def tiny(name):
        cfg = real(name)
        return cfg.replace(model=TINY_MODEL,
                           train=tconfig.dataclasses.replace(cfg.train, log_every=1))
    monkeypatch.setattr(tcli, "get_preset", tiny)


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_fit_logs_the_events(tree, tmp_path):
    run = tmp_path / "run"
    trainer = Trainer(_config(_flags(tree, run)), log_path=f"{run}/log.jsonl", device="cpu")
    assert trainer.composition == "tail"
    trainer.fit(eval_degset=f"{tree}/val/input/", eval_tarset=f"{tree}/val/target/")
    assert trainer.state.t_net.composition == "tail"
    ev = _events(f"{run}/log.jsonl")
    kinds = [e["event"] for e in ev]
    assert kinds == ["epoch_start", "train_step", "train_step", "epoch_end", "validation"] * 2
    steps = [e for e in ev if e["event"] == "train_step"]
    assert [e["step"] for e in steps] == [1, 2, 3, 4]
    assert all(e["sec_per_step"] > 0 and e["imgs_per_sec"] > 0 for e in steps)
    for e in steps:
        assert all(math.isfinite(e[k]) for k in ("f_wgan", "f_gp", "t_loss", "rmse"))
    # pairnum 3 // batch 3: only the first step of each epoch is paired, and
    # there the paired L1 at Sigma 1e4 dominates the T loss
    assert [e["t_loss"] > 100 for e in steps] == [True, False, True, False]
    vals = [e for e in ev if e["event"] == "validation"]
    assert [v["epoch"] for v in vals] == [1, 2] and all(math.isfinite(v["psnr"]) for v in vals)
    assert os.readlink(run / "ckpt" / "latest.npz") == "Dehazing_step4.npz"
    assert tckpt.read_metadata(str(run / "ckpt" / "latest.npz"))["epoch"] == 3


def _final_state(path, cfg):
    state = tsteps.create_train_state(cfg, seed=None, device="cpu")
    tckpt.load_checkpoint(path, state)
    return state


def test_fail_then_resume_is_bitwise_the_uninterrupted_run(tree, tmp_path, tiny_presets):
    whole = tmp_path / "whole"
    argv = _flags(tree, whole)
    trainer = Trainer(_config(argv), log_path=f"{whole}/log.jsonl", device="cpu")
    want = trainer.fit()

    run = tmp_path / "run"
    with pytest.raises(InjectedFailure, match="step 3"):
        tcli.main(_flags(tree, run, "--fail-at-step", "3", "--ckpt-every-steps", "1"))
    latest = run / "ckpt" / "latest.npz"
    meta = tckpt.read_metadata(str(latest))
    tcli.main(_flags(tree, run, "--ckpt-every-steps", "1", "--resume", str(latest)))
    resumed = [e for e in _events(f"{run}/log.jsonl") if e["event"] == "resumed"]
    assert [(e["epoch"], e["epoch_step"]) for e in resumed] == [(meta["epoch"],
                                                                 meta["epoch_step"])]
    got = _final_state(str(latest), _config(argv))
    for net_g, net_w in ((got.t_net, want.t_net), (got.f_net, want.f_net)):
        for (n, p), q in zip(net_g.named_parameters(), net_w.parameters()):
            assert torch.equal(p, q), n
    for opt_g, opt_w, net_g, net_w in ((got.t_opt, want.t_opt, got.t_net, want.t_net),
                                       (got.f_opt, want.f_opt, got.f_net, want.f_net)):
        for p, q in zip(net_g.parameters(), net_w.parameters()):
            assert torch.equal(opt_g.state[p]["square_avg"], opt_w.state[q]["square_avg"])
    assert got.step == want.step == 4


def test_preemption_checkpoints_and_stops(tree, tmp_path):
    run = tmp_path / "run"
    trainer = Trainer(_config(_flags(tree, run)), log_path=f"{run}/log.jsonl", device="cpu")
    real = trainer.iteration

    def preempted_after_one(*args):
        trainer._preempted = True  # what the SIGTERM/SIGINT handler sets
        return real(*args)
    trainer.iteration = preempted_after_one
    trainer.fit()
    ev = _events(f"{run}/log.jsonl")
    assert [e["event"] for e in ev][-1] == "preempted"
    assert trainer.host_step == 1
    meta = tckpt.read_metadata(str(run / "ckpt" / "latest.npz"))
    assert (meta["epoch"], meta["epoch_step"]) == (1, 1)


def test_logged_validation_is_skipped_on_resume(tree, tmp_path):
    run = tmp_path / "run"
    cfg = _config(_flags(tree, run))
    evalset = dict(eval_degset=f"{tree}/val/input/", eval_tarset=f"{tree}/val/target/")
    Trainer(cfg, log_path=f"{run}/log.jsonl", device="cpu").fit(**evalset)
    # the end-of-epoch-1 checkpoint (resume at epoch 2), same config, same log
    again = Trainer(cfg, log_path=f"{run}/log.jsonl", device="cpu")
    again.resume(str(run / "ckpt" / "Dehazing_step2.npz"))
    assert (again.start_epoch, again.start_step) == (2, 0)
    again.fit(**evalset)
    ev = _events(f"{run}/log.jsonl")
    tail = [e["event"] for e in ev[ev.index(next(e for e in ev if e["event"] == "resumed")):]]
    assert tail == ["resumed", "epoch_start", "train_step", "train_step", "epoch_end",
                    "validation_skipped"]
    other = Trainer(cfg.replace(train=tconfig.dataclasses.replace(cfg.train, lr=3e-4)),
                    log_path=f"{run}/log.jsonl", device="cpu")
    other.resume(str(run / "ckpt" / "Dehazing_step2.npz"))
    assert not other._resume_config_ok
    assert _events(f"{run}/log.jsonl")[-2]["event"] == "resume_config_mismatch"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(tconfig.Config())
    with pytest.raises(RuntimeError, match="cuda"):
        tsteps.create_train_state(tconfig.Config())
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["--preset", "derain"])


def test_metrics_logger_writes_strict_json(tmp_path):
    log = MetricsLogger(str(tmp_path / "logs" / "run.jsonl"))
    log.log("train_step", loss=torch.tensor(0.5), bad=float("nan"), step=3)
    (rec,) = _events(tmp_path / "logs" / "run.jsonl")
    assert (rec["event"], rec["loss"], rec["bad"], rec["step"]) == ("train_step", 0.5, None, 3)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "prof")):
        torch.ones(4, 4) @ torch.ones(4, 4)
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_sample_grids_match_jax(tmp_path):
    from rcot_torch.utils import image_io as tio
    from rcot_tpu.utils import image_io as jio
    rng = np.random.default_rng(5)
    imgs = {"output": rng.uniform(0, 1, (3, 10, 12, 3)).astype(np.float32),
            "res": rng.uniform(-0.2, 1.2, (3, 10, 12, 3)).astype(np.float32)}
    tio.save_sample_grid(str(tmp_path / "port"), "epoch1", **imgs)
    jio.save_sample_grid(str(tmp_path / "jax"), "epoch1", **imgs)
    for name in imgs:
        got = np.asarray(Image.open(tmp_path / "port" / f"epoch1_{name}.png"))
        want = np.asarray(Image.open(tmp_path / "jax" / f"epoch1_{name}.png"))
        assert got.shape == (14, 44, 3)
        np.testing.assert_array_equal(got, want)
