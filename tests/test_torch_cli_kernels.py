"""The kernel flags of the port's CLIs, its Trainer and make_restorer
(rcot_torch/cli/train.py, rcot_torch/cli/test.py, rcot_torch/train/,
rcot_torch/models/inference.py), on the CPU with a tiny T_net.

- cli.train and cli.test parse --attention-core and --depthwise (and
  cli.test --composition), thread them into Trainer / make_restorer, and
  refuse unknown values; without them the defaults are today's.
- make_restorer runs its forwards in the three choices it was given and
  leaves a shared TNet's own three as it found them.
- The Trainer builds its T_net in its choices and validates in "full"
  with the same attention core and depthwise tier.
- A short cli.test run in off/mdta/dwconv on the CPU prints a finite PSNR.
- In every composition x attention core x depthwise tier, a forward and
  backward reaches each kernel wrapper as often as chip_smoke.py's launch
  counts for it say.
- cli.train --bwd-bf16 (RCOT_BWD_BF16) reaches the Trainer, which refuses
  an unknown tier; with it a forward and backward reaches each backward
  wrapper's bf16-operand form where chip_smoke.py counts it.
"""

import collections
import itertools
import math
import re

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from rcot_torch.cli import test as test_cli
from rcot_torch.cli import train as train_cli
from rcot_torch.data.synthetic import write_synthetic_tree
from rcot_torch.kernels.build import counted as tcounted
from rcot_torch.models import inference as tinf
from rcot_torch.models.restormer import TNet
from rcot_torch.ops import block as tblock
from rcot_torch.ops import dwconv as tdw
from rcot_torch.ops import fused as tfused
from rcot_torch.ops import gram as tgram
from rcot_torch.ops import mdta as tmdta
from rcot_torch.ops.dispatch import ATTENTION_CORES, COMPOSITIONS, DEPTHWISE
from rcot_torch.train import steps as tsteps
from rcot_torch.train import trainer as ttrainer
from rcot_torch.utils import checkpoint as tckpt
from rcot_torch.utils import config as tconfig

TINY = tconfig.ModelConfig(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                           parity_params=False)
KERNEL_FLAGS = ["--attention-core", "mdta", "--depthwise", "dwconv"]


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads, as tests/test_torch_trainer.py sets them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Recorder:
    """Stands in for Trainer: records its keyword arguments, fits nothing."""
    seen: dict = {}

    def __init__(self, cfg, **kw):
        _Recorder.seen = kw

    def resume(self, path):
        pass

    def fit(self, **kw):
        pass


@pytest.mark.parametrize("flags,want", [
    ([], ("auto", "gram", "fused")),
    (KERNEL_FLAGS, ("auto", "mdta", "dwconv")),
    (["--composition", "off"] + KERNEL_FLAGS, ("off", "mdta", "dwconv")),
    (["--attention-core", "mdta"], ("auto", "mdta", "fused")),
], ids=["defaults", "mdta-dwconv", "off-mdta-dwconv", "mdta"])
def test_train_cli_threads_the_kernel_flags_into_the_trainer(monkeypatch, flags, want):
    monkeypatch.setattr(ttrainer, "Trainer", _Recorder)
    train_cli.main(["--device", "cpu"] + flags)
    got = _Recorder.seen
    assert (got["composition"], got["attention_core"], got["depthwise"]) == want
    assert got["device"] == "cpu"


@pytest.mark.parametrize("cli,flags", [
    (train_cli, ["--attention-core", "gram-kernel"]), (train_cli, ["--depthwise", "shifts"]),
    (test_cli, ["--attention-core", "pallas"]), (test_cli, ["--depthwise", "1"]),
    (test_cli, ["--composition", "auto"])],
    ids=["train-core", "train-depthwise", "test-core", "test-depthwise", "test-composition"])
def test_clis_refuse_unknown_kernel_values(cli, flags, capsys):
    extra = [] if cli is train_cli else ["--ckpt", "m.npz", "--degset", "d/", "--tarset", "t/"]
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(extra + flags)
    assert "invalid choice" in capsys.readouterr().err


def test_test_cli_parses_the_kernel_flags():
    base = ["--ckpt", "m.npz", "--degset", "d/", "--tarset", "t/"]
    args = test_cli.build_parser().parse_args(base)
    assert (args.composition, args.attention_core, args.depthwise) == ("full", "gram", "fused")
    args = test_cli.build_parser().parse_args(base + ["--composition", "off"] + KERNEL_FLAGS)
    assert (args.composition, args.attention_core, args.depthwise) == ("off", "mdta", "dwconv")


def _choices(net):
    return (net.composition, net.attention_core, net.depthwise)


def test_make_restorer_runs_its_choices_and_leaves_the_net_as_it_found_it():
    net = TNet(TINY, device="cpu", seed=1, composition="tail")
    seen = []
    real = net.forward

    def forward(x, **kw):
        seen.append(_choices(net))
        return real(x, **kw)
    net.forward = forward
    img = np.random.default_rng(1).uniform(0, 1, (16, 24, 3)).astype(np.float32)
    outs = {}
    for kernels in (("full", "gram", "fused"), ("off", "mdta", "dwconv")):
        r = tinf.make_restorer(net, TINY, device="cpu", **dict(zip(
            ("composition", "attention_core", "depthwise"), kernels)))
        outs[kernels] = r(img)
        assert seen[-1] == kernels
        assert _choices(net) == ("tail", "gram", "fused")
    a, b = outs.values()
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="attention core"):
        tinf.make_restorer(net, TINY, device="cpu", attention_core="x")
    with pytest.raises(ValueError, match="depthwise"):
        tinf.make_restorer(net, TINY, device="cpu", depthwise="x")


def test_trainer_builds_and_validates_in_its_choices(tmp_path):
    root = tmp_path / "tree"
    write_synthetic_tree(str(root), seed=1, n_denoise=1, n_rain=0, n_haze=2, size=48,
                         val_sizes=((16, 24),))
    args = train_cli.build_parser().parse_args([
        "--preset", "dehaze", "--de-type", "denoise_15", "dehaze", "--patch-size", "32",
        "--denoise-dir", f"{root}/Train/Denoise/", "--dehaze-dir", f"{root}/Train/Dehaze/",
        "--data-file-dir", f"{root}/manifests/"])
    cfg = train_cli.overlay_config(tconfig.get_preset(args.preset), args).replace(model=TINY)
    trainer = ttrainer.Trainer(cfg, device="cpu", attention_core="mdta", depthwise="dwconv")
    state = trainer.init_state()
    assert _choices(state.t_net) == ("tail", "mdta", "dwconv")
    seen = []
    real = state.t_net.forward

    def forward(x, **kw):
        seen.append(_choices(state.t_net))
        return real(x, **kw)
    state.t_net.forward = forward
    psnr = trainer.evaluate_folder(f"{root}/val/input/", f"{root}/val/target/")
    assert math.isfinite(psnr)
    assert seen == [("full", "mdta", "dwconv")]
    assert _choices(state.t_net) == ("tail", "mdta", "dwconv")
    state = tsteps.create_train_state(cfg, seed=0, device="cpu", attention_core="mdta")
    assert _choices(state.t_net) == ("tail", "mdta", "fused")


def test_test_cli_restores_in_off_mdta_dwconv(tmp_path, monkeypatch, capsys):
    """A tiny trainer checkpoint in the JAX .npz format, restored by
    cli.test on the CPU in off/mdta/dwconv: make_restorer gets the flags,
    and the PSNR printed is finite."""
    cfg = tconfig.Config(model=TINY)
    state = tsteps.create_train_state(cfg, seed=0, device="cpu")
    ckpt = tckpt.save_checkpoint(str(tmp_path / "m_step0"), tckpt.snapshot_state(state),
                                 metadata={"config": cfg.to_dict()})
    deg, tar = tmp_path / "deg", tmp_path / "tar"
    deg.mkdir()
    tar.mkdir()
    rng = np.random.default_rng(3)
    for i, (h, w) in enumerate([(24, 20), (16, 16)]):
        t = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        d = np.clip(t.astype(int) + rng.integers(-30, 30, t.shape), 0, 255).astype(np.uint8)
        Image.fromarray(d).save(deg / f"im{i}.png")
        Image.fromarray(t).save(tar / f"im{i}.png")
    seen = {}
    real = test_cli.make_restorer

    def recording(*args, **kw):
        seen.update(kw)
        return real(*args, **kw)
    monkeypatch.setattr(test_cli, "make_restorer", recording)
    out = tmp_path / "out"
    test_cli.main(["--ckpt", ckpt, "--degset", str(deg), "--tarset", str(tar),
                   "--save", f"{out}/o/", "--savetar", f"{out}/t/", "--saveres", f"{out}/r/",
                   "--device", "cpu", "--composition", "off"] + KERNEL_FLAGS)
    assert {k: seen[k] for k in ("composition", "attention_core", "depthwise")} == {
        "composition": "off", "attention_core": "mdta", "depthwise": "dwconv"}
    printed = capsys.readouterr().out
    avg = float(re.search(r"PSNR: average ([-\d.naif]+)", printed).group(1))
    assert math.isfinite(avg)


# what each wrapper would count on the card, by the arguments it is given
WRAPPERS = [(tblock, "block_head_fwd", "block_head"), (tblock, "block_tail_fwd", "block_tail"),
            (tblock, "block_head_bwd", "block_head_bwd"),
            (tblock, "block_tail_bwd", "block_tail_bwd"),
            (tgram, "mdta_gram_fwd", "mdta_gram_fwd"), (tgram, "attn_apply_fwd", "attn_apply_fwd"),
            (tgram, "mdta_gram_bwd", "mdta_gram_bwd"), (tgram, "attn_apply_bwd", "attn_apply_bwd"),
            (tfused, "fused_dwconv_fwd", ("conv1x1_dw", "gdfn_fused")),
            (tfused, "fused_dwconv_bwd", ("conv1x1_dw_bwd", "gdfn_fused_bwd")),
            (tmdta, "mdta_attend_fwd", "mdta_attend"), (tdw, "dwconv3x3_fwd", "dwconv3x3"),
            (tdw, "dwconv3x3_dx", "dwconv3x3_dx"), (tdw, "dwconv3x3_dtaps", "dwconv3x3_dtaps")]


@pytest.mark.parametrize("kernels", list(itertools.product(COMPOSITIONS, ATTENTION_CORES,
                                                           DEPTHWISE)), ids="-".join)
def test_chip_smoke_counts_the_wrappers_each_tier_reaches(monkeypatch, kernels):
    """One forward and backward of the tiny T_net (22 blocks a two-pass
    forward) on the CPU reaches each wrapper as often as
    chip_smoke.expected_launches(22, ...) says its kernel launches on the
    card, and no other."""
    calls = collections.Counter()
    for mod, fn, name in WRAPPERS:
        def counted(*args, _real=getattr(mod, fn), _name=name):
            # the fused tier's wrappers serve both configurations; w_out
            # (the fourth argument) tells them apart
            calls[_name if isinstance(_name, str) else _name[args[3] is not None]] += 1
            return _real(*args)
        monkeypatch.setattr(mod, fn, counted)
    net = TNet(TINY, device="cpu", seed=0,
               **dict(zip(("composition", "attention_core", "depthwise"), kernels)))
    sum(o.sum() for o in net(torch.rand(1, 16, 16, 3))).backward()
    mode, core, tier = kernels
    assert dict(calls) == chip_smoke.expected_launches(22, mode, core=core, depthwise=tier)


# ------------------------------------------------------------ --bwd-bf16

@pytest.mark.parametrize("flags,want", [
    ([], "0"), (["--bwd-bf16", "all"], "all"), (["--bwd-bf16", "fused,gram"], "fused,gram"),
    (["--bwd-bf16", "all", "--composition", "full"], "all")],
    ids=["default-off", "all", "fused-gram", "all-full"])
def test_train_cli_threads_bwd_bf16_into_the_trainer(monkeypatch, flags, want):
    """cli.train --bwd-bf16 (the JAX package's RCOT_BWD_BF16) reaches the
    Trainer as given; without it the option is off."""
    monkeypatch.setattr(ttrainer, "Trainer", _Recorder)
    train_cli.main(["--device", "cpu"] + flags)
    assert _Recorder.seen["bwd_bf16"] == want
    assert "bwd_bf16" not in vars(train_cli.build_parser().parse_args([]))


def test_trainer_and_train_state_take_bwd_bf16_and_refuse_unknown_tiers():
    """The Trainer resolves the tiers once (an unknown name stops it before
    anything is built) and builds its T_net with them on every block;
    Config.hash() does not see them."""
    cfg = tconfig.Config(model=TINY)
    with pytest.raises(ValueError, match="blok"):
        ttrainer.Trainer(cfg, device="cpu", bwd_bf16="block,blok")
    state = tsteps.create_train_state(cfg, seed=0, device="cpu", bwd_bf16="block,gram")
    assert state.t_net.bwd_bf16 == {"block", "gram"}
    blocks = [m for m in state.t_net.modules() if hasattr(m, "ffn")]
    assert blocks and all(b.bwd_bf16 == {"block", "gram"} for b in blocks)
    state.t_net.bwd_bf16 = "all"
    assert all(b.bwd_bf16 == {"block", "gram", "fused"} for b in blocks)
    assert tsteps.create_train_state(cfg, seed=0, device="cpu").t_net.bwd_bf16 == frozenset()


@pytest.mark.parametrize("mode,tiers", [("full", "all"), ("tail", "gram"), ("off", "fused"),
                                        ("head", "block,fused")], ids="-".join)
def test_chip_smoke_counts_the_bf16_operand_forms_each_tier_reaches(monkeypatch, mode, tiers):
    """With bwd_bf16, a forward and backward of the tiny T_net reaches each
    backward wrapper with bf16_ops exactly where chip_smoke.with_b16ops
    counts its _b16ops form, and every other wrapper as before."""
    calls = collections.Counter()
    for mod, fn, name in WRAPPERS:
        def counted(*args, _real=getattr(mod, fn), _name=name, **kw):
            key = _name if isinstance(_name, str) else _name[args[3] is not None]
            calls[tcounted(key, bool(kw.get("bf16_ops", args[-1] is True)))] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(mod, fn, counted)
    net = TNet(TINY, device="cpu", seed=0, composition=mode, bwd_bf16=tiers)
    sum(o.sum() for o in net(torch.rand(1, 16, 16, 3))).backward()
    assert dict(calls) == chip_smoke.with_b16ops(chip_smoke.expected_launches(22, mode),
                                                 net.bwd_bf16)
