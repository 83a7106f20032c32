"""The port's evaluation CLIs and test sets against the JAX package's, on the
CPU, on one tiny checkpoint written by the JAX package.

Tolerances: the four dataset classes give identical arrays (noise
included); cli.eval_all's per-task psnr and input_psnr within 1e-3 dB and
ssim within 1e-4 (as tests/test_torch_inference.py holds cli.test), the same
n and skipped; cli.test's LPIPS average within 1e-5 and its NIQE average
(of restored images that differ by fp32 rounding) equal to its 5 printed
decimals.
"""

import json
import os
import re

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rcot_torch.cli import eval_all as t_eval
from rcot_torch.cli import test as t_test
from rcot_torch.data import eval_datasets as tds
from rcot_torch.data import synthetic
from rcot_tpu.cli import eval_all as j_eval
from rcot_tpu.cli import test as j_test
from rcot_tpu.data import eval_datasets as jds


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _save(path, img):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path)


def _degrade(rng, img, spread=40):
    return np.clip(img.astype(int) + rng.integers(-spread, spread, img.shape),
                   0, 255).astype(np.uint8)


def write_eval_tree(root, seed=0):
    """Every task's layout (rcot_torch/data/synthetic.py), sizes off
    multiples of 16, and a --paired item whose shapes differ (skipped)."""
    rng = np.random.default_rng(seed + 100)
    synthetic.write_eval_tree(root, seed=seed, size=(40, 44))
    _save(f"{root}/paired/target/p2.png", rng.integers(0, 255, (40, 60, 3), dtype=np.uint8))
    _save(f"{root}/paired/input/p2.png", rng.integers(0, 255, (40, 44, 3), dtype=np.uint8))
    return root


def eval_argv(root, ckpt, out_json):
    return ["--ckpt", ckpt, "--denoise-path", f"{root}/denoise", "--sigmas", "15", "50",
            "--derain-path", f"{root}/derain", "--dehaze-path", f"{root}/dehaze",
            "--deblur-dir", f"{root}/deblur", "--lowlight-dir", f"{root}/lowlight",
            "--paired", "val", f"{root}/paired", "--json-out", out_json]


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory, tiny_config):
    from rcot_tpu.train.steps import create_train_state
    from rcot_tpu.utils.checkpoint import save_checkpoint
    state = create_train_state(jax.random.PRNGKey(0), tiny_config)
    return save_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "m_step0"), state,
                           metadata={"config": tiny_config.to_dict()})


# ------------------------------------------------------------ the test sets

def test_datasets_match_jax(tmp_path):
    root = write_eval_tree(str(tmp_path))

    def same(a, b):
        assert len(a) == len(b) > 0
        for i in range(len(a)):
            (n1, d1, c1), (n2, d2, c2) = a[i], b[i]
            assert n1 == n2
            assert d1.shape[0] % 16 == 0 and d1.shape[1] % 16 == 0
            np.testing.assert_array_equal(d1, d2)
            np.testing.assert_array_equal(c1, c2)

    # the noise stream is reseeded per sigma, so the order the sigmas are
    # taken in changes no sigma's arrays: the port's set takes 50 before 15,
    # the JAX one 15 before 50
    t = tds.DenoiseTestDataset(f"{root}/denoise", 50)
    j = jds.DenoiseTestDataset(f"{root}/denoise", 15)
    t[0]
    t.set_sigma(15)
    same(t, j)
    t.set_sigma(50)
    j.set_sigma(50)
    same(t, j)
    for task in ("derain", "dehaze"):
        a = tds.DerainDehazeDataset(f"{root}/derain", f"{root}/dehaze", task=task)
        b = jds.DerainDehazeDataset(f"{root}/derain", f"{root}/dehaze", task=task)
        assert [a._gt_path(p) for p in a.ids] == [b._gt_path(p) for p in b.ids]
        assert all(os.path.isfile(a._gt_path(p)) for p in a.ids)
        same(a, b)
        same(tds.DerainDehazeDataset(f"{root}/derain", f"{root}/dehaze", task=task,
                                     addnoise=True, sigma=25, seed=3),
             jds.DerainDehazeDataset(f"{root}/derain", f"{root}/dehaze", task=task,
                                     addnoise=True, sigma=25, seed=3))
    for kw in ({}, dict(addnoise=True, sigma=15, seed=2)):
        same(tds.DeblurTestDataset(f"{root}/deblur", **kw),
             jds.DeblurTestDataset(f"{root}/deblur", **kw))
        same(tds.LowLightTestDataset(f"{root}/lowlight", **kw),
             jds.LowLightTestDataset(f"{root}/lowlight", **kw))
    assert len(tds.DeblurTestDataset(f"{root}/deblur", is_val=True, val_split=1)) == 1
    with pytest.raises(KeyError):
        tds.DerainDehazeDataset(f"{root}/derain", task="deblur")


def test_synthetic_eval_tree_cli(tmp_path):
    """python -m rcot_torch.data.synthetic ROOT --eval writes every task's
    folders, each image's GT where its task's rules look for it."""
    root = str(tmp_path / "ev")
    synthetic.main([root, "--eval", "--size", "48"])
    ds = tds.DerainDehazeDataset(f"{root}/derain", f"{root}/dehaze", task="dehaze")
    assert len(ds) == 2 and all(os.path.isfile(ds._gt_path(p)) for p in ds.ids)
    for ds in (tds.DenoiseTestDataset(f"{root}/denoise"), tds.DeblurTestDataset(f"{root}/deblur"),
               tds.LowLightTestDataset(f"{root}/lowlight")):
        name, deg, clean = ds[1]
        assert len(ds) == 2 and deg.shape == clean.shape == (48, 48, 3)


# ------------------------------------------------------------ cli.eval_all

def test_eval_all_matches_jax(tmp_path, jax_ckpt, capsys):
    root = write_eval_tree(str(tmp_path / "tree"))
    t_json, j_json = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    assert t_eval.main(eval_argv(root, jax_ckpt, t_json) + ["--device", "cpu"]) == 0
    assert j_eval.main(eval_argv(root, jax_ckpt, j_json)) == 0
    got, want = json.load(open(t_json)), json.load(open(j_json))
    assert got["ckpt"] == want["ckpt"] == jax_ckpt
    keys = ["denoise_sigma15", "denoise_sigma50", "derain", "dehaze", "deblur",
            "lowlight", "val"]
    assert list(got["results"]) == list(want["results"]) == keys
    for key in keys:
        g, w = got["results"][key], want["results"][key]
        assert g["n"] == w["n"] == 2, key
        assert g.get("skipped") == w.get("skipped") == (1 if key == "val" else None)
        for k in ("psnr", "input_psnr"):
            assert np.isfinite(g[k]) and abs(g[k] - w[k]) <= 1e-3 + 5e-5, (key, k)
        for k in ("ssim", "input_ssim"):
            assert abs(g[k] - w[k]) <= 1e-4 + 5e-6, (key, k)
    assert "eval_skip task=val item=p2 reason=shape_mismatch" in capsys.readouterr().out


def test_eval_all_kernel_tiers_compute_the_same(tmp_path, jax_ckpt):
    """--composition off --attention-core mdta --depthwise dwconv reach the
    restorer and give the default's rows."""
    root = write_eval_tree(str(tmp_path / "tree"))
    rows = []
    for extra in ([], ["--composition", "off", "--attention-core", "mdta",
                       "--depthwise", "dwconv"]):
        out = str(tmp_path / f"{len(rows)}.json")
        assert t_eval.main(["--ckpt", jax_ckpt, "--paired", "val", f"{root}/paired",
                            "--json-out", out, "--device", "cpu"] + extra) == 0
        rows.append(json.load(open(out))["results"]["val"])
    a, b = rows
    assert a["n"] == b["n"] == 2 and abs(a["psnr"] - b["psnr"]) <= 1e-3 + 5e-5
    assert abs(a["ssim"] - b["ssim"]) <= 1e-4 + 5e-6


def test_eval_all_broken_gt_tree_matches_jax(tmp_path, jax_ckpt):
    """A derain tree with a missing GT: the same error row in both packages,
    the other task's row still written, exit code 1."""
    root = write_eval_tree(str(tmp_path / "tree"))
    os.remove(f"{root}/derain/target/x1-norain.png")
    rows = []
    for main, extra, name in ((t_eval.main, ["--device", "cpu"], "t"), (j_eval.main, [], "j")):
        out = str(tmp_path / f"{name}.json")
        rc = main(["--ckpt", jax_ckpt, "--derain-path", f"{root}/derain",
                   "--paired", "val", f"{root}/paired", "--json-out", out] + extra)
        assert rc == 1
        rows.append(json.load(open(out))["results"])
    got, want = rows
    assert got["derain"] == want["derain"]
    assert got["derain"]["error"].startswith("FileNotFoundError: 1/2 derived GT paths missing")
    assert got["val"]["n"] == want["val"]["n"] == 2


def test_eval_all_failed_task_is_isolated(tmp_path, jax_ckpt):
    """Tasks whose folders do not exist: each gets its error row in the
    partial JSON, exit code 1."""
    ckpt = jax_ckpt
    out = str(tmp_path / "s.json")
    rc = t_eval.main(["--ckpt", ckpt, "--deblur-dir", str(tmp_path / "none"),
                      "--paired", "v", str(tmp_path / "none"), "--json-out", out,
                      "--device", "cpu"])
    assert rc == 1
    res = json.load(open(out))["results"]
    assert set(res) == {"deblur", "v"} and all("error" in r for r in res.values())


# ------------------------------------------------------------ cli.test

def test_cli_test_metrics_match_jax(tmp_path, jax_ckpt, capsys):
    """cli.test with --lpips and --niqe-model fit:FOLDER in both packages
    on one folder (a 200x208 pair NIQE scores, a 64x72 pair it skips)."""
    rng = np.random.default_rng(5)
    for i, (h, w) in enumerate([(200, 208), (64, 72)]):
        clean = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        _save(f"{tmp_path}/tar/im{i}.png", clean)
        _save(f"{tmp_path}/deg/im{i}.png", _degrade(rng, clean))
    for i in range(2):
        base = np.kron(rng.integers(0, 255, (24, 24, 3)), np.ones((8, 8, 1)))
        _save(f"{tmp_path}/pristine/p{i}.png",
              np.clip(base + rng.normal(0, 10, base.shape), 0, 255).astype(np.uint8))

    def run(main, tag, extra):
        main(["--ckpt", jax_ckpt, "--degset", f"{tmp_path}/deg", "--tarset",
              f"{tmp_path}/tar", "--save", f"{tmp_path}/{tag}/out/", "--savetar",
              f"{tmp_path}/{tag}/tar/", "--saveres", f"{tmp_path}/{tag}/res/", "--lpips",
              "--niqe-model", f"fit:{tmp_path}/pristine"] + extra)
        return capsys.readouterr().out

    got, want = run(t_test.main, "t", ["--device", "cpu"]), run(j_test.main, "j", [])
    for out in (got, want):
        assert f"surrogate model fit on 2 images from {tmp_path}/pristine" in out
        assert "niqe skip im1.png: image 64x72 smaller than one 96px NIQE patch" in out

    def avg(text, metric):
        return float(re.search(rf"^{metric}: average (\S+)", text, re.M).group(1))
    assert abs(avg(got, "PSNR") - avg(want, "PSNR")) <= 1e-3 + 5e-6
    assert abs(avg(got, "SSIM") - avg(want, "SSIM")) <= 1e-4 + 5e-6
    assert abs(avg(got, "LPIPS") - avg(want, "LPIPS")) <= 1e-5 + 5e-6
    assert "(1 images)" in got and "(1 images)" in want
    n_got, n_want = avg(got, "NIQE"), avg(want, "NIQE")
    # printed to 5 decimals: equal there (the images differ by fp32 rounding)
    assert np.isfinite(n_got) and abs(n_got - n_want) <= 1e-5


# bf16 serves in every composition, attention core and depthwise tier: the
# first case, once refused, now passes
@pytest.mark.parametrize("flags,what", [
    (["--dtype", "bfloat16", "--depthwise", "dwconv"], "bf16"),
    (["--backbone", "mprnet"], "MPRNet"),
    (["--sr-scale", "2"], "SR mode"), (["--spatial", "2"], "row sharding")])
def test_cli_test_refuses_unported_flags_by_name(flags, what):
    argv = ["--ckpt", "missing.npz", "--degset", "a/", "--tarset", "b/"] + flags
    if what == "bf16":
        t_test.refuse_unported(t_test.build_parser().parse_args(argv))  # does not raise
        return
    with pytest.raises(SystemExit, match=rf"{flags[0]}.*{what}.*not ported"):
        t_test.main(argv)


@pytest.mark.parametrize("flags", [[], ["--dtype", "float32"], ["--backbone", "auto"],
                                   ["--backbone", "restormer"], ["--sr-scale", "0"],
                                   ["--spatial", "1"], ["--dtype", "bfloat16"],
                                   ["--dtype", "bfloat16", "--composition", "off"]])
def test_cli_test_takes_the_ported_values(flags):
    args = t_test.build_parser().parse_args(
        ["--ckpt", "x.npz", "--degset", "a/", "--tarset", "b/"] + flags)
    t_test.refuse_unported(args)  # does not raise


def test_eval_all_refuses_bf16_by_name():
    """bf16 with the fused MDTA attend has its bf16 form now: cli.eval_all's
    flags pass in bf16 with --attention-core mdta, as in fp32."""
    t_test.refuse_unported(t_eval.build_parser().parse_args(
        ["--ckpt", "x.npz", "--dtype", "bfloat16", "--attention-core", "mdta"]))
    args = t_eval.build_parser().parse_args(["--ckpt", "x.npz", "--sigmas", "15", "50",
                                             "--paired", "a", "b/", "--dtype", "float32"])
    assert args.sigmas == [15, 50] and args.paired == [["a", "b/"]]
    assert (args.device, args.composition, args.attention_core, args.depthwise) == (
        "cuda", "full", "gram", "fused")
    t_test.refuse_unported(args)


def test_cli_train_refuses_bf16_training_by_name():
    """bf16 serves and trains in every composition
    (tests/test_torch_bf16_train.py) and, since rows 10-11 have bf16 forms,
    in the opt-in tiers: no flag of them is refused."""
    from rcot_torch.cli import train as t_train
    t_train._refuse_unported(t_train.build_parser().parse_args(
        ["--dtype", "bfloat16", "--depthwise", "dwconv", "--attention-core", "mdta"]))
    for composition in ("full", "head", "tail", "off", "auto"):
        t_train._refuse_unported(t_train.build_parser().parse_args(
            ["--dtype", "bfloat16", "--composition", composition]))  # does not raise


@pytest.mark.parametrize("composition", ["head", "tail", "off"])
def test_bf16_serves_in_every_composition_through_the_clis(tmp_path, jax_ckpt, composition,
                                                           capsys):
    """cli.eval_all and cli.test --dtype bfloat16 --composition head, tail or
    off on the CPU: the rows and per-image PSNR of "full" in bf16 (the four
    compositions round to bf16 at the same points; the JAX package's bf16
    forwards in each are held in tests/test_torch_bf16_head_gdfn.py)."""
    root = write_eval_tree(str(tmp_path / "tree"))
    rows = []
    for extra in ([], ["--composition", composition]):
        out = str(tmp_path / f"{len(rows)}.json")
        assert t_eval.main(["--ckpt", jax_ckpt, "--paired", "val", f"{root}/paired",
                            "--json-out", out, "--device", "cpu", "--dtype", "bfloat16"]
                           + extra) == 0
        rows.append(json.load(open(out))["results"]["val"])
    a, b = rows
    assert a["n"] == b["n"] == 2 and abs(a["psnr"] - b["psnr"]) <= 1e-3 + 5e-5
    assert abs(a["ssim"] - b["ssim"]) <= 1e-4 + 5e-6
    capsys.readouterr()
    psnrs = []
    for extra in ([], ["--composition", composition]):
        t_test.main(["--ckpt", jax_ckpt, "--degset", f"{root}/paired/input/", "--tarset",
                     f"{root}/paired/target/", "--device", "cpu", "--dtype", "bfloat16"]
                    + extra)
        psnrs.append(dict(re.findall(r"^(\S+\.png): psnr ([\d.]+)", capsys.readouterr().out,
                                     re.M)))
    assert psnrs[0] and psnrs[0].keys() == psnrs[1].keys()
    for k in psnrs[0]:
        assert abs(float(psnrs[0][k]) - float(psnrs[1][k])) <= 1e-3, k
