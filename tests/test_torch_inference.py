"""The port's Restorer and test CLI against the JAX package's, on the CPU,
with the tiny T_net and the same weights.

Tolerances: restored images at atol 1e-4 (as the T_net parity in
test_torch_model.py); per-image PSNR to 1e-3 dB and SSIM to 1e-4.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rcot_torch.cli.test import main as torch_test_main
from rcot_torch.compat.jax_params import tnet_state_dict_from_jax
from rcot_torch.models import inference as tinf
from rcot_torch.utils.config import ModelConfig as TModelConfig
from rcot_tpu.metrics.quality import psnr as j_psnr
from rcot_tpu.metrics.quality import ssim_ref_single as j_ssim
from rcot_tpu.models import inference as jinf
from rcot_tpu.models.restormer import init_tnet

BUCKETS = (32, 64)  # small buckets keep the JAX side to a few compiles


@pytest.fixture(scope="module")
def restorers(tiny_model_cfg):
    import dataclasses
    params = init_tnet(jax.random.PRNGKey(0), tiny_model_cfg)
    sd = tnet_state_dict_from_jax(params, tiny_model_cfg)
    tcfg = TModelConfig(**dataclasses.asdict(tiny_model_cfg))

    def pair(**kw):
        j = jinf.make_restorer(params, tiny_model_cfg, **kw)
        t = tinf.make_restorer(sd, tcfg, device="cpu", **kw)
        j.buckets = t.buckets = BUCKETS
        return j, t
    return pair


def _imgs(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, s + (3,)).astype(np.float32) for s in shapes]


def test_whole_image_mod8_violating(restorers):
    j, t = restorers()
    (img,) = _imgs((27, 30))
    got, want = t(img), j(img)
    assert got.shape == img.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_restore_batch_mixed_buckets(restorers):
    j, t = restorers()
    imgs = _imgs((20, 28), (24, 17), (40, 30), seed=1)  # buckets 32x32 twice, 64x32
    got, want = t.restore_batch(imgs), j.restore_batch(imgs)
    for g, w, im in zip(got, want, imgs):
        assert g.shape == im.shape
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


def test_tiled_with_overlap(restorers):
    j, t = restorers(tile=32, tile_overlap=8)
    (img,) = _imgs((72, 56), seed=2)
    got, want = t(img), j(img)
    assert got.shape == img.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # restore_batch routes an image larger than the tile through the tiles
    np.testing.assert_allclose(t.restore_batch([img])[0], got, atol=0, rtol=0)


def test_reflect_pad_chunks_and_edge_fallback():
    x = torch.arange(2 * 3 * 1 * 2, dtype=torch.float32).reshape(2, 3, 1, 2)
    y = tinf._reflect_pad_hw(x, 7, 5)  # pad > size, and a size-1 axis
    want = jinf._reflect_pad_hw(x.numpy(), 7, 5)
    np.testing.assert_array_equal(y.numpy(), np.asarray(want))
    for base in (8, 16):
        got, hw = tinf.pad_to_multiple(torch.from_numpy(np.ascontiguousarray(x.numpy()[:, :, :1])), base)
        want, jhw = jinf.pad_to_multiple(x.numpy()[:, :, :1], base)
        assert hw == jhw == (3, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tinf.bucket_size(130, 8, (128, 256)) == 256
    assert tinf.bucket_size(300, 8, (128, 256)) == 304


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("the check is for a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        tinf.Restorer(lambda x: x)


def test_cli_matches_jax_restorer(tiny_config, tmp_path, capsys):
    """A trainer checkpoint written by the JAX package, restored by the
    port's CLI: per-image PSNR equals the JAX Restorer's to 1e-3 dB."""
    from rcot_tpu.train.steps import create_train_state
    from rcot_tpu.utils.checkpoint import save_checkpoint

    state = create_train_state(jax.random.PRNGKey(0), tiny_config)
    ckpt = save_checkpoint(str(tmp_path / "m_step0"), state,
                           metadata={"config": tiny_config.to_dict()})
    rng = np.random.default_rng(0)
    deg_dir, tar_dir = tmp_path / "deg", tmp_path / "tar"
    os.makedirs(deg_dir)
    os.makedirs(tar_dir)
    for i, (h, w) in enumerate([(40, 44), (40, 44), (52, 36)]):
        tar = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        deg = np.clip(tar.astype(int) + rng.integers(-40, 40, tar.shape),
                      0, 255).astype(np.uint8)
        Image.fromarray(deg).save(deg_dir / f"im{i}.png")
        Image.fromarray(tar).save(tar_dir / f"im{i}.png")

    out_dir = tmp_path / "out"
    torch_test_main(["--ckpt", ckpt, "--degset", str(deg_dir), "--tarset", str(tar_dir),
                     "--save", str(out_dir) + "/", "--savetar", str(tmp_path / "st") + "/",
                     "--saveres", str(tmp_path / "sr") + "/", "--batch", "2",
                     "--device", "cpu"])
    got = capsys.readouterr().out
    assert "PSNR: average" in got and "SSIM: average" in got
    assert sorted(os.listdir(out_dir)) == ["im0.png", "im1.png", "im2.png"]
    lines = dict((m[0], (float(m[1]), float(m[2]))) for m in
                 re.findall(r"^(im\d\.png): psnr ([\d.]+) ssim ([\d.]+)$", got, re.M))
    assert len(lines) == 3

    jr = jinf.make_restorer(state.t_params, tiny_config.model)
    for i in range(3):
        deg = np.asarray(Image.open(deg_dir / f"im{i}.png"), np.float32) / 255.0
        tar = np.asarray(Image.open(tar_dir / f"im{i}.png"), np.float32) / 255.0
        out = jr(deg)
        p = float(j_psnr(out, tar, 1.0))
        s = float(j_ssim(out * 255.0, tar * 255.0))
        got_p, got_s = lines[f"im{i}.png"]
        assert abs(got_p - p) < 1e-3 + 5e-5  # printed to 4 decimals
        assert abs(got_s - s) < 1e-4 + 5e-5


def test_cli_reads_a_port_state_dict(tmp_path):
    from rcot_torch.cli.test import load_state_dict
    from rcot_torch.models.restormer import TNet

    net = TNet(TModelConfig(), device="cpu", seed=3)
    torch.save(net.state_dict(), tmp_path / "tnet.pt")
    sd, cfg = load_state_dict(str(tmp_path / "tnet.pt"))
    assert cfg == TModelConfig()
    assert sd.keys() == net.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in net.state_dict().items())



def test_cli_refuses_a_reference_pth_by_name(tmp_path):
    """A reference checkpoint is a pickle of the reference's modules, which
    this repo does not have: the CLI stops by name before unpickling it."""
    import pickle

    from rcot_torch.cli.test import load_state_dict

    path = tmp_path / "model_derain.pth"
    path.write_bytes(pickle.dumps({"epoch": 3, "Tnet": {"w": np.zeros(2)}}))
    with pytest.raises(SystemExit, match=r"reference \.pth .*Queue 1 item 3"):
        load_state_dict(str(path))
