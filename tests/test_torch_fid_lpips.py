"""The port's FID and LPIPS networks and the FID pipeline against the JAX
package's, on the CPU, on the JAX package's crc32-seeded surrogate weights.

Tolerances: the surrogates' weights equal element for element; Inception
pool3 at rtol 2e-3, atol 2e-4 (94 fp32 convolutions deep, the gate
tests/test_fid_torch_parity.py holds the JAX net to against an independent
PyTorch twin), at 2x64^2 (upscale to 299) and 1x320^2 (downscale: an
antialiased resize would miss it by ~0.5 a pixel); LPIPS at 64^2 within 1e-5
absolute; folder FID at rel 2e-2, abs 1e-3 (as the JAX pipeline is held to
an independent one) on six 64^2 images a folder.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rcot_torch.cli import fid as tfid
from rcot_torch.metrics import inception as tinc
from rcot_torch.metrics import lpips as tlp
from rcot_tpu.cli import fid as jfid
from rcot_tpu.metrics import inception as jinc
from rcot_tpu.metrics import lpips as jlp


@pytest.fixture(autouse=True)
def _quiet_and_two_threads():
    """No surrogate warnings; two intra-op threads, as under pytest-xdist
    several workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return dict(inc=tinc.InceptionV3(device="cpu"), lp=tlp.LPIPS(device="cpu"),
                    jinc=jinc.init_inception_params(None), jlp=jlp.init_lpips_params(None))


def test_inception_surrogate_equals_jax(nets):
    got = tinc.init_inception_params(None)
    assert [s[0] for s in tinc.conv_specs()] == [s[0] for s in jinc.conv_specs()]
    assert tinc.conv_specs() == jinc.conv_specs()
    assert got.keys() == nets["jinc"].keys()
    for name, p in nets["jinc"].items():
        w = np.transpose(np.asarray(p["w"]), (3, 2, 0, 1))
        np.testing.assert_array_equal(got[name]["w"].numpy(), w)
        np.testing.assert_array_equal(got[name]["b"].numpy(), np.asarray(p["b"]))
        conv = nets["inc"].convs[name.replace(".", "_")]
        np.testing.assert_array_equal(conv.weight.detach().numpy(), w)


def test_lpips_surrogate_equals_jax(nets):
    got = tlp.init_lpips_params(None)
    for name, *_ in tlp.ALEX_SPECS:
        want = nets["jlp"][name]
        np.testing.assert_array_equal(
            got[name]["w"].numpy(), np.transpose(np.asarray(want["w"]), (3, 2, 0, 1)))
        np.testing.assert_array_equal(got[name]["b"].numpy(), np.asarray(want["b"]))
    for i in range(len(tlp.LIN_CHANNELS)):
        np.testing.assert_array_equal(got[f"lin{i}"].numpy(), np.asarray(nets["jlp"][f"lin{i}"]))
        np.testing.assert_array_equal(getattr(nets["lp"], f"lin{i}").numpy(),
                                      np.asarray(nets["jlp"][f"lin{i}"]))


@pytest.mark.parametrize("shape,seed", [((2, 64, 64, 3), 0), ((1, 320, 320, 3), 1)],
                         ids=["upscale-2x64", "downscale-1x320"])
def test_inception_pool3_matches_jax(nets, shape, seed):
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jinc.inception_pool3(nets["jinc"], v))(jnp.asarray(x)))
    got = tinc.inception_pool3(nets["inc"], x).numpy()
    assert got.shape == want.shape == (shape[0], 2048)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_lpips_matches_jax(nets):
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    want = np.asarray(jlp.lpips(nets["jlp"], jnp.asarray(x), jnp.asarray(y)))
    got = tlp.lpips(nets["lp"], x, y).numpy()
    assert got.shape == (2,) and np.all(got > 0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert float(tlp.lpips(nets["lp"], x, x).abs().max()) == 0.0
    pair = tlp.lpips_pair(x[0], y[0], device="cpu")
    assert abs(pair - float(want[0])) <= 1e-5


def test_weight_files_load_as_in_jax(tmp_path, nets):
    """An .npz in the JAX layout (HWIO), as tools/port_*.py write it, loads
    into both packages' nets alike; a wrong shape is refused by name."""
    rng = np.random.default_rng(3)
    payload = {}
    for name, cin, cout, k, _s, _p in tlp.ALEX_SPECS:
        payload[f"{name}.w"] = rng.normal(0, 0.05, (k, k, cin, cout)).astype(np.float32)
        payload[f"{name}.b"] = rng.normal(0, 0.01, (cout,)).astype(np.float32)
    for i, c in enumerate(tlp.LIN_CHANNELS):
        payload[f"lin{i}.w"] = rng.uniform(0, 1, (c,)).astype(np.float32)
    path = str(tmp_path / "alex.npz")
    np.savez(path, **payload)
    net = tlp.LPIPS(path, device="cpu")
    jp = jlp.init_lpips_params(path)
    x = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    y = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(tlp.lpips(net, x, y).numpy(),
                               np.asarray(jlp.lpips(jp, jnp.asarray(x), jnp.asarray(y))),
                               atol=1e-5, rtol=0)
    payload["conv2.w"] = payload["conv2.w"][:, :, :, :8]
    np.savez(path, **payload)
    with pytest.raises(ValueError, match="conv2.w"):
        tlp.init_lpips_params(path)

    inc = {}
    for name, cin, cout, (kh, kw), _s, _p in tinc.conv_specs():
        inc[f"{name}.w"] = np.full((kh, kw, cin, cout), 0.01, np.float32)
        inc[f"{name}.b"] = np.arange(cout, dtype=np.float32)
    np.savez(str(tmp_path / "inc.npz"), **inc)
    got = tinc.init_inception_params(str(tmp_path / "inc.npz"))
    for name, p in jinc.init_inception_params(str(tmp_path / "inc.npz")).items():
        np.testing.assert_array_equal(got[name]["w"].numpy(),
                                      np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)))
        np.testing.assert_array_equal(got[name]["b"].numpy(), np.asarray(p["b"]))


def _write_folder(root, name, imgs):
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    for i, im in enumerate(imgs):
        Image.fromarray(np.clip(im * 255.0 + 0.5, 0, 255).astype(np.uint8)).save(
            os.path.join(d, f"{i:03d}.png"))
    return d


def test_preprocess_matches_jax(tmp_path):
    """torchvision's truncated long side and rounded crop offset, on
    portrait, landscape and already-square images."""
    rng = np.random.default_rng(4)
    for i, (h, w) in enumerate([(427, 640), (300, 257), (256, 256), (250, 300)]):
        path = str(tmp_path / f"{i}.png")
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(path)
        got = tfid._load_and_preprocess(path)
        assert got.shape == (256, 256, 3)
        np.testing.assert_array_equal(got, jfid._load_and_preprocess(path))


def test_fid_folders_match_jax(tmp_path, capsys):
    """cli.fid on a JAX-written stats .npz and a folder against the JAX
    package's compute_fid_folders on the two folders; the port's
    --save-stats against the JAX statistics. (Each FID is a sqrtm of a
    2048 x 2048 product, seconds on the CPU: two are taken.)"""
    from rcot_tpu.metrics import frechet as jfr

    rng = np.random.default_rng(1)
    base = rng.uniform(0.2, 0.8, (6, 64, 64, 3)).astype(np.float32)
    noisy = np.clip(base + rng.normal(0, 0.15, base.shape), 0, 1).astype(np.float32)
    d1 = _write_folder(str(tmp_path), "clean", base)
    d2 = _write_folder(str(tmp_path), "noisy", noisy)
    want = jfid.compute_fid_folders(d1, d2, batch_size=6)
    j_mu, j_sigma = jfr.activation_statistics(jfid.folder_activations(d1, batch_size=6))
    jfr.save_stats(str(tmp_path / "clean_jax.npz"), j_mu, j_sigma)

    t_stats = str(tmp_path / "clean_torch.npz")
    tfid.main([d1, t_stats, "--save-stats", "--device", "cpu", "--batch-size", "4"])
    t_mu, t_sigma = np.load(t_stats)["mu"], np.load(t_stats)["sigma"]
    np.testing.assert_allclose(t_mu, j_mu, rtol=2e-3, atol=2e-4)
    capsys.readouterr()
    tfid.main([str(tmp_path / "clean_jax.npz"), d2, "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("FID: ")
    got = float(line[5:])
    assert got > 0 and got == pytest.approx(want, rel=2e-2, abs=1e-3)
    with pytest.raises(ValueError, match="no images"):
        tfid.folder_activations(str(tmp_path), device="cpu")
