"""The port's image-quality metrics against the JAX package's, on the CPU.

Tolerances: psnr_peak_max, ssim_skimage_single and compute_psnr_ssim within
1e-5 absolute (fp32 filters in another order); NIQE features, fit and score
and the Frechet distance within 1e-9 relative (numpy on both sides, the
same arithmetic); the files (NIQE models, FID stats) cross-read exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from rcot_torch.data import imresize as t_imresize
from rcot_torch.metrics import frechet as tfr
from rcot_torch.metrics import niqe as tniqe
from rcot_torch.metrics import quality as tq
from rcot_tpu.data import imresize as j_imresize
from rcot_tpu.metrics import frechet as jfr
from rcot_tpu.metrics import niqe as jniqe
from rcot_tpu.metrics import quality as jq

ATOL = 1e-5
REL = 1e-9


def _pair(shape, seed=0, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape,shave", [((24, 20, 3), 0), ((24, 20, 3), 4),
                                         ((2, 16, 18, 3), 3), ((17, 13), 2)])
def test_psnr_peak_max_matches_jax(shape, shave):
    a, b = _pair(shape, seed=len(shape) + shave)
    got = float(tq.psnr_peak_max(torch.from_numpy(a), torch.from_numpy(b), shave))
    want = float(jq.psnr_peak_max(jnp.asarray(a), jnp.asarray(b), shave))
    assert abs(got - want) <= ATOL


def test_psnr_peak_max_caps_identical_images():
    a, _ = _pair((2, 12, 12, 3))
    for fn, arr in ((tq.psnr_peak_max, torch.from_numpy), (jq.psnr_peak_max, jnp.asarray)):
        assert float(fn(arr(a), arr(a), 2)) == 100.0


@pytest.mark.parametrize("shape,data_range", [((20, 23, 3), 1.0), ((16, 16), 1.0),
                                              ((12, 30, 3), 255.0)])
def test_ssim_skimage_matches_jax(shape, data_range):
    a, b = _pair(shape, seed=shape[1])
    a, b = a * data_range, b * data_range
    got = float(tq.ssim_skimage_single(torch.from_numpy(a), torch.from_numpy(b), data_range))
    want = float(jq.ssim_skimage_single(jnp.asarray(a), jnp.asarray(b), data_range))
    assert abs(got - want) <= ATOL


def test_compute_psnr_ssim_matches_jax():
    a, b = _pair((3, 20, 22, 3), seed=5)
    p, s, n = tq.compute_psnr_ssim(torch.from_numpy(a), torch.from_numpy(b))
    jp, js, jn = jq.compute_psnr_ssim(jnp.asarray(a), jnp.asarray(b))
    assert n == jn == 3
    assert abs(float(p) - float(jp)) <= ATOL and abs(float(s) - float(js)) <= ATOL


def test_timer_and_meter():
    t = tq.Timer()
    t.tic()
    t.hold()
    t.hold()
    assert t.acc >= 0.0 and t.release() >= 0.0 and t.acc == 0.0
    assert t.toc(restart=True) >= 0.0
    m = tq.AverageMeter()
    assert np.isnan(m.avg)
    m.update(2.0, 3)
    m.update(4.0)
    assert m.avg == pytest.approx(2.5)


# ------------------------------------------------------------ NIQE

def _images(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        base = rng.uniform(0, 255, (h // 8, w // 8, 3))
        img = np.kron(base, np.ones((8, 8, 1)))[:h, :w]  # blocky: sharp edges
        out.append(np.clip(img + rng.normal(0, 12, img.shape), 0, 255))
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("scale", [0.5, 0.37, 1.7])
def test_imresize_copy_matches_jax(scale):
    img = _images(1, 40, 36, seed=3)[0]
    for im in (img, img[..., 0] / 255.0):
        np.testing.assert_array_equal(t_imresize.imresize(im, scale),
                                      j_imresize.imresize(im, scale))


@pytest.mark.parametrize("threshold", [None, 0.75])
def test_niqe_features_match_jax(threshold):
    (img,) = _images(1, 200, 296, seed=1)
    got = tniqe.niqe_features(img, 96, threshold)
    want = jniqe.niqe_features(img, 96, threshold)
    assert got.shape == want.shape and got.shape[1] == 36
    assert _rel(got, want) <= REL


def test_niqe_fit_and_score_match_jax(tmp_path):
    clean = _images(3, 192, 192, seed=2)
    t_model, j_model = tniqe.fit_niqe_model(clean), jniqe.fit_niqe_model(clean)
    assert _rel(t_model["mu"], j_model["mu"]) <= REL
    assert _rel(t_model["cov"], j_model["cov"]) <= REL
    noisy = [np.clip(im + np.random.default_rng(9).normal(0, 30, im.shape), 0, 255)
             for im in _images(2, 200, 200, seed=4)]
    for im in noisy + [clean[0] / 255.0]:
        got, want = tniqe.niqe(im, t_model), jniqe.niqe(im, j_model)
        assert np.isfinite(got) and abs(got - want) <= REL * abs(want)
    # the model files are one format: each package reads the other's
    tniqe.save_niqe_model(str(tmp_path / "t.npz"), t_model)
    jniqe.save_niqe_model(str(tmp_path / "j.npz"), j_model)
    for read in (tniqe.load_niqe_model, jniqe.load_niqe_model):
        for name in ("t.npz", "j.npz"):
            m = read(str(tmp_path / name))
            assert _rel(m["mu"], t_model["mu"]) <= REL and m["patch_size"] == 96


@pytest.mark.parametrize("keys", [("pop_mu", "pop_cov"), ("mu_prisparam", "cov_prisparam")])
def test_niqe_mat_layouts_and_facade(tmp_path, monkeypatch, keys):
    model = jniqe.fit_niqe_model(_images(2, 192, 192, seed=6))
    path = str(tmp_path / "params.mat")
    sio.savemat(path, {keys[0]: model["mu"][None, :], keys[1]: model["cov"]})
    got, want = tniqe.load_niqe_model(path), jniqe.load_niqe_model(path)
    np.testing.assert_array_equal(got["mu"], want["mu"])
    np.testing.assert_array_equal(got["cov"], want["cov"])
    (img,) = _images(1, 192, 192, seed=7)
    monkeypatch.setenv("RCOT_NIQE_MODEL", path)
    t_score, j_score = tq.niqe(img), jq.niqe(img)
    assert abs(t_score - j_score) <= REL * abs(j_score)
    assert tq.niqe(img, model_path=path) == t_score  # the cached model
    monkeypatch.delenv("RCOT_NIQE_MODEL")
    with pytest.raises(ValueError, match="pristine model"):
        tq.niqe(img)


def test_niqe_refuses_small_images_and_fit_skips_them():
    small = np.zeros((90, 200, 3))
    with pytest.raises(ValueError, match="smaller than one 96px"):
        tniqe.niqe_features(small)
    with pytest.warns(UserWarning, match="skipping"):
        model = tniqe.fit_niqe_model([small] + _images(1, 192, 192, seed=8))
    assert model["mu"].shape == (36,)
    with pytest.raises(ValueError, match="no usable images"):
        tniqe.fit_niqe_model([])


# ------------------------------------------------------------ Frechet

def _stats(seed, n=40, d=16, shift=0.0):
    feats = np.random.default_rng(seed).normal(shift, 1.0, (n, d))
    return jfr.activation_statistics(feats), tfr.activation_statistics(feats)


@pytest.mark.parametrize("n,shift", [(40, 0.3), (8, 1.0)])  # n = 8 < d: singular
def test_frechet_distance_matches_jax(n, shift):
    (jm1, js1), (tm1, ts1) = _stats(0, n)
    (jm2, js2), (tm2, ts2) = _stats(1, n, shift=shift)
    assert _rel(tm1, jm1) == 0 and _rel(ts1, js1) == 0
    got = tfr.frechet_distance(tm1, ts1, tm2, ts2)
    want = jfr.frechet_distance(jm1, js1, jm2, js2)
    assert got > 0 and abs(got - want) <= REL * abs(want)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfr.frechet_distance(tm1, ts1, tm2[:-1], ts2)


def test_stats_files_cross_read(tmp_path):
    (mu, sigma), _ = _stats(2)
    tfr.save_stats(str(tmp_path / "t.npz"), mu, sigma)
    jfr.save_stats(str(tmp_path / "j.npz"), mu, sigma)
    for load in (tfr.load_stats, jfr.load_stats):
        for name in ("t.npz", "j.npz"):
            m, s = load(str(tmp_path / name))
            np.testing.assert_array_equal(m, mu)
            np.testing.assert_array_equal(s, sigma)
