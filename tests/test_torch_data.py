"""The port's data path (rcot_torch/data/) against the JAX package's, on the
CPU: dihedral augmentation, the device-side augment and noise, the training
index and the loader's batches.

Every comparison is exact: the loaders make the same uint8 patches from the
same random.Random draws, and augment_and_degrade, handed the JAX draws
(modes from jax.random.randint, noise from jax.random.normal, split as the
JAX function splits its key), computes the same fp32 values, the uint8
floor included.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcot_torch.data import datasets as tdata
from rcot_torch.data import degradations as tdeg
from rcot_torch.data.pipeline import TrainLoader, device_prefetch
from rcot_torch.data.synthetic import write_synthetic_tree
from rcot_torch.utils.config import config_from_dict
from rcot_tpu.data import datasets as jdata
from rcot_tpu.data import degradations as jdeg
from rcot_tpu.data.pipeline import TrainLoader as JTrainLoader
from rcot_tpu.utils.config import Config, DataConfig, TrainConfig


@pytest.mark.parametrize("mode", range(8))
def test_dihedral_matches_jax(mode):
    x = np.random.default_rng(mode).integers(0, 256, (12, 12, 3), dtype=np.uint8)
    want = np.asarray(jdeg.dihedral(jnp.asarray(x), mode))
    np.testing.assert_array_equal(tdeg.dihedral(torch.from_numpy(x), mode).numpy(), want)
    modes = torch.full((1,), mode)
    np.testing.assert_array_equal(
        tdeg.dihedral_batch(torch.from_numpy(x)[None], modes)[0].numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_and_degrade_with_jax_draws(seed):
    rng = np.random.default_rng(seed)
    clean = rng.integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    deg = clean.copy()
    deg[2:] = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    de_id = np.array([0, 2, 3, 4], np.int32)
    key = jax.random.PRNGKey(seed)
    want_deg, want_clean = jdeg.augment_and_degrade(key, jnp.asarray(clean), jnp.asarray(deg),
                                                    jnp.asarray(de_id))
    k_mode, k_noise = jax.random.split(key)
    modes = np.array(jax.random.randint(k_mode, (4,), 1, 8))
    noise = np.array(jax.random.normal(k_noise, clean.shape, jnp.float32))
    got_deg, got_clean = tdeg.augment_and_degrade(
        torch.from_numpy(clean), torch.from_numpy(deg), torch.from_numpy(de_id),
        modes=torch.from_numpy(modes), noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got_deg.numpy(), np.asarray(want_deg))
    np.testing.assert_array_equal(got_clean.numpy(), np.asarray(want_clean))
    # the uint8 floor: every noisy value is a whole number of 1/255 steps
    np.testing.assert_array_equal(np.round(got_deg.numpy() * 255) / 255, got_deg.numpy())


def test_augment_draws_from_the_generator_and_never_the_identity():
    clean = torch.arange(4 * 4 * 3, dtype=torch.uint8).reshape(1, 4, 4, 3).repeat(64, 1, 1, 1)
    de_id = torch.full((64,), 3, dtype=torch.int32)
    a = tdeg.augment_and_degrade(clean, clean, de_id, generator=torch.Generator().manual_seed(1))
    b = tdeg.augment_and_degrade(clean, clean, de_id, generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # paired ids keep degraded == clean, and no sample keeps its orientation
    assert torch.equal(a[0], a[1])
    assert not (a[1] == clean.float() / 255).flatten(1).all(1).any()


def _tree(root):
    write_synthetic_tree(str(root), seed=3, n_denoise=2, n_rain=2, n_haze=3, size=48,
                         val_sizes=())
    for kind, deg, clean in (("Deblur", "blur", "sharp"), ("Lowlight", "low", "high"),
                             ("Single", "degraded", "target")):
        for name in ("b.png", "a.png"):
            for sub in (deg, clean):
                img = np.random.default_rng(len(name)).integers(0, 256, (40, 52, 3), np.uint8)
                os.makedirs(root / "Train" / kind / sub, exist_ok=True)
                tdata.Image.fromarray(img).save(root / "Train" / kind / sub / name)


def _jax_cfg(root, de_type, patch=32, batch=3):
    return Config(
        data=DataConfig(de_type=de_type, data_file_dir=f"{root}/manifests/",
                        denoise_dir=f"{root}/Train/Denoise/", derain_dir=f"{root}/Train/Derain/",
                        dehaze_dir=f"{root}/Train/Dehaze/", deblur_dir=f"{root}/Train/Deblur/",
                        lowlight_dir=f"{root}/Train/Lowlight/", single_dir=f"{root}/Train/Single/",
                        patch_size=patch, num_workers=2,
                        oversample={"denoise": 2, "derain": 3, "deblur": 2, "lowlight": 2,
                                    "single": 2}),
        train=TrainConfig(batch_size=batch))


ALL_TYPES = ("denoise_15", "denoise_50", "derain", "dehaze", "deblur", "lowlight", "single")


def test_train_index_matches_jax(tmp_path):
    _tree(tmp_path)
    jcfg = _jax_cfg(tmp_path, ALL_TYPES)
    want = jdata.TrainIndex(jcfg.data, random.Random(7)).samples
    got = tdata.TrainIndex(config_from_dict(jcfg.to_dict()).data, random.Random(7)).samples
    assert [(s.degraded_path, s.clean_path, s.de_id) for s in got] == \
        [(s.degraded_path, s.clean_path, s.de_id) for s in want]
    assert {s.de_id for s in got} == {0, 2, 3, 4, 5, 6, 7}
    assert tdata.rain_gt_path("d/rainy/rain-12.png") == "d/gt/norain-12.png"
    assert tdata.haze_gt_path("d/synthetic/0001_0.8_0.2.jpg") == "d/original/0001.jpg"


@pytest.mark.parametrize("seed,epoch,start", [(0, 1, 0), (5, 2, 3), (1, 3, 1)])
def test_loader_batches_match_jax_bytewise(tmp_path, seed, epoch, start):
    _tree(tmp_path)
    jcfg = _jax_cfg(tmp_path, ALL_TYPES)
    jl = JTrainLoader(jcfg, seed=seed, process_index=0, process_count=1, use_native=False)
    tl = TrainLoader(config_from_dict(jcfg.to_dict()), seed=seed)
    assert tl.steps_per_epoch() == jl.steps_per_epoch()
    want = list(jl.epoch(epoch, start))
    got = list(tl.epoch(epoch, start))
    assert len(got) == len(want) == jl.steps_per_epoch() - start
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.degraded, w.degraded)
        np.testing.assert_array_equal(g.clean, w.clean)
        np.testing.assert_array_equal(g.de_id, w.de_id)
    on_cpu = list(device_prefetch(iter(got), size=2, device="cpu"))
    assert [b.degraded.dtype for b in on_cpu] == [torch.uint8] * len(got)
    assert all(np.array_equal(b.clean.numpy(), g.clean) for b, g in zip(on_cpu, got))


def test_too_small_image_names_the_file(tmp_path):
    _tree(tmp_path)
    jcfg = _jax_cfg(tmp_path, ("dehaze",), patch=64)
    loader = TrainLoader(config_from_dict(jcfg.to_dict()), seed=0)
    with pytest.raises(ValueError, match="haze.*smaller than patch_size=64"):
        next(iter(loader.epoch(1)))
