"""The library functions that no main path calls, against the JAX package's:
the LR schedules, gan_loss, tv_loss and edge_map, within 1e-6; and the
helpers collapse_de_id, pil_to_np, np_to_pil, prepare_gt_img and crop_back,
each on the JAX test's case (tests/test_data.py, test_extras.py,
test_inference.py) and equal to the JAX function's output."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcot_torch.ops.edges import edge_map as t_edge_map
from rcot_torch.train import losses as tlosses
from rcot_torch.train import schedulers as tsched
from rcot_tpu.ops.edges import edge_map as j_edge_map
from rcot_tpu.train import losses as jlosses
from rcot_tpu.train import schedulers as jsched

TOL = 1e-6

SCHEDULES = [
    ("multistep_restart", dict(milestones=[4, 9, 2], gamma=0.5, restarts=[0, 7],
                               restart_weights=[1.0, 0.3])),
    ("linear", dict(total_iter=13)),
    ("vibrate", dict(total_iter=400)),
    ("cosine_annealing_restart", dict(periods=[5, 8], restart_weights=[1.0, 0.5],
                                      eta_min=0.01, base_lr=2.0)),
    ("cosine_annealing_restart_cyclic", dict(periods=[5, 8], restart_weights=[1.0, 0.5],
                                             eta_mins=[0.1, 0.02], base_lr=2.0)),
    ("linear_warmup_cosine", dict(warmup_epochs=3, max_epochs=12, warmup_start_lr=0.1,
                                  eta_min=0.05, base_lr=1.5)),
    ("linear_warmup_cosine", dict(warmup_epochs=0, max_epochs=5)),
    ("linear_warmup_decay", dict(warmup_steps=3, total_steps=10)),
    ("linear_warmup_decay", dict(warmup_steps=3, total_steps=10, linear_end=True)),
    ("linear_warmup_decay", dict(warmup_steps=2, total_steps=10, cosine=False)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[f"{n}-{i}" for i, (n, _) in
                                                    enumerate(SCHEDULES)])
def test_schedule_matches_jax(name, kw):
    got, want = getattr(tsched, name)(**kw), getattr(jsched, name)(**kw)
    for step in (0, 1, 2, 3, 5, 7, 8, 12, 13, 20, 30, 399):
        assert abs(got(step) - want(step)) <= TOL, (name, step)


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "wgan"])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("shape", [(3,), (2, 5), (2, 4, 4, 1)])
def test_gan_loss_matches_jax(mode, real, shape):
    s = np.random.default_rng(len(shape)).normal(0, 3, shape).astype(np.float32)
    got = float(tlosses.gan_loss(torch.from_numpy(s), real, mode))
    want = float(jlosses.gan_loss(jnp.asarray(s), real, mode))
    assert abs(got - want) <= TOL * max(1.0, abs(want))


def test_gan_loss_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown gan loss"):
        tlosses.gan_loss(torch.zeros(2), True, "hinge")


@pytest.mark.parametrize("shape,weight", [((1, 5, 7, 3), 1.0), ((2, 8, 6, 4), 0.25),
                                          ((3, 2, 9, 1), 3.0)])
def test_tv_loss_matches_jax(shape, weight):
    x = np.random.default_rng(shape[0]).uniform(0, 1, shape).astype(np.float32)
    got = float(tlosses.tv_loss(torch.from_numpy(x), weight))
    want = float(jlosses.tv_loss(jnp.asarray(x), weight))
    assert abs(got - want) <= TOL * max(1.0, abs(want))


@pytest.mark.parametrize("shape", [(6, 7, 3), (2, 5, 4, 3), (2, 1, 4, 6, 2)])
def test_edge_map_matches_jax(shape):
    x = np.random.default_rng(len(shape)).uniform(0, 1, shape).astype(np.float32)
    got = t_edge_map(torch.from_numpy(x)).numpy()
    want = np.asarray(j_edge_map(jnp.asarray(x)))
    assert got.shape == want.shape == shape[:-1] + (1,)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_collapse_de_id_mapping():
    """noise_combine label collapse: every denoise id -> 0, the paired ids
    shift down by 2 (tests/test_data.py TestNoiseCombine)."""
    from rcot_torch.data.datasets import collapse_de_id
    from rcot_tpu.data.datasets import collapse_de_id as j_collapse
    assert [int(collapse_de_id(i)) for i in range(7)] == [0, 0, 0, 1, 2, 3, 4]
    arr = collapse_de_id(np.array([0, 1, 2, 3, 4, 5, 6]))
    assert arr.tolist() == [0, 0, 0, 1, 2, 3, 4] == j_collapse(np.arange(7)).tolist()


def test_pil_np_roundtrip():
    """tests/test_extras.py's round trip: 1/255 levels, half a level at
    most; one channel squeezes to mode "L"; both packages' bytes equal."""
    from PIL import Image

    from rcot_torch.utils.image_io import np_to_pil, pil_to_np
    from rcot_tpu.utils.image_io import np_to_pil as j_np_to_pil
    from rcot_tpu.utils.image_io import pil_to_np as j_pil_to_np
    arr = np.random.default_rng(0).uniform(size=(17, 23, 3)).astype(np.float32)
    back = pil_to_np(np_to_pil(arr))
    assert back.shape == (17, 23, 3) and back.dtype == np.float32
    assert np.abs(back - arr).max() <= (0.5 / 255.0) + 1e-6
    assert np.array_equal(back, j_pil_to_np(j_np_to_pil(arr)))
    gray = np_to_pil(arr[..., :1])
    assert isinstance(gray, Image.Image) and gray.mode == "L"
    assert np.array_equal(np.asarray(gray), np.asarray(j_np_to_pil(arr[..., :1])))


@pytest.mark.parametrize("d", [10, 0])
def test_prepare_gt_img_sots_crop(d):
    from rcot_torch.utils.image_io import prepare_gt_img
    from rcot_tpu.utils.image_io import prepare_gt_img as j_prepare
    img = np.random.default_rng(1).uniform(size=(64, 48, 3)).astype(np.float32)
    out = prepare_gt_img(img, d=d)
    assert out.shape == ((44, 28, 3) if d else (64, 48, 3))
    assert np.array_equal(out, j_prepare(img, d=d))


def test_crop_back_undoes_pad_to_multiple():
    """tests/test_inference.py's case: (1, 100, 92, 3) padded to (104, 96)
    and cropped back, the JAX package's crop on the same array."""
    from rcot_torch.models.inference import crop_back, pad_to_multiple
    from rcot_tpu.models.inference import crop_back as j_crop_back
    x = torch.from_numpy(np.random.default_rng(2).uniform(size=(1, 100, 92, 3))
                         .astype(np.float32))
    padded, hw = pad_to_multiple(x, 8)
    assert padded.shape == (1, 104, 96, 3) and hw == (100, 92)
    got = crop_back(padded, hw)
    assert got.shape == (1, 100, 92, 3) and torch.equal(got, x)
    assert np.array_equal(got.numpy(), np.asarray(j_crop_back(jnp.asarray(padded.numpy()), hw)))
