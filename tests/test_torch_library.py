"""The library functions that no main path calls, against the JAX package's:
the LR schedules, gan_loss, tv_loss and edge_map, within 1e-6."""

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
