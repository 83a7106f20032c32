"""The port's checkpoints (rcot_torch/utils/checkpoint.py) on the CPU: a
round trip, keep-N pruning and latest.npz, the JAX package's format both
ways (a JAX trainer checkpoint resumes in the port, a port checkpoint loads
into the JAX TrainState), and the async writer's skip-if-busy.

Everything is exact: checkpoints move arrays, and the layout maps are
transposes.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcot_torch.compat.jax_params import fnet_state_dict_from_jax, tnet_state_dict_from_jax
from rcot_torch.train import steps as tsteps
from rcot_torch.utils import checkpoint as tckpt
from rcot_torch.utils.config import config_from_dict
from rcot_tpu.train import steps as jsteps
from rcot_tpu.utils import checkpoint as jckpt
from rcot_tpu.utils.config import TrainConfig


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


def _port_state(cfg, seed):
    return tsteps.create_train_state(config_from_dict(cfg.to_dict()), seed=seed, device="cpu")


def _stepped(cfg, seed):
    """A port state after one CPU iteration: every optimizer slot non-zero."""
    state = _port_state(cfg, seed)
    b, p = cfg.train.batch_size, cfg.critic.patch_size
    rng = np.random.default_rng(seed)
    imgs = [torch.from_numpy(rng.uniform(0, 1, (b, p, p, 3)).astype(np.float32))
            for _ in range(2)]
    batch = tsteps.Batch(*imgs, torch.tensor([0, 3][:b]))
    state, _ = tsteps.make_train_iteration(config_from_dict(cfg.to_dict()))(
        state, batch, torch.full((b, 1, 1, 1), 0.3), True, 1e-4)
    return state


def _slots(opt):
    return {n: {k: v.clone() for k, v in opt.state[p].items()}
            for n, p in zip(range(len(opt.state)), opt.param_groups[0]["params"])}


def _assert_same(a, b):
    for net_a, net_b in ((a.t_net, b.t_net), (a.f_net, b.f_net)):
        for (n, p), q in zip(net_a.named_parameters(), net_b.parameters()):
            assert torch.equal(p, q), n
    for opt_a, opt_b in ((a.t_opt, b.t_opt), (a.f_opt, b.f_opt)):
        sa, sb = _slots(opt_a), _slots(opt_b)
        assert sa.keys() == sb.keys()
        for i in sa:
            assert sa[i].keys() == sb[i].keys()
            for k in sa[i]:
                assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a.step == b.step


@pytest.mark.parametrize("optimizer", ["RMSprop", "Adam"])
def test_round_trip(tiny_config, tmp_path, optimizer):
    cfg = tiny_config.replace(train=TrainConfig(batch_size=2, optimizer=optimizer))
    state = _stepped(cfg, 1)
    path = tckpt.save_checkpoint(str(tmp_path / "run_step1"), tckpt.snapshot_state(state),
                                 metadata={"epoch": 2, "epoch_step": 5})
    assert path.endswith(".npz") and os.path.islink(tmp_path / "latest.npz")
    fresh = _port_state(cfg, 9)
    meta = tckpt.load_checkpoint(str(tmp_path / "latest.npz"), fresh)
    assert meta["epoch"] == 2 and meta["epoch_step"] == 5
    assert tckpt.read_metadata(path)["epoch_step"] == 5
    _assert_same(fresh, state)


def test_keep_n_prunes_numerically_and_latest_follows(tiny_config, tmp_path):
    state = _port_state(tiny_config, 0)
    snap = tckpt.snapshot_state(state)
    for step in (8, 9, 10, 11, 100):
        tckpt.save_checkpoint(str(tmp_path / f"run_step{step}"), snap, keep_n=3)
    assert sorted(os.listdir(tmp_path)) == ["latest.npz", "run_step10.npz",
                                            "run_step100.npz", "run_step11.npz"]
    assert os.readlink(tmp_path / "latest.npz") == "run_step100.npz"


def test_snapshot_is_a_copy(tiny_config):
    state = _port_state(tiny_config, 0)
    snap = tckpt.snapshot_state(state)
    with torch.no_grad():
        next(state.t_net.parameters()).add_(1.0)
    assert not torch.equal(snap["t_params/patch_embed/w"],
                           next(state.t_net.parameters()).permute(2, 3, 1, 0))


def _jax_state(cfg, seed):
    """A JAX TrainState with every leaf random (optimizer slots included)
    and non-zero counters."""
    state = jsteps.create_train_state(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)

    def fill(leaf):
        leaf = np.asarray(leaf)
        if leaf.dtype == np.int32:
            return jnp.asarray(np.int32(7))
        return jnp.asarray(rng.uniform(0.1, 1.0, leaf.shape).astype(np.float32))
    return jax.tree_util.tree_map(fill, state)


def test_jax_trainer_checkpoint_resumes_in_the_port(tiny_config, tmp_path):
    jstate = _jax_state(tiny_config, 3)
    path = jckpt.save_checkpoint(str(tmp_path / "jax_step7"), jstate,
                                 metadata={"epoch": 1, "epoch_step": 7})
    state = _port_state(tiny_config, 0)
    meta = tckpt.load_checkpoint(path, state)
    assert meta["epoch_step"] == 7 and state.step == 7
    for net, tree, to_sd, slots, cfg in (
            (state.t_net, jstate.t_params, tnet_state_dict_from_jax,
             jstate.t_opt.inner_state[0].square_avg, tiny_config.model),
            (state.f_net, jstate.f_params, fnet_state_dict_from_jax,
             jstate.f_opt.inner_state[0].square_avg, tiny_config.critic)):
        params, sq = to_sd(tree, cfg), to_sd(slots, cfg)
        opt = state.t_opt if net is state.t_net else state.f_opt
        for n, p in net.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), params[n], err_msg=n)
            np.testing.assert_array_equal(opt.state[p]["square_avg"].numpy(), sq[n], err_msg=n)
            assert float(opt.state[p]["step"]) == 7


def test_port_checkpoint_loads_into_the_jax_train_state(tiny_config, tmp_path):
    state = _stepped(tiny_config, 2)
    path = tckpt.save_checkpoint(str(tmp_path / "port_step1"), tckpt.snapshot_state(state),
                                 metadata={"epoch": 1, "epoch_step": 1,
                                           "config_hash": tiny_config.hash()})
    template = jax.eval_shape(lambda k: jsteps.create_train_state(k, tiny_config),
                              jax.random.PRNGKey(0))
    jstate, meta = jckpt.load_checkpoint(path, template)
    assert meta["config_hash"] == tiny_config.hash() and int(jstate.step) == 1
    assert int(jstate.t_opt.count) == 1 and int(jstate.f_opt.count) == 2
    for net, opt, tree, slots, to_sd, cfg in (
            (state.t_net, state.t_opt, jstate.t_params, jstate.t_opt.inner_state[0].square_avg,
             tnet_state_dict_from_jax, tiny_config.model),
            (state.f_net, state.f_opt, jstate.f_params, jstate.f_opt.inner_state[0].square_avg,
             fnet_state_dict_from_jax, tiny_config.critic)):
        params, sq = to_sd(tree, cfg), to_sd(slots, cfg)
        for n, p in net.named_parameters():
            np.testing.assert_array_equal(params[n], p.detach().numpy(), err_msg=n)
            np.testing.assert_array_equal(sq[n], opt.state[p]["square_avg"].numpy(), err_msg=n)


def test_async_checkpointer_skips_while_busy(tiny_config, tmp_path, monkeypatch):
    snap = tckpt.snapshot_state(_port_state(tiny_config, 0))
    release = threading.Event()
    real_save = tckpt.save_checkpoint

    def slow_save(*args, **kwargs):
        release.wait(30)
        return real_save(*args, **kwargs)
    monkeypatch.setattr(tckpt, "save_checkpoint", slow_save)
    ck = tckpt.AsyncCheckpointer()
    first = ck.save(str(tmp_path / "run_step1"), snap)
    assert first.endswith("run_step1.npz") and ck.busy
    assert ck.save(str(tmp_path / "run_step2"), snap, skip_if_busy=True) is None
    release.set()
    ck.wait()
    assert not ck.busy
    assert sorted(os.listdir(tmp_path)) == ["latest.npz", "run_step1.npz"]


def test_async_checkpointer_raises_the_writers_failure(tiny_config, tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise OSError("disk full")
    monkeypatch.setattr(tckpt, "save_checkpoint", broken)
    ck = tckpt.AsyncCheckpointer()
    ck.save(str(tmp_path / "run_step1"), {})
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
