"""The port's T_net (rcot_torch/models/restormer.py) and weight carry-across
(rcot_torch/compat/jax_params.py) against the JAX package, on the CPU.

- A tiny T_net with weights from the JAX init_tnet, carried across by
  tnet_state_dict_from_jax: (out2, out1, res) against apply_tnet at atol
  1e-4 (fp32, some forty ops deep; only the order of sums differs).
- The carry-across is the exact inverse of port_tnet_state_dict.
- Full width without JAX: the reference state_dict rebuilt from
  tests/goldens/tnet_full.npz by the synth_param rule loads with
  strict=True, holds 46,853,150 parameters, and gives the golden out2 at
  atol 2e-4, rtol 1e-3 (the tolerance of tests/test_golden_parity.py).
"""

import dataclasses
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcot_torch.compat.jax_params import load_jax_npz, tnet_state_dict_from_jax
from rcot_torch.models.restormer import TNet, count_params
from rcot_torch.utils.config import ModelConfig as TModelConfig
from rcot_tpu.compat.torch_port import port_tnet_state_dict
from rcot_tpu.models.restormer import apply_tnet, init_tnet
from rcot_tpu.utils.config import ModelConfig

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def synth_param(name: str, shape) -> np.ndarray:
    """Must stay in sync with tools/make_goldens.py."""
    seed = zlib.crc32(name.encode()) & 0xFFFFFFFF
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.02).astype(np.float32)


def rebuild_state_dict(z):
    names = [str(n) for n in z["names"]]
    shapes = [tuple(int(v) for v in s.split(",")) for s in z["shapes"]]
    return {n: synth_param(n, s) for n, s in zip(names, shapes)}


def _tcfg(cfg: ModelConfig) -> TModelConfig:
    return TModelConfig(**dataclasses.asdict(cfg))


def _port_tnet(params, cfg: ModelConfig) -> TNet:
    net = TNet(_tcfg(cfg), device="cpu", seed=None)
    sd = tnet_state_dict_from_jax(params, cfg)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return net.eval()


def _jax_params(cfg, seed=0):
    """init_tnet weights with every LayerNorm and temperature perturbed, so
    the parity also covers their scales and shifts."""
    p = init_tnet(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        leaf = np.asarray(leaf)
        if name.endswith("temperature") or "norm" in name:
            return (leaf + rng.normal(0, 0.1, leaf.shape)).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(perturb, p)


CFG_VARIANTS = {
    "WithBias": {},
    "BiasFree": {"layernorm_type": "BiasFree"},
    "conv_bias": {"bias": True},
}


@pytest.mark.parametrize("variant", list(CFG_VARIANTS))
def test_tiny_tnet_matches_apply_tnet(tiny_model_cfg, variant):
    cfg = dataclasses.replace(tiny_model_cfg, **CFG_VARIANTS[variant])
    params = _jax_params(cfg)
    x = np.random.default_rng(1).uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    want = apply_tnet(params, jnp.asarray(x), cfg)
    with torch.no_grad():
        got = _port_tnet(params, cfg)(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_tiny_tnet_single_pass(tiny_model_cfg):
    params = _jax_params(tiny_model_cfg, seed=3)
    x = np.random.default_rng(2).uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    want = apply_tnet(params, jnp.asarray(x), tiny_model_cfg, single_pass=True)
    with torch.no_grad():
        got = _port_tnet(params, tiny_model_cfg)(torch.from_numpy(x), single_pass=True)
    assert got[0] is got[1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


@pytest.mark.parametrize("parity", [False, True], ids=["tiny", "tiny_parity_params"])
def test_state_dict_roundtrip_is_exact(tiny_model_cfg, parity):
    cfg = dataclasses.replace(tiny_model_cfg, parity_params=parity)
    params = init_tnet(jax.random.PRNGKey(7), cfg)
    sd = tnet_state_dict_from_jax(params, cfg)
    back = port_tnet_state_dict(sd, cfg)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and the names are exactly the port module's own
    net = TNet(_tcfg(cfg), device="cpu", seed=None)
    assert set(sd) == set(net.state_dict())


def test_npz_reader_trainer_and_raw_checkpoints(tiny_config, tmp_path):
    """The key layout is confirmed by writing both kinds with the JAX
    package's own save_checkpoint."""
    from rcot_tpu.train.steps import create_train_state
    from rcot_tpu.utils.checkpoint import save_checkpoint

    state = create_train_state(jax.random.PRNGKey(0), tiny_config)
    trainer = save_checkpoint(str(tmp_path / "m_step0"), state,
                              metadata={"config": tiny_config.to_dict()})
    raw = save_checkpoint(str(tmp_path / "raw"), state.t_params,
                          metadata={"backbone": "restormer"})
    with np.load(trainer) as z:
        assert "t_params/encoder_level1/0/norm1/w" in z.files
    want = tnet_state_dict_from_jax(state.t_params, tiny_config.model)
    sd, cfg = load_jax_npz(trainer)
    assert cfg == _tcfg(tiny_config.model)
    assert set(sd) == set(want)
    for k in want:
        np.testing.assert_array_equal(sd[k], want[k])
    sd_raw, _ = load_jax_npz(raw, _tcfg(tiny_config.model))
    assert set(sd_raw) == set(want)
    for k in want:
        np.testing.assert_array_equal(sd_raw[k], want[k])


def test_full_width_golden_without_jax():
    path = os.path.join(GOLDENS, "tnet_full.npz")
    z = np.load(path)
    net = TNet(TModelConfig(), device="cpu", seed=None)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in rebuild_state_dict(z).items()},
                        strict=True)
    assert count_params(net) == 46_853_150
    x = torch.from_numpy(np.transpose(z["input"], (0, 2, 3, 1)).copy())
    with torch.no_grad():
        out2, _, _ = net.eval()(x)
    got = np.transpose(out2.numpy(), (0, 3, 1, 2))
    np.testing.assert_allclose(got, z["out2"], atol=2e-4, rtol=1e-3)


def test_seeded_init_is_deterministic():
    cfg = TModelConfig(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                       parity_params=False)
    a, b = TNet(cfg, device="cpu", seed=5), TNet(cfg, device="cpu", seed=5)
    for (na, pa), (_, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(pa, pb), na
    c = TNet(cfg, device="cpu", seed=6)
    assert not torch.equal(a.state_dict()["output.weight"], c.state_dict()["output.weight"])
