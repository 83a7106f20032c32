"""Heads wider than 128 channels in the port's attention cores, against the
JAX package, on the CPU.

On the card the MDTA kernels (rows 3-4 and 6-7, csrc/gram.cu; row 10,
csrc/mdta.cu) take any head width by cutting a head into channel blocks of
at most 128; the JAX package's Pallas kernels slice any width. Here, on the
CPU, the port's autograd Functions (which take the plain twins) are held
against the JAX functions with their Pallas kernels in interpret mode at
head widths of 136 and 192 (one and two heads), forward and VJP:

- the Gram core, mdta_core_gram (rcot_tpu/ops/pallas_gram.py), on 8x8
  pixels;
- the fused attend, mdta_attend (rcot_tpu/ops/pallas_mdta.py
  mdta_attend_pallas), at N = 128;
- a one-pass T_net with one head a level at dim 24 (heads of 24, 48, 96 and
  192 channels), forward, under the JAX env of "off" with the Gram core and
  with the fused attend, both with the standalone depthwise kernel.

Tolerance: every output and gradient within 1e-4 * max(max|JAX|, 1), as
the parity tests use (fp32 on both sides, only the order of sums differs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcot_torch.compat.jax_params import tnet_state_dict_from_jax
from rcot_torch.models.restormer import TNet
from rcot_torch.ops import gram as tgram
from rcot_torch.ops import mdta as tmdta
from rcot_torch.utils.config import ModelConfig as TModelConfig
from rcot_tpu.models.restormer import apply_tnet, init_tnet
from rcot_tpu.ops import dispatch as jdispatch
from rcot_tpu.ops.pallas_gram import mdta_core_gram as j_core_gram
from rcot_tpu.ops.pallas_mdta import mdta_attend_pallas as j_mdta
from rcot_tpu.utils.config import ModelConfig

RTOL = 1e-4
WIDE = pytest.mark.parametrize("heads,ch", [(1, 136), (2, 136), (1, 192), (2, 192)])


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads, as tests/test_torch_trainer.py sets them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(name, got, want):
    want = np.asarray(want)
    assert np.shape(got) == want.shape, name
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, err_msg=name,
                               atol=RTOL * max(float(np.abs(want).max()), 1.0))


def _torch_vjp(fn, args, g):
    leaves = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    out = fn(*leaves)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


@WIDE
def test_mdta_core_gram_at_wide_heads_matches_pallas_vjp(heads, ch):
    rng = np.random.default_rng(60 + heads + ch)
    c = heads * ch
    qkv = rng.normal(size=(2, 8, 8, 3 * c)).astype(np.float32)
    temp = rng.uniform(0.5, 2.0, (heads, 1, 1)).astype(np.float32)
    g = rng.normal(size=(2, 8, 8, c)).astype(np.float32)
    want, vjp = jax.vjp(lambda t, q: j_core_gram(t, q, heads, interpret=True),
                        jnp.asarray(temp), jnp.asarray(qkv))
    want_temp, want_qkv = vjp(jnp.asarray(g))
    got, (got_temp, got_qkv) = _torch_vjp(
        lambda t, q: tgram.mdta_core_gram(t, q, heads), [temp, qkv], g)
    _close("out", got, want)
    _close("dqkv", got_qkv, want_qkv)
    _close("dtemperature", got_temp, want_temp)


@WIDE
def test_mdta_attend_at_wide_heads_matches_pallas_vjp(heads, ch):
    rng = np.random.default_rng(70 + heads + ch)
    q, k, v, g = (rng.normal(size=(2, heads, ch, 128)).astype(np.float32) for _ in range(4))
    temp = rng.uniform(0.5, 2.0, (heads, 1, 1)).astype(np.float32)
    args = [jnp.asarray(a) for a in (q, k, v, temp)]
    want, vjp = jax.vjp(lambda *a: j_mdta(*a, True), *args)
    got, grads = _torch_vjp(tmdta.mdta_attend, [q, k, v, temp], g)
    _close("out", got, want)
    for name, a, b in zip(("dq", "dk", "dv", "dtemperature"), grads, vjp(jnp.asarray(g))):
        _close(name, a, b)


# one pass (decoder=False), as tests/test_torch_mdta_dwconv.py's WIDE8: each
# block instance costs seconds of interpret-mode tracing
ONE_HEAD = ModelConfig(dim=24, heads=(1, 1, 1, 1), num_blocks=(1, 1, 1, 1),
                       num_refinement_blocks=1, parity_params=False, decoder=False)
JAX_ENVS = {
    "gram": {"RCOT_PALLAS_BLOCK": "0", "RCOT_PALLAS_FUSED": "0", "RCOT_PALLAS_DWCONV": "1"},
    "mdta": {"RCOT_PALLAS_BLOCK": "0", "RCOT_PALLAS_MDTA": "1", "RCOT_PALLAS_FUSED": "0",
             "RCOT_PALLAS_DWCONV": "1"},
}


@pytest.mark.parametrize("core", list(JAX_ENVS))
def test_tnet_with_one_head_a_level_matches_jax_pallas(monkeypatch, core):
    """The latent's head is 192 channels wide: forward, JAX's Pallas kernels
    in interpret mode against the port's off/<core>/dwconv on the CPU."""
    params = init_tnet(jax.random.PRNGKey(7), ONE_HEAD)
    x = np.random.default_rng(7).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    monkeypatch.setenv("RCOT_PALLAS", "1")
    monkeypatch.setenv("RCOT_PALLAS_INTERPRET", "1")
    for key, val in JAX_ENVS[core].items():
        monkeypatch.setenv(key, val)
    jdispatch.pallas_enabled.cache_clear()
    try:
        assert jdispatch.block_mode() == "off"
        want = jax.jit(lambda p, x: apply_tnet(p, x, ONE_HEAD))(params, jnp.asarray(x))
    finally:
        monkeypatch.undo()
        jdispatch.pallas_enabled.cache_clear()
    net = TNet(TModelConfig(**dataclasses.asdict(ONE_HEAD)), device="cpu", seed=None,
               composition="off", attention_core=core, depthwise="dwconv")
    sd = tnet_state_dict_from_jax(params, ONE_HEAD)
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for name, a, b in zip(("out2", "out1", "res"), got, want):
        _close(name, a.numpy(), b)
