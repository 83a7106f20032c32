"""bf16 serving in the "head", "tail" and "off" block compositions, in the
port against the JAX package's, on the CPU: the whole two-pass tiny T_net
through make_restorer(dtype=torch.bfloat16) against the JAX package's
make_restorer(dtype=jnp.bfloat16) in the same composition
(RCOT_INFER_BLOCK), its Pallas kernels in interpret mode and XLA's excess
precision off (tests/test_torch_bf16.py says why), the GDFN's bf16
configuration (rows 8-9) among them in "head" and "off".

Gate, the quarter rule on the mean of tests/test_torch_bf16.py, which holds
"full": mean|port - JAX bf16| <= mean|JAX fp32 - JAX bf16| / 4, the fp32 side
JAX's plain path. The four compositions round to bf16 at the same points,
so each is held on the image on which "full" is held. The rule is
input-dependent: on another draw (seed 63) the port reads 0.33 of the gap
in every composition, "full" included (tools/bf16_serve_parity.py; ROADMAP
Queue 3). Tracing the Pallas
forwards in interpret mode takes most of this file's time.
"""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcot_torch.compat.jax_params import tnet_state_dict_from_jax
from rcot_torch.models import inference as tinf
from rcot_torch.utils.config import ModelConfig as TModelConfig
from rcot_tpu.models import inference as jinf
from rcot_tpu.models.restormer import init_tnet
from rcot_tpu.ops import dispatch as jdispatch

BF = jnp.bfloat16
STRICT = {"xla_allow_excess_precision": False}
PALLAS_ENV = {"RCOT_PALLAS": "1", "RCOT_PALLAS_INTERPRET": "1"}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _jax_env(env):
    """The JAX package's RCOT_* switches as env gives them, for one call."""
    keys = {**PALLAS_ENV, "RCOT_PALLAS_BLOCK": "", "RCOT_INFER_BLOCK": ""}
    saved = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(env)
    jdispatch.pallas_enabled.cache_clear()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jdispatch.pallas_enabled.cache_clear()


def _strict_restorer(r):
    """A JAX Restorer whose forwards compile with every bf16 rounding kept."""
    jitted, cache = r._jitted, {}

    def fwd(*args):
        key = tuple((a.shape, a.dtype) for a in jax.tree_util.tree_leaves(args))
        if key not in cache:
            cache[key] = jitted.lower(*args).compile(STRICT)
        return cache[key](*args)
    r._jitted = fwd
    return r


@pytest.mark.parametrize("composition", ["head", "tail", "off"])
def test_tiny_tnet_serves_bf16_in_every_composition_as_jax_pallas(tiny_model_cfg, composition):
    """The whole two-pass tiny T_net in bf16 through make_restorer, one 32^2
    bucket, in the composition given (the JAX package's RCOT_INFER_BLOCK,
    its Pallas kernels on): mean|port - JAX bf16| <= mean|JAX fp32 - JAX
    bf16| / 4 (docstring)."""
    params = init_tnet(jax.random.PRNGKey(0), tiny_model_cfg)
    sd = tnet_state_dict_from_jax(params, tiny_model_cfg)
    tcfg = TModelConfig(**dataclasses.asdict(tiny_model_cfg))
    # the image of tests/test_torch_bf16.py's "full" test (docstring)
    img = np.random.default_rng(14).uniform(0, 1, (32, 32, 3)).astype(np.float32)
    outs = {}
    for name, dtype, env in (
            ("bf16", BF, {**PALLAS_ENV, "RCOT_INFER_BLOCK": composition}),
            ("fp32", jnp.float32, {})):
        with _jax_env(env):
            r = _strict_restorer(jinf.make_restorer(params, tiny_model_cfg, dtype=dtype))
            r.buckets = (32,)
            outs[name] = np.asarray(r(img))
    port = tinf.make_restorer(sd, tcfg, device="cpu", dtype=torch.bfloat16,
                              composition=composition)
    port.buckets = (32,)
    got = port(img)
    assert got.dtype == np.float32 and got.shape == img.shape
    gap = float(np.abs(outs["fp32"] - outs["bf16"]).mean())
    err = float(np.abs(got - outs["bf16"]).mean())
    print(f"tiny T_net served in bf16 {composition}: mean|port - JAX| {err:.3e}, "
          f"mean|fp32 - bf16| {gap:.3e}")
    assert gap > 0 and err <= gap / 4, (err, gap)
