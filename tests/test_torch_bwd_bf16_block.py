"""One fp32 transformer block with every backward tier on bf16 operands
(the port's bwd_bf16="all", the JAX package's RCOT_BWD_BF16=all), in each
block composition, against the JAX package's transformer_block with its
Pallas kernels in interpret mode in that composition, on the CPU: the
block's forward and VJP with its parameters' gradients, sum|port - JAX| <=
BLOCK_RATIO * sum|JAX fp32 operands - JAX bf16 operands| over every
gradient together, the fp32-operand side JAX's plain path (Pallas off, the
same in every composition; its fp32 kernels agree with it far below that
gap, tests/test_torch_fused.py). One block has no chain of blocks for the
two sides' bf16 flips to grow through (tests/test_torch_bwd_bf16_tnet.py
says how they grow over the model): measured 0.00004 in each composition.
The kernels one by one are in tests/test_torch_bwd_bf16.py; a file of its
own, so that another worker takes it.
"""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcot_torch.compat import jax_params
from rcot_torch.models.restormer import TransformerBlock
from rcot_tpu.models.restormer import init_transformer_block, transformer_block
from rcot_tpu.ops import dispatch as jdispatch

BLOCK_RATIO = 1.0 / 16
PALLAS_ENV = {"RCOT_PALLAS": "1", "RCOT_PALLAS_INTERPRET": "1"}


def _np(a) -> np.ndarray:
    """A torch or JAX array as fp32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@contextlib.contextmanager
def _jax_env(extra):
    """The JAX package's switches for one trace: RCOT_PALLAS*, RCOT_BWD_BF16
    as given, every other one unset."""
    keys = {**PALLAS_ENV, "RCOT_PALLAS_BLOCK": "", "RCOT_BWD_BF16": ""}
    saved = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(extra)
    jdispatch.pallas_enabled.cache_clear()
    jax.clear_caches()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jdispatch.pallas_enabled.cache_clear()


BLOCK_DIM, BLOCK_HEADS = 8, 2


@functools.lru_cache(maxsize=None)
def _block_case():
    """(params, x, cotangent) of the one-block test, and the plain fp32 VJP
    (Pallas off), shared by every composition."""
    params = init_transformer_block(jax.random.PRNGKey(63), BLOCK_DIM, BLOCK_HEADS, 2.66,
                                    bias=False, ln_bias=True)
    rng = np.random.default_rng(63)
    x = rng.normal(size=(1, 8, 8, BLOCK_DIM)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    return params, x, cot, _block_vjp(params, x, cot, {})


def _block_vjp(params, x, cot, env):
    """{name: gradient} (the input's as "x"), fp32 numpy, of JAX's
    transformer_block under env."""
    with _jax_env(env):
        if env:
            assert jdispatch.pallas_enabled()
            assert jdispatch.block_mode() == {"0": "off"}.get(env["RCOT_PALLAS_BLOCK"],
                                                                 env["RCOT_PALLAS_BLOCK"])

        def f(p, x):
            out, vjp = jax.vjp(lambda p, x: transformer_block(p, x, BLOCK_HEADS), p, x)
            return vjp(jnp.asarray(cot))
        dp, dx = jax.jit(f)(params, jnp.asarray(x))
    grads = {"x": dx}
    jax_params._block(grads, "b", dp)
    return {k: _np(v) for k, v in grads.items()}


@pytest.mark.parametrize("composition,block_env", [("full", "full"), ("head", "head"),
                                                   ("tail", "tail"), ("off", "0")])
def test_one_block_bwd_bf16_all_matches_jax_pallas(composition, block_env):
    params, x, cot, want32 = _block_case()
    want16 = _block_vjp(params, x, cot, {**PALLAS_ENV, "RCOT_PALLAS_BLOCK": block_env,
                                         "RCOT_BWD_BF16": "all"})
    sd = {}
    jax_params._block(sd, "b", params)
    block = TransformerBlock(BLOCK_DIM, BLOCK_HEADS, 2.66, bias=False, ln_bias=True)
    block.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                          strict=True)
    block.composition = composition
    block.bwd_bf16 = "all"
    named = list(block.named_parameters())
    xt = torch.from_numpy(x).requires_grad_()
    grads = torch.autograd.grad(block(xt), [xt] + [q for _, q in named], torch.from_numpy(cot))
    got = {"x": _np(grads[0]), **{f"b.{n}": _np(g) for (n, _), g in zip(named, grads[1:])}}
    assert got.keys() == want16.keys()
    err = sum(float(np.abs(got[k] - want16[k]).sum()) for k in got)
    gap = sum(float(np.abs(want32[k] - want16[k]).sum()) for k in got)
    print(f"one fp32 block in {composition} with every tier on: sum|port - JAX| / "
          f"sum|fp32 - bf16 operands| {err / gap:.5f}")
    assert gap > 0.0 and err <= BLOCK_RATIO * gap, (err, gap)
