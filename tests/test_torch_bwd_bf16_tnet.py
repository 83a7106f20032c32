"""The tiny T_net's fp32 gradients with every backward tier on bf16
operands, in the port against the JAX package's, on the CPU: jax.vjp
(apply_tnet) under RCOT_PALLAS_BLOCK=full and RCOT_BWD_BF16=all, the JAX
trainer's own pair (rcot_tpu/train/trainer.py:78-110 sets both at a
per-chip batch of 8 or more), the Pallas kernels in interpret mode, against
autograd through the port's TNet(composition="full", bwd_bf16="all") on the
same fp32 input (the plain twins with bf16 operands on the CPU;
tests/test_torch_bwd_bf16.py holds them kernel by kernel and one block in
every composition).

Gate, the summed rule of tests/test_torch_bf16_train_tnet.py: sum|port -
JAX bf16 operands| <= MODEL_RATIO * sum|JAX fp32 operands - JAX bf16
operands| over every parameter's gradient together, the fp32-operand side
JAX's plain path (Pallas off; its fp32 kernels agree with it far below that
gap). Both sides round the same operands to bf16, from fp32 values that
differ only by their order of sums; where such a value lies next to a
rounding boundary they round it one bf16 ulp apart, and the backward
carries each flip into the next block's cotangent, where it moves more
values across boundaries. So the two sides' roundings part more with each
block the backward goes through: at the refinement block, which the
backward reaches first, the port reads 0.27 of the gap (FIRST_RATIO 0.5),
at the encoder's first level 0.87, over every gradient 0.76 (MODEL_RATIO
0.9); a port whose backward ignored the option reads 1.00 at every one. The
JAX package against itself, the same VJP op by op against compiled
(tools/jax_train_spread.py, seed 30), reads 0.69 summed, where the port
reads 0.70 against JAX: the model-level gap is the order of sums'. Kernel
by kernel the port is within 0.004 of the gap (tests/test_torch_bwd_bf16.py).
One block in every composition is in tests/test_torch_bwd_bf16_block.py.
A file of its own, so that another worker takes it: tracing the Pallas VJP
of the whole model in interpret mode takes most of its time.
"""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rcot_torch.compat.jax_params import tnet_state_dict_from_jax
from rcot_torch.models.restormer import TNet
from rcot_torch.utils.config import ModelConfig as TModelConfig
from rcot_tpu.models.restormer import apply_tnet, init_tnet
from rcot_tpu.ops import dispatch as jdispatch

ENV = {"RCOT_PALLAS": "1", "RCOT_PALLAS_INTERPRET": "1", "RCOT_PALLAS_BLOCK": "full",
       "RCOT_BWD_BF16": "all"}
MODEL_RATIO = 0.9
FIRST_RATIO = 0.5


def _jax_grads(params, cfg, x, cots, env):
    """{port name: gradient}, fp32 numpy, of jax.vjp(apply_tnet) for the
    cotangents of its outputs, under the RCOT_* env given (none: the plain
    path), traced afresh."""
    saved = {k: os.environ.get(k) for k in ENV}
    for k in ENV:
        os.environ.pop(k, None)
    os.environ.update(env)
    jdispatch.pallas_enabled.cache_clear()
    jax.clear_caches()
    try:
        if env:
            assert jdispatch.pallas_enabled() and jdispatch.block_mode() == "full"

        def f(p, x, cots):
            _, vjp = jax.vjp(lambda p: apply_tnet(p, x, cfg), p)
            return vjp(cots)[0]
        grads = jax.jit(f)(params, x, cots)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jdispatch.pallas_enabled.cache_clear()
    return {k: np.asarray(v, np.float32) for k, v in tnet_state_dict_from_jax(grads, cfg).items()}


def test_tiny_tnet_bwd_bf16_gradients_match_jax_pallas_full(tiny_model_cfg):
    # one pass (decoder=False): the second pass runs the same kernels, and
    # tracing the Pallas VJP of both takes twice as long
    cfg = dataclasses.replace(tiny_model_cfg, decoder=False)
    params = init_tnet(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(32)
    shape = (1, 16, 16, 3)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    cots = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    t0 = time.perf_counter()
    want16 = _jax_grads(params, cfg, jnp.asarray(x), tuple(map(jnp.asarray, cots)), ENV)
    t1 = time.perf_counter()
    want32 = _jax_grads(params, cfg, jnp.asarray(x), tuple(map(jnp.asarray, cots)), {})
    t2 = time.perf_counter()

    net = TNet(TModelConfig(**dataclasses.asdict(cfg)), device="cpu", seed=None,
               composition="full", bwd_bf16="all")
    sd = tnet_state_dict_from_jax(params, cfg)
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    named = list(net.named_parameters())
    outs = net(torch.from_numpy(x))
    grads = torch.autograd.grad(outs, [p for _, p in named], [torch.from_numpy(c) for c in cots],
                                allow_unused=True)
    got = {n: g.numpy() for (n, _), g in zip(named, grads) if g is not None}
    # the residual branch's parameters take no part in one pass: JAX's zeros
    assert got.keys() <= want16.keys()
    assert all(not want16[k].any() for k in want16.keys() - got.keys())

    def ratio(keys):
        err = sum(float(np.abs(got[k] - want16[k]).sum()) for k in keys)
        gap = sum(float(np.abs(want32[k] - want16[k]).sum()) for k in keys)
        assert gap > 0.0, keys
        return err / gap
    summed = ratio(list(got))
    first = ratio([k for k in got if k.startswith("refinement.0.")])
    print(f"tiny T_net in fp32, every tier on bf16 operands: sum|port - JAX| / sum|fp32 - "
          f"bf16 operands| over {len(got)} gradients {summed:.4f}, at the refinement block "
          f"{first:.4f}; JAX traces {t1 - t0:.1f} s (Pallas) and {t2 - t1:.1f} s (plain)")
    assert summed <= MODEL_RATIO and first <= FIRST_RATIO, (summed, first)
