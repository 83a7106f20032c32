"""The tiny T_net's bf16 gradients in "full" in the port against the JAX
package's, on the CPU: jax.vjp(apply_tnet) on a bf16 input under
RCOT_PALLAS_BLOCK=full with the Gram core and the fused tier (the block
head's and tail's Pallas kernels forward and backward, the head's backward
in bf16 among them), in interpret mode with XLA's excess precision off
(tests/test_torch_bf16.py says why), against autograd through the port's
"full" on the same bf16 input (the plain bf16 twins on the CPU,
tests/test_torch_bf16_head_gdfn.py holds the head's backward kernel by
kernel).

Gate, the rule of tests/test_torch_bf16_train_tnet.py ("tail"):
sum|port - JAX bf16| <= MODEL_RATIO * sum|JAX fp32 - JAX bf16| over every
parameter's gradient together, and over the three outputs, the fp32 side
JAX's plain path (Pallas off). A file of its own: tracing the Pallas VJPs
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

STRICT = {"xla_allow_excess_precision": False}
FULL_ENV = {"RCOT_PALLAS": "1", "RCOT_PALLAS_INTERPRET": "1", "RCOT_PALLAS_BLOCK": "full"}
MODEL_RATIO = 0.75  # tests/test_torch_bf16_train_tnet.py


def _jax_grads(params, cfg, x, cots, env):
    """(the three outputs, {port name: gradient}), fp32 numpy, of
    jax.vjp(apply_tnet) for the cotangents of its outputs, under the RCOT_*
    env given (none: the plain path)."""
    saved = {k: os.environ.get(k) for k in FULL_ENV}
    for k in FULL_ENV:
        os.environ.pop(k, None)
    os.environ.update(env)
    jdispatch.pallas_enabled.cache_clear()
    try:
        if env:
            assert jdispatch.pallas_enabled() and jdispatch.block_mode() == "full"

        def f(p, x, cots):
            outs, vjp = jax.vjp(lambda p: apply_tnet(p, x, cfg), p)
            return outs, vjp(cots)[0]
        outs, grads = jax.jit(f).lower(params, x, cots).compile(STRICT)(params, x, cots)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jdispatch.pallas_enabled.cache_clear()
    grads = tnet_state_dict_from_jax(grads, cfg)
    return ([np.asarray(o, np.float32) for o in outs],
            {k: np.asarray(v, np.float32) for k, v in grads.items()})


def test_tiny_tnet_bf16_gradients_match_jax_pallas_full(tiny_model_cfg):
    cfg = tiny_model_cfg
    params = init_tnet(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(31)
    shape = (1, 16, 16, 3)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    cots = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    x16 = jnp.asarray(x, jnp.bfloat16)
    c16 = tuple(jnp.asarray(c, jnp.bfloat16) for c in cots)
    t0 = time.perf_counter()
    outs16, want16 = _jax_grads(params, cfg, x16, c16, FULL_ENV)
    t1 = time.perf_counter()
    outs32, want32 = _jax_grads(params, cfg, jnp.asarray(x16, jnp.float32),
                                tuple(jnp.asarray(c, jnp.float32) for c in c16), {})
    t2 = time.perf_counter()

    net = TNet(TModelConfig(**dataclasses.asdict(cfg)), device="cpu", seed=None,
               composition="full")
    sd = tnet_state_dict_from_jax(params, cfg)
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    named = list(net.named_parameters())
    outs = net(torch.from_numpy(x).to(torch.bfloat16))
    assert all(o.dtype == torch.bfloat16 for o in outs)
    grads = torch.autograd.grad(outs, [p for _, p in named],
                                [torch.from_numpy(c).to(torch.bfloat16) for c in cots])
    got = {n: g.numpy() for (n, _), g in zip(named, grads)}
    assert got.keys() == want16.keys()
    assert all(g.dtype == np.float32 for g in got.values())

    def ratio(pairs):
        err = sum(float(np.abs(g - w16).sum()) for g, w16, _ in pairs)
        gap = sum(float(np.abs(w32 - w16).sum()) for _, w16, w32 in pairs)
        return err / gap
    out_ratio = ratio([(o.float().detach().numpy(), w16, w32)
                       for o, w16, w32 in zip(outs, outs16, outs32)])
    grad_ratio = ratio([(got[k], want16[k], want32[k]) for k in got])
    differ = np.mean([(got[k] != want16[k]).mean() for k in got])
    print(f"tiny T_net in bf16 full, sum|port - JAX| / sum|fp32 - bf16|: outputs "
          f"{out_ratio:.4f}, {len(got)} gradients {grad_ratio:.4f}; {differ:.4f} of the "
          f"gradient entries differ (JAX seconds: bf16 Pallas {t1 - t0:.1f}, fp32 plain "
          f"{t2 - t1:.1f})")
    assert out_ratio <= MODEL_RATIO and grad_ratio <= MODEL_RATIO, (out_ratio, grad_ratio)
