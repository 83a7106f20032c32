"""The tiny T_net served in bf16 by rcot_torch (on the CPU) against the JAX
package's bf16 restorer in the same block composition, its Pallas kernels
in interpret mode and XLA's excess precision off, on several seeded
images: prints, per composition and seed, mean|port - JAX bf16| /
mean|JAX fp32 - JAX bf16| (the quarter rule of tests/test_torch_bf16.py
reads <= 0.25) and the share of outputs that differ from JAX's.

    python tools/bf16_serve_parity.py [--compositions full head] [--seeds 14 63]

A CPU tool of the parity checks, not of the port: like the tests, it
imports both packages. One JAX trace per composition (a few tens of
seconds); each seed then reuses it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rcot_torch.compat.jax_params import tnet_state_dict_from_jax  # noqa: E402
from rcot_torch.models import inference as tinf  # noqa: E402
from rcot_torch.utils.config import ModelConfig as TModelConfig  # noqa: E402
from rcot_tpu.models import inference as jinf  # noqa: E402
from rcot_tpu.models.restormer import init_tnet  # noqa: E402
from rcot_tpu.ops import dispatch as jdispatch  # noqa: E402
from rcot_tpu.utils.config import ModelConfig  # noqa: E402

STRICT = {"xla_allow_excess_precision": False}
TINY = ModelConfig(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                   heads=(1, 2, 4, 8), parity_params=False)  # tests/conftest.py tiny_model_cfg
SWITCHES = ("RCOT_PALLAS", "RCOT_PALLAS_INTERPRET", "RCOT_PALLAS_BLOCK", "RCOT_INFER_BLOCK")


def jax_restorer(params, dtype, env):
    """The JAX package's restorer under env, compiled with every bf16
    rounding kept, one 32^2 bucket."""
    for k in SWITCHES:
        os.environ.pop(k, None)
    os.environ.update(env)
    jdispatch.pallas_enabled.cache_clear()
    r = jinf.make_restorer(params, TINY, dtype=dtype)
    jitted, cache = r._jitted, {}

    def fwd(*args):
        key = tuple((a.shape, a.dtype) for a in jax.tree_util.tree_leaves(args))
        if key not in cache:
            cache[key] = jitted.lower(*args).compile(STRICT)
        return cache[key](*args)
    r._jitted = fwd
    r.buckets = (32,)
    return r


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--compositions", nargs="+", default=["full", "head"])
    p.add_argument("--seeds", nargs="+", type=int, default=[14, 63])
    args = p.parse_args()
    torch.set_num_threads(2)
    params = init_tnet(jax.random.PRNGKey(0), TINY)
    sd = tnet_state_dict_from_jax(params, TINY)
    imgs = {s: np.random.default_rng(s).uniform(0, 1, (32, 32, 3)).astype(np.float32)
            for s in args.seeds}
    fp32 = jax_restorer(params, jnp.float32, {})
    want32 = {s: np.asarray(fp32(img)) for s, img in imgs.items()}
    for mode in args.compositions:
        bf16 = jax_restorer(params, jnp.bfloat16, {"RCOT_PALLAS": "1",
                                                   "RCOT_PALLAS_INTERPRET": "1",
                                                   "RCOT_INFER_BLOCK": mode})
        port = tinf.make_restorer(sd, TModelConfig(**dataclasses.asdict(TINY)), device="cpu",
                                  dtype=torch.bfloat16, composition=mode)
        port.buckets = (32,)
        for s, img in imgs.items():
            want16, got = np.asarray(bf16(img)), port(img)
            err = np.abs(got - want16)
            print(json.dumps({"composition": mode, "seed": s,
                              "mean_ratio": float(err.mean() / np.abs(want32[s] - want16).mean()),
                              "share_differ": float((err > 0).mean())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
