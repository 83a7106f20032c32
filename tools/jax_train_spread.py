"""JAX's own spread on the tiny T_net's gradients, beside the port's.

The same JAX VJP (jax.vjp of apply_tnet for seeded cotangents of its three
outputs, the Pallas kernels in interpret mode) is run compiled and op by op
(jax.disable_jit: each op rounding as it goes, in its own order of sums),
and the two are compared with the rule the port's model-level tests use:

    sum|a - b| / sum|JAX fp32 operands - JAX rounded|

over every parameter's gradient together, and per tensor on the mean (its
median and its largest). Two configurations:

  bf16:     a bf16 input and cotangents, RCOT_PALLAS_BLOCK=tail (the JAX
            trainer's default composition; tests/test_torch_bf16_train_tnet.py),
            the gap against the fp32 plain path;
  bwd_bf16: an fp32 input, RCOT_PALLAS_BLOCK=full and RCOT_BWD_BF16=all (the
            JAX trainer's pair at a per-chip batch of 8 or more;
            tests/test_torch_bwd_bf16_tnet.py), the gap against the fp32
            plain path (Pallas off, no bf16 operand).

With --port the port's gradients on the CPU (autograd through TNet in the
same composition and dtype, bwd_bf16="all" in the second) are held against
the compiled JAX VJP by the same rule, so the two spreads stand side by
side: a port ratio inside JAX's own op-by-op spread is a difference of sum
order, not of arithmetic.

With --iteration, one bf16 minimax iteration of the JAX package
(make_train_iteration, "tail", tests/conftest.py's tiny_config, B = 2,
patch 32; tests/test_torch_bf16_train_iteration.py's batch and GP draw) at
the recipe's learning rate, compiled and op by op: each metric's distance
in bf16 ulps, t_adv's among them; with --port the port's iteration on the
same state, batch and draw (its plain bf16 twins on the CPU) beside it,
and for each run the critic's entries whose two RMSprop steps ended more
than lr from compiled JAX's (`*_critic_flips`: a step of the other sign,
which t_adv reads).
--seed picks the batch there too (31 is the test's, where the port reads
15 ulps of t_adv from the compiled one). The port's iteration runs twice:
as it is ("port") and with its critic's bf16 bias gradients summed as XLA
on the CPU sums them in the compiled JAX iteration ("port_xla_bias_sums";
xla_bias_sums): a bf16 reduce, the transpose of the bias's broadcast,
where PyTorch sums in fp32 and rounds once. Only this tool sums so; the
port's modules are not changed.

    python tools/jax_train_spread.py [--configs bf16 bwd_bf16] [--seed 30] [--port]
        [--iteration]

A CPU tool of the parity checks, not of the port (it imports both
packages); not part of the tests. Each configuration traces the Pallas VJP
once compiled (about a minute and a half) and runs it once op by op (a few
minutes).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rcot_torch.compat.jax_params import tnet_state_dict_from_jax  # noqa: E402
from rcot_torch.models.restormer import TNet  # noqa: E402
from rcot_torch.utils.config import ModelConfig as TModelConfig  # noqa: E402
from rcot_tpu.models.restormer import apply_tnet, init_tnet  # noqa: E402
from rcot_tpu.ops import dispatch as jdispatch  # noqa: E402
from rcot_tpu.utils.config import ModelConfig  # noqa: E402

STRICT = {"xla_allow_excess_precision": False}
TINY = ModelConfig(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                   heads=(1, 2, 4, 8), parity_params=False)  # tests/conftest.py tiny_model_cfg
SWITCHES = ("RCOT_PALLAS", "RCOT_PALLAS_INTERPRET", "RCOT_PALLAS_BLOCK", "RCOT_BWD_BF16")
PALLAS = {"RCOT_PALLAS": "1", "RCOT_PALLAS_INTERPRET": "1"}
CONFIGS = {
    # name: (activation dtype, JAX env, port composition, port bwd_bf16)
    "bf16": (jnp.bfloat16, {**PALLAS, "RCOT_PALLAS_BLOCK": "tail"}, "tail", "0"),
    "bwd_bf16": (jnp.float32, {**PALLAS, "RCOT_PALLAS_BLOCK": "full", "RCOT_BWD_BF16": "all"},
                 "full", "all"),
}


def _set_env(env):
    for k in SWITCHES:
        os.environ.pop(k, None)
    os.environ.update(env)
    jdispatch.pallas_enabled.cache_clear()
    jax.clear_caches()


def jax_grads(params, x, cots, env, jit=True) -> dict:
    """{port name: gradient} (fp32 numpy) of jax.vjp(apply_tnet) under env,
    compiled with every bf16 rounding kept, or op by op (jit=False)."""
    _set_env(env)

    def f(p, x, cots):
        _, vjp = jax.vjp(lambda p: apply_tnet(p, x, TINY), p)
        return vjp(cots)[0]
    if jit:
        grads = jax.jit(f).lower(params, x, cots).compile(STRICT)(params, x, cots)
    else:
        with jax.disable_jit():
            grads = f(params, x, cots)
    return {k: np.asarray(v, np.float32) for k, v in tnet_state_dict_from_jax(grads, TINY).items()}


def port_grads(params, x, cots, dtype, composition, bwd_bf16) -> dict:
    """The same gradients by autograd through the port's TNet on the CPU."""
    net = TNet(TModelConfig(**dataclasses.asdict(TINY)), device="cpu", seed=None,
               composition=composition, bwd_bf16=bwd_bf16)
    sd = tnet_state_dict_from_jax(params, TINY)
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    named = list(net.named_parameters())
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    outs = net(torch.from_numpy(np.array(x, np.float32)).to(tdt))
    grads = torch.autograd.grad(outs, [p for _, p in named],
                                [torch.from_numpy(np.array(c, np.float32)).to(tdt)
                                 for c in cots])
    return {n: g.float().numpy() for (n, _), g in zip(named, grads)}


def ratio(a: dict, ref: dict, fp32: dict) -> dict:
    """sum|a - ref| / sum|fp32 - ref| over every tensor, and per tensor on
    the mean: the median and the three largest."""
    err = sum(float(np.abs(a[k] - ref[k]).sum()) for k in ref)
    gap = sum(float(np.abs(fp32[k] - ref[k]).sum()) for k in ref)
    per = sorted(((float(np.abs(a[k] - ref[k]).mean()
                         / max(float(np.abs(fp32[k] - ref[k]).mean()), 1e-30)), k)
                  for k in ref), reverse=True)
    return {"summed": err / gap, "median_tensor": per[len(per) // 2][0],
            "largest": [(round(r, 4), k) for r, k in per[:3]],
            "share_differ": float(np.mean([(a[k] != ref[k]).mean() for k in ref]))}


@contextlib.contextmanager
def xla_bias_sums():
    """The port's critic (models/critic.py) with each bf16 bias added by an
    op whose backward sums the bias gradient as the compiled JAX iteration
    does: lax.reduce_sum in bf16 (the transpose of the bias's broadcast,
    bf16 accumulation), compiled with excess precision off, where PyTorch
    accumulates in fp32 and rounds once. Inside a double backward (the
    gradient penalty's graph) the sum stays PyTorch's, differentiable."""
    from jax import lax

    from rcot_torch.models import critic as tcritic
    from rcot_torch.ops import conv as tconv
    compiled = {}

    def xla_sum(g):
        a = jnp.asarray(g.float().numpy(), jnp.bfloat16)
        axes = tuple(range(a.ndim - 1))
        if a.shape not in compiled:
            compiled[a.shape] = jax.jit(lambda t: lax.reduce_sum_p.bind(t, axes=axes)).lower(
                a).compile(STRICT)
        return torch.from_numpy(np.asarray(compiled[a.shape](a), np.float32)).bfloat16()

    class BiasAdd(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y, b):
            return y + b

        @staticmethod
        def backward(ctx, g):
            if torch.is_grad_enabled():
                return g, g.sum(dim=tuple(range(g.dim() - 1)))
            return g, xla_sum(g)

    def wrap(op):
        def f(x, weight, bias=None, **kw):
            if bias is None or x.dtype != torch.bfloat16:
                return op(x, weight, bias, **kw)
            return BiasAdd.apply(op(x, weight, None, **kw), bias.to(x.dtype))
        return f
    saved = tcritic.conv2d, tcritic.linear
    tcritic.conv2d, tcritic.linear = wrap(tconv.conv2d), wrap(tconv.linear)
    try:
        yield
    finally:
        tcritic.conv2d, tcritic.linear = saved


def iteration_spread(seed: int, port: bool) -> dict:
    """{"jax": {metric: |op by op - compiled|}, "port": {metric: |port -
    compiled|}} in bf16 ulps of the compiled value, of one bf16 minimax
    iteration of the JAX package at the recipe's learning rate."""
    from rcot_torch.compat.jax_params import fnet_state_dict_from_jax
    from rcot_torch.train import steps as tsteps
    from rcot_torch.utils.config import config_from_dict
    from rcot_tpu.train import steps as jsteps
    from rcot_tpu.utils.config import Config, CriticConfig, DataConfig, TrainConfig
    cfg = Config(model=ModelConfig(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                                   parity_params=False),
                 critic=CriticConfig(patch_size=32), data=DataConfig(patch_size=32),
                 train=TrainConfig(batch_size=2))
    b, patch = cfg.train.batch_size, cfg.critic.patch_size
    state = jsteps.create_train_state(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(seed)
    deg, tgt = (jnp.asarray(rng.uniform(0, 1, (b, patch, patch, 3)), jnp.bfloat16)
                for _ in range(2))
    de_id = np.array([0, 3], np.int32)
    batch = jsteps.Batch(deg, tgt, jnp.asarray(de_id))
    key = jax.random.PRNGKey(12)
    args = (state, batch, key, jnp.asarray(True), jnp.asarray(cfg.train.lr, jnp.float32))
    _set_env({**PALLAS, "RCOT_PALLAS_BLOCK": "tail"})
    it = jsteps.make_train_iteration(cfg)
    jit_state, jit = jax.jit(it).lower(*args).compile(STRICT)(*args)
    with jax.disable_jit():
        eager_state, eager = it(*args)

    def critic(f_params):
        return {k: np.asarray(v, np.float32)
                for k, v in fnet_state_dict_from_jax(f_params, cfg.critic).items()}
    ref = critic(jit_state.f_params)

    def flips(sd):
        # the critic's entries whose two RMSprop steps moved them more than
        # lr away from compiled JAX's: a step of the other sign (each first
        # step is about +-10 lr, its sign the gradient's)
        per = {k: int((np.abs(sd[k] - ref[k]) > cfg.train.lr).sum()) for k in ref}
        return {"entries": sum(per.values()), "of": sum(v.size for v in ref.values()),
                "largest": sorted(((n, k) for k, n in per.items() if n), reverse=True)[:4]}

    def ulps(m):
        # f_wgan nearly cancels at initialisation: ulps of max(|f_wgan|, 1)
        def ulp(v):
            return 2.0 ** (np.floor(np.log2(abs(v))) - 7)
        return {k: abs(float(m[k]) - float(jit[k])) / ulp(max(abs(float(jit[k])), 1.0)
                                                          if k == "f_wgan" else float(jit[k]))
                for k in jit}
    out = {"jax_op_by_op": ulps(eager),
           "jax_op_by_op_critic_flips": flips(critic(eager_state.f_params))}
    if port:
        tcfg = config_from_dict(cfg.to_dict())
        alpha = jax.random.uniform(key, (b, 1, 1, 1), dtype=jnp.bfloat16)
        tb = tsteps.Batch(*(torch.from_numpy(np.array(a, np.float32)).bfloat16()
                            for a in (deg, tgt)), torch.from_numpy(de_id))
        a = torch.from_numpy(np.array(alpha, np.float32)).bfloat16()
        for tag, sums in (("port", contextlib.nullcontext), ("port_xla_bias_sums",
                                                             xla_bias_sums)):
            ts = tsteps.create_train_state(tcfg, seed=0, device="cpu")
            for net, sd in ((ts.t_net, tnet_state_dict_from_jax(state.t_params, cfg.model)),
                            (ts.f_net, fnet_state_dict_from_jax(state.f_params, cfg.critic))):
                net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                                    strict=True)
            with sums():
                _, m = tsteps.make_train_iteration(tcfg)(ts, tb, a, True, cfg.train.lr)
            out[tag] = ulps({k: float(v) for k, v in m.items()})
            out[f"{tag}_critic_flips"] = flips({k: v.detach().float().numpy()
                                                for k, v in ts.f_net.state_dict().items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS), choices=list(CONFIGS))
    ap.add_argument("--seed", type=int, default=30)
    ap.add_argument("--port", action="store_true", help="the port's ratio beside JAX's spread")
    ap.add_argument("--iteration", action="store_true",
                    help="one bf16 minimax iteration, compiled against op by op")
    args = ap.parse_args(argv)
    if args.iteration:
        t0 = time.perf_counter()
        print(json.dumps({"iteration_bf16_ulps_from_jit": iteration_spread(args.seed, args.port),
                          "seed": args.seed, "seconds": time.perf_counter() - t0}), flush=True)
        return 0
    params = init_tnet(jax.random.PRNGKey(0), TINY)
    rng = np.random.default_rng(args.seed)
    shape = (1, 16, 16, 3)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    cots = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    for name in args.configs:
        dtype, env, composition, tiers = CONFIGS[name]
        xj, cj = jnp.asarray(x, dtype), tuple(jnp.asarray(c, dtype) for c in cots)
        seconds = {}
        t0 = time.perf_counter()
        fp32 = jax_grads(params, jnp.asarray(xj, jnp.float32),
                         tuple(jnp.asarray(c, jnp.float32) for c in cj), {})
        seconds["fp32 plain"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        jit = jax_grads(params, xj, cj, env)
        seconds["jit"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        eager = jax_grads(params, xj, cj, env, jit=False)
        seconds["op by op"] = time.perf_counter() - t0
        row = {"config": name, "seed": args.seed, "env": env,
               "jax_op_by_op_vs_jit": ratio(eager, jit, fp32)}
        if args.port:
            t0 = time.perf_counter()
            row["port_vs_jax_jit"] = ratio(port_grads(params, xj, cj, dtype, composition, tiers),
                                           jit, fp32)
            seconds["port"] = time.perf_counter() - t0
        row["seconds"] = seconds
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
