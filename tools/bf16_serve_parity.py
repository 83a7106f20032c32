"""The tiny T_net served in bf16 by rcot_torch (on the CPU) against the JAX
package's bf16 restorer in the same block composition, its Pallas kernels
in interpret mode and XLA's excess precision off, on several seeded
images: prints, per composition and seed, mean|port - JAX bf16| /
mean|JAX fp32 - JAX bf16| (the quarter rule of tests/test_torch_bf16.py
reads <= 0.25) and the share of outputs that differ from JAX's.

    python tools/bf16_serve_parity.py [--compositions full head] [--seeds 14 63]
        [--opt-in] [--jax-spread] [--stages]

--opt-in serves in the opt-in tiers too (--attention-core mdta --depthwise
dwconv; RCOT_PALLAS_MDTA=1 RCOT_PALLAS_FUSED=0 RCOT_PALLAS_DWCONV=1) on 64^2
images (the JAX depthwise kernel needs W % 8 == 0 down to the latent).
--jax-spread prints JAX's own spread beside each ratio: the same bf16
forward run op by op (jax.disable_jit, each op rounding as it goes) against
the compiled one, mean|eager - jit| / mean|fp32 - bf16|. --stages walks the
port's forward op by op instead, each stage also run by the JAX package on
the port's own input to it (`stages`).

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
from rcot_tpu.models.restormer import apply_tnet, init_tnet  # noqa: E402
from rcot_tpu.ops import dispatch as jdispatch  # noqa: E402
from rcot_tpu.utils.config import ModelConfig  # noqa: E402

STRICT = {"xla_allow_excess_precision": False}
TINY = ModelConfig(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                   heads=(1, 2, 4, 8), parity_params=False)  # tests/conftest.py tiny_model_cfg
SWITCHES = ("RCOT_PALLAS", "RCOT_PALLAS_INTERPRET", "RCOT_PALLAS_BLOCK", "RCOT_INFER_BLOCK",
            "RCOT_PALLAS_MDTA", "RCOT_PALLAS_FUSED", "RCOT_PALLAS_DWCONV")
PALLAS = {"RCOT_PALLAS": "1", "RCOT_PALLAS_INTERPRET": "1"}
OPT_IN = {"RCOT_PALLAS_MDTA": "1", "RCOT_PALLAS_FUSED": "0", "RCOT_PALLAS_DWCONV": "1"}


def _set_env(env):
    for k in SWITCHES:
        os.environ.pop(k, None)
    os.environ.update(env)
    jdispatch.pallas_enabled.cache_clear()


def jax_forward(params, img, dtype, env, jit=True):
    """The JAX package's serving forward (make_restorer's: apply_tnet's out2
    in an inference scope, the input cast to dtype) of one image under env,
    compiled with every bf16 rounding kept, or op by op (jit=False)."""
    _set_env(env)

    def fn(p, x):
        with jdispatch.inference_scope():
            return apply_tnet(p, x.astype(dtype), TINY)[0].astype(jnp.float32)
    x = jnp.asarray(img)[None]
    if jit:
        return np.asarray(_strict(fn, params, x))[0]
    with jax.disable_jit():
        return np.asarray(fn(params, x))[0]


def _strict(fn, *args):
    """fn(*args) jitted with every bf16 rounding kept."""
    return jax.jit(fn).lower(*args).compile(STRICT)(*args)


def stages(net, params, inp, heads, env):
    """The port's bf16 forward (net, on the CPU) walked op by op: each stage
    (a conv, a block, a resample, an add) also runs in the JAX package on
    the port's own input to it, under env in an inference scope, and the
    two outputs are compared. Prints per stage the share of outputs that
    differ and max|port - JAX| against max|output|: a stage whose share
    stands out from the blocks' rounding flips is where the two part."""
    from rcot_tpu.models.restormer import transformer_block
    from rcot_tpu.ops.conv import conv2d
    from rcot_tpu.ops.resample import downsample, upsample

    def run(name, port_fn, jax_fn, *xs):
        got = port_fn(*xs)
        _set_env(env)

        def scoped(*a):
            with jdispatch.inference_scope():
                return jax_fn(*a)
        want = np.asarray(_strict(scoped, *(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                                            for x in xs)).astype(jnp.float32))
        g = got.float().numpy()
        err = np.abs(g - want)
        print(json.dumps({"stage": name, "share_differ": float((err > 0).mean()),
                          "max_err": float(err.max()), "max_out": float(np.abs(want).max()),
                          "mean_err": float(err.mean())}), flush=True)
        return got

    def stack(name, blocks, ps, x, h):
        for i, (blk, p) in enumerate(zip(blocks, ps)):
            x = run(f"{name}.{i}", blk, lambda x, p=p: transformer_block(p, x, h), x)
        return x

    def conv(name, x):
        return run(name, getattr(net, name), lambda x: conv2d(params[name], x), x)

    def resample(name, x, down):
        fn = downsample if down else upsample
        return run(name, getattr(net, name), lambda x: fn(params[name], x), x)

    def encode(x, pre):
        e1 = stack(pre + "encoder_level1", getattr(net, pre + "encoder_level1"),
                   params[pre + "encoder_level1"], run(
                       "patch_embed", net.patch_embed,
                       lambda x: conv2d(params["patch_embed"], x), x), heads[0])
        e2 = stack(pre + "encoder_level2", getattr(net, pre + "encoder_level2"),
                   params[pre + "encoder_level2"], resample(pre + "down1_2", e1, True),
                   heads[1])
        e3 = stack(pre + "encoder_level3", getattr(net, pre + "encoder_level3"),
                   params[pre + "encoder_level3"], resample(pre + "down2_3", e2, True),
                   heads[2])
        lat = "reslatent" if pre else "latent"
        return e1, e2, e3, stack(lat, getattr(net, lat), params[lat],
                                 resample("down3_4", e3, True), heads[3])

    def block(name, x, h):
        return run(name, getattr(net, name), lambda x: transformer_block(params[name], x, h),
                   x)

    def cat(name, a, b):
        return run(name, lambda a, b: torch.cat([a, b], -1),
                   lambda a, b: jnp.concatenate([a, b], -1), a, b)

    def decode(tag, latent, e1, e2, e3):
        x = conv("reduce_noise_level3", block("noise_level3", latent, heads[2]))
        x = conv("reduce_chan_level3", cat(tag + "cat3", resample("up4_3", x, False), e3))
        x = stack(tag + "decoder_level3", net.decoder_level3, params["decoder_level3"], x,
                  heads[2])
        x = conv("reduce_noise_level2", block("noise_level2", x, heads[2]))
        x = conv("reduce_chan_level2", cat(tag + "cat2", resample("up3_2", x, False), e2))
        x = stack(tag + "decoder_level2", net.decoder_level2, params["decoder_level2"], x,
                  heads[1])
        x = conv("reduce_noise_level1", block("noise_level1", x, heads[2]))
        x = cat(tag + "cat1", resample("up2_1", x, False), e1)
        x = stack(tag + "decoder_level1", net.decoder_level1, params["decoder_level1"], x,
                  heads[0])
        x = stack(tag + "refinement", net.refinement, params["refinement"], x, heads[0])
        return run(tag + "output + input", lambda x, i: net.output(x) + i,
                   lambda x, i: conv2d(params["output"], x) + i, x, inp)

    with torch.no_grad():
        e1, e2, e3, latent = encode(inp, "")
        out1 = decode("pass 1 ", latent, e1, e2, e3)
        res = run("res = input - out1", lambda a, b: a - b, lambda a, b: a - b, inp, out1)
        reslatent = encode(res, "res")[3]
        latent2 = run("latent2", lambda a, b: a + torch.tensor(0.8, dtype=b.dtype) * b,
                      lambda a, b: a + 0.8 * b, latent, reslatent)
        decode("pass 2 ", latent2, e1, e2, e3)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--compositions", nargs="+", default=["full", "head"])
    p.add_argument("--seeds", nargs="+", type=int, default=[14, 63])
    p.add_argument("--opt-in", action="store_true",
                   help="the opt-in attention core and depthwise tier, on 64^2 images")
    p.add_argument("--jax-spread", action="store_true",
                   help="JAX's own spread: op by op against compiled")
    p.add_argument("--stages", action="store_true",
                   help="walk the port's forward op by op against the JAX package's")
    args = p.parse_args()
    torch.set_num_threads(2)
    params = init_tnet(jax.random.PRNGKey(0), TINY)
    sd = tnet_state_dict_from_jax(params, TINY)
    size = 64 if args.opt_in else 32
    imgs = {s: np.random.default_rng(s).uniform(0, 1, (size, size, 3)).astype(np.float32)
            for s in args.seeds}
    tiers = dict(attention_core="mdta", depthwise="dwconv") if args.opt_in else {}
    tag = "/mdta/dwconv" if args.opt_in else ""
    net = tinf.TNet(TModelConfig(**dataclasses.asdict(TINY)), device="cpu", seed=None)
    net.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    want32 = {s: jax_forward(params, img, jnp.float32, {}) for s, img in imgs.items()}
    for mode in args.compositions:
        env = {**PALLAS, "RCOT_INFER_BLOCK": mode, **(OPT_IN if args.opt_in else {})}
        if args.stages:
            net16 = tinf.cast_copy(net, torch.bfloat16, tiers.get("depthwise", "fused"))
            net16.composition = mode
            for k, v in tiers.items():
                setattr(net16, k, v)
            for s, img in imgs.items():
                print(json.dumps({"composition": mode + tag, "seed": s}), flush=True)
                stages(net16, params, torch.from_numpy(img)[None].to(torch.bfloat16),
                       TINY.heads, env)
            continue
        port = tinf.make_restorer(net, TModelConfig(**dataclasses.asdict(TINY)), device="cpu",
                                  dtype=torch.bfloat16, composition=mode, **tiers)
        port.buckets = (size,)
        for s, img in imgs.items():
            want16, got = jax_forward(params, img, jnp.bfloat16, env), port(img)
            gap = np.abs(want32[s] - want16).mean()
            err = np.abs(got - want16)
            row = {"composition": mode + tag, "seed": s, "mean_ratio": float(err.mean() / gap),
                   "share_differ": float((err > 0).mean())}
            if args.jax_spread:
                eager = jax_forward(params, img, jnp.bfloat16, env, jit=False)
                row["jax_eager_vs_jit_mean_ratio"] = float(np.abs(eager - want16).mean() / gap)
                row["port_vs_jax_eager_mean_ratio"] = float(np.abs(got - eager).mean() / gap)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
