"""bf16 in the opt-in tiers (--attention-core mdta, --depthwise dwconv) in the
port against the JAX package's, on the CPU.

The JAX package runs both opt-in tiers on bf16 activations
(RCOT_PALLAS_MDTA=1, RCOT_PALLAS_FUSED=0 RCOT_PALLAS_DWCONV=1). Its two
kernels there, and what the port mirrors of them:

- row 11, dwconv3x3_pallas (rcot_tpu/ops/pallas_dwconv.py): the tier
  passes the depthwise weight uncast (rcot_tpu/ops/attention.py:112-114,
  gdfn.py:66-67), so a bf16 x meets fp32 taps; the kernel sums the nine
  widened products in fp32 and writes bf16; its VJP's dx is the same
  kernel on the bf16 cotangent, its dtaps an fp32 sum cast to the taps'
  dtype, fp32 (ops/dwconv.py dwconv3x3_bf16_plain, dwconv3x3_dtaps);
- row 10, mdta_attend_pallas (pallas_mdta.py): the forward widens q, k and
  v and keeps G, the norms and P in fp32; the backward is jax.vjp of the
  jnp formula on the bf16 residuals, which rounds q-hat, k-hat and attn to
  bf16 (ops/mdta.py mdta_attend_bf16_plain, mdta_attend_jnp_bf16); where
  its wrapper finds no chunk of N, or c % 8 != 0, the forward is the jnp
  formula too (mdta_route).

The JAX side is compiled with xla_allow_excess_precision off (`_strict_vjp`,
tests/test_torch_bf16.py says why), its Pallas kernels in interpret mode.

Gates, kernel by kernel (tests/test_torch_bf16_head_gdfn.py's): each bf16
output equal to JAX's bit for bit in at least 99% of its entries and every
entry within 2^-6 * max(max|JAX|, 1); dtaps (fp32) within 1e-5 * max(max|JAX|,
1); row 10's gradients by the quarter rule on the mean, mean|port - JAX bf16|
<= mean|JAX fp32 - JAX bf16| / 4, each (the fp32 side the same VJP on the
same values in fp32).

One transformer block in off/mdta/dwconv and in head/gram/dwconv, forward
and VJP for a bf16 cotangent, the fp32 parameters' gradients too:
sum|port - JAX bf16| <= MODEL_RATIO * sum|JAX fp32 - JAX bf16| over the
output and over every gradient together, the fp32 side JAX's plain path.
The tiny T_net served in bf16 in off/mdta/dwconv (its noise_level1 heads of
4 channels take the jnp route), at 64^2 (the JAX depthwise kernel needs W %
8 == 0 down to the latent), on the images of seeds 14 and 63: mean|port -
JAX bf16| <= MODEL_RATIO * mean|JAX fp32 - JAX bf16|. Not the quarter rule
of tests/test_torch_bf16.py: the JAX package does not meet it against
itself. Run op by op (jax.disable_jit) against its compiled forward, its
bf16 output reads 0.36-0.37 of the gap in "full" at both seeds
(tools/bf16_serve_parity.py --jax-spread); walked op by op on the same
inputs (--stages), the port's ops equal JAX's but for a few rounding
flips, which the attention, a sum over every pixel, carries to the whole
image. Where the flips fall decides the ratio: "full" reads 0.086 at seed
14 and 0.33 at seed 63, off/mdta/dwconv 0.34 at seed 14 (PERF.md §6).
"""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcot_torch.compat import jax_params
from rcot_torch.compat.jax_params import tnet_state_dict_from_jax
from rcot_torch.kernels import build
from rcot_torch.models import inference as tinf
from rcot_torch.models.restormer import TNet, TransformerBlock
from rcot_torch.ops import dwconv as tdw
from rcot_torch.ops import gdfn as tgdfn
from rcot_torch.ops import mdta as tmdta
from rcot_torch.utils.config import ModelConfig as TModelConfig
from rcot_tpu.models import inference as jinf
from rcot_tpu.models.restormer import init_tnet, init_transformer_block, transformer_block
from rcot_tpu.ops import dispatch as jdispatch
from rcot_tpu.ops.pallas_dwconv import dwconv3x3_pallas as j_dwconv
from rcot_tpu.ops.pallas_mdta import mdta_attend_pallas as j_mdta

BF = jnp.bfloat16
STRICT = {"xla_allow_excess_precision": False}
BF16_RTOL = 2.0 ** -6
EQUAL_SHARE = 0.99
F32_RTOL = 1e-5
MODEL_RATIO = 0.75
PALLAS_ENV = {"RCOT_PALLAS": "1", "RCOT_PALLAS_INTERPRET": "1"}
OPT_IN_ENV = {"RCOT_PALLAS_MDTA": "1", "RCOT_PALLAS_FUSED": "0", "RCOT_PALLAS_DWCONV": "1"}
SWITCHES = ("RCOT_PALLAS", "RCOT_PALLAS_INTERPRET", "RCOT_PALLAS_BLOCK", "RCOT_INFER_BLOCK",
            "RCOT_PALLAS_MDTA", "RCOT_PALLAS_FUSED", "RCOT_PALLAS_DWCONV")


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _jax_env(env):
    """The JAX package's RCOT_* switches as env gives them, for one call."""
    saved = {k: os.environ.get(k) for k in SWITCHES}
    for k in SWITCHES:
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


def _strict_vjp(fn, primals, cot):
    """(fn(*primals), its VJP for cot), compiled by XLA with every bf16
    rounding kept."""
    def f(primals, cot):
        out, vjp = jax.vjp(fn, *primals)
        return out, vjp(cot)
    return jax.jit(f).lower(primals, cot).compile(STRICT)(primals, cot)


def _np(a) -> np.ndarray:
    """A torch or JAX array as fp32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _check(name, got, want):
    """got (torch) against want (JAX) under the kernel gates of the docstring."""
    assert tuple(got.shape) == tuple(want.shape), name
    bf16 = want.dtype == BF
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32), name
    g, w = _np(got), _np(want)
    err = float(np.abs(g - w).max())
    scale = max(float(np.abs(w).max()), 1.0)
    tol = (BF16_RTOL if bf16 else F32_RTOL) * scale
    equal = float((g == w).mean())
    print(f"{name}: max|port - JAX| {err:.3e} (gate {tol:.3e}), {equal:.4f} of the "
          "elements equal")
    assert err <= tol, (name, err, tol)
    if bf16:
        assert equal >= EQUAL_SHARE, (name, equal)


def _bf(a):
    return torch.from_numpy(a).to(torch.bfloat16)


# ------------------------------------------------------------ the kernels

@pytest.mark.parametrize("shape", [(2, 16, 16, 48), (1, 8, 16, 254)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dwconv3x3_bf16_twins_match_pallas_with_fp32_taps(shape):
    """Row 11 on a bf16 x with fp32 taps, forward and VJP: out and dx bf16,
    dtaps fp32 and never rounded to bf16 (a 3C and a GDFN width, W % 8 == 0
    as the JAX kernel needs)."""
    rng = np.random.default_rng(70 + shape[-1])
    x, g = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    w = (rng.normal(size=(3, 3, shape[-1])) * 0.3).astype(np.float32)
    out, (dx, dw) = _strict_vjp(lambda x, w: j_dwconv(x, w, True),
                                (jnp.asarray(x, BF), jnp.asarray(w)), jnp.asarray(g, BF))
    assert (out.dtype, dx.dtype, dw.dtype) == (BF, BF, jnp.float32)
    xt = _bf(x).requires_grad_()
    taps = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (2, 0, 1)))).requires_grad_()
    build.reset_launches()
    got = tdw.dwconv3x3(xt, taps)
    gx, gt = torch.autograd.grad(got, (xt, taps), _bf(g))
    assert not build.LAUNCHES  # the CPU takes the plain twins
    _check("dwconv3x3 bf16 out", got, out)
    _check("dwconv3x3 bf16 dx", gx, dx)
    _check("dwconv3x3 bf16 dtaps", gt, jnp.transpose(dw, (2, 0, 1)))
    assert not torch.equal(gt, gt.bfloat16().float())  # fp32, not bf16 values


MDTA_SHAPES = [(c, n) for n in (300, 2304) for c in (8, 24, 48)] + [(8, 2112), (12, 300)]


@pytest.mark.parametrize("c,n", MDTA_SHAPES, ids=[f"c{c}_N{n}" for c, n in MDTA_SHAPES])
def test_mdta_attend_bf16_twins_match_pallas(c, n):
    """Row 10 on bf16 q, k, v (the temperature fp32), forward and VJP. N =
    300 is one chunk of the TPU kernel, 2304 nine of 256; at N = 2,112 (no
    chunk: N > 2048, N % 128 = 64) and at c = 12 (c % 8 != 0) the JAX
    wrapper takes the jnp formula, and so does the port (mdta_route,
    counted as mdta_attend_jnp_bf16)."""
    rng = np.random.default_rng(80 + c + n)
    q, k, v, g = (rng.normal(size=(2, 2, c, n)).astype(np.float32) for _ in range(4))
    temp = rng.uniform(0.5, 2.0, (2, 1, 1)).astype(np.float32)

    def jax_side(dtype):
        return _strict_vjp(lambda *a: j_mdta(*a, True),
                           (*(jnp.asarray(jnp.asarray(a, BF), dtype) for a in (q, k, v)),
                            jnp.asarray(temp)), jnp.asarray(jnp.asarray(g, BF), dtype))
    out16, grads16 = jax_side(BF)
    _, grads32 = jax_side(jnp.float32)
    route = tmdta.mdta_route(c, n)
    assert route == ("jnp" if n == 2112 or c % 8 else "kernel")
    leaves = [_bf(a).requires_grad_() for a in (q, k, v)]
    leaves.append(torch.from_numpy(temp).requires_grad_())
    build.reset_launches()
    got = tmdta.mdta_attend(*leaves)
    assert dict(build.LAUNCHES) == ({"mdta_attend_jnp_bf16": 1} if route == "jnp" else {})
    _check(f"mdta_attend bf16 {route} out", got, out16)
    grads = torch.autograd.grad(got, leaves, _bf(g))
    for name, a, w16, w32 in zip(("dq", "dk", "dv", "dtemperature"), grads, grads16, grads32):
        assert a.dtype == (torch.float32 if name == "dtemperature" else torch.bfloat16), name
        err = float(np.abs(_np(a) - _np(w16)).mean())
        gap = float(np.abs(_np(w32) - _np(w16)).mean())
        print(f"mdta_attend bf16 {name}: mean|port - JAX| {err:.3e}, mean|fp32 - bf16| "
              f"{gap:.3e}")
        assert gap > 0 and err <= gap / 4, (name, err, gap)


def test_the_bf16_forward_twin_keeps_p_in_fp32_and_the_backward_does_not():
    """The kernel's forward (P fp32, out rounded once) and the jnp formula
    (q-hat, k-hat and attn rounded) are two functions in bf16: they differ
    on the same inputs, and each is its own JAX counterpart's (above)."""
    rng = np.random.default_rng(88)
    q, k, v = (_bf(rng.normal(size=(1, 2, 24, 300)).astype(np.float32)) for _ in range(3))
    temp = torch.full((2, 1, 1), 1.5)
    a = tmdta.mdta_attend_bf16_plain(q, k, v, temp)
    b = tmdta.mdta_attend_jnp_bf16(q, k, v, temp)
    assert a.dtype == b.dtype == torch.bfloat16 and not torch.equal(a, b)
    assert torch.equal(tmdta.mdta_attend_fwd(q, k, v, temp), a)


def test_the_bf16_gate_rounds_where_jax_rounds():
    """gelu(x1) * x2 on bf16 (ops/gdfn.py gated): jax.nn.gelu's exact form
    on bf16 and the product, each XLA op rounding, bit for bit."""
    rng = np.random.default_rng(89)
    h = (rng.normal(size=(2, 5, 7, 42)) * 2).astype(np.float32)
    x1, x2 = np.split(h, 2, axis=-1)
    want = jax.jit(lambda a, b: jax.nn.gelu(a, approximate=False) * b).lower(
        jnp.asarray(x1, BF), jnp.asarray(x2, BF)).compile(STRICT)(
        jnp.asarray(x1, BF), jnp.asarray(x2, BF))
    got = tgdfn.gated(_bf(h))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_np(got), _np(want))
    # the fp32 gate rounded once differs
    assert not torch.equal(tgdfn.gated(_bf(h).float()).bfloat16(), got)


# ------------------------------------------------------------ the plans

def test_the_route_is_the_jax_wrappers():
    """mdta_route mirrors pallas_mdta.py _pick_chunk and the c % 8 test."""
    from rcot_tpu.ops.pallas_mdta import _pick_chunk
    for n in (1, 64, 300, 1025, 2048, 2049, 2112, 2304, 4096, 65536, 69696, 80250, 20125):
        for c in (4, 8, 12, 24, 48, 96, 192):
            want = "jnp" if _pick_chunk(n) == 0 or c % 8 else "kernel"
            assert tmdta.mdta_route(c, n) == want, (c, n)
    # every block of ModelConfig() at 128^2 and 256^2 takes the kernel
    for res in (128, 256):
        for level, ch in ((1, 48), (2, 48), (4, 48), (8, 48), (8, 96), (4, 48), (2, 24)):
            assert tmdta.mdta_route(ch, (res // level) ** 2) == "kernel"


def test_the_bf16_copy_widths():
    """Row 10 copies 16 bytes (8 bf16) where N % 8 == 0 and every row is
    aligned, else single elements; fp32 keeps 4 floats or 1."""
    assert tmdta.mdta_vec(65536, 0, 256, itemsize=2) == 8
    assert tmdta.mdta_vec(1028, 0, 256, itemsize=2) == 1
    assert tmdta.mdta_vec(80250, 0, itemsize=2) == 1
    assert tmdta.mdta_vec(65536, 0, 8, itemsize=2) == 1
    assert tmdta.mdta_vec(1028, 0, 16) == 4 and tmdta.mdta_vec(1026, 0) == 1
    assert "w32" in tdw.DW_IO


def test_the_bf16_depthwise_plan_takes_its_own_io(monkeypatch):
    """Row 11's bf16 forms plan through dwconv_plan(..., io="w32"):
    bf16 copy widths (8, 4 or 2 bf16), the occupancy of that io, dtaps's
    bands capped at DTAPS_MAX_PIXELS; an odd C, which no bf16 copy divides,
    raises by name."""
    seen = []

    def blocks(device_index, vec, cv, tc, dtaps, io="f32"):
        seen.append((vec, dtaps, io))
        return 3
    monkeypatch.setattr(tdw, "blocks_per_sm", blocks)
    monkeypatch.setattr(tdw, "sm_count", lambda i: 132)
    for c, vec in ((144, 8), (254, 2), (1020, 4)):
        x = torch.empty(3, 64, 64, c, dtype=torch.bfloat16)
        for dtaps in (False, True):
            got = tdw._plan(x, dtaps, 0, 1 << 12)
            cv, tc = tdw.dwconv_tile(c, 64, vec)
            assert got[:3] == (vec, cv, tc) and seen[-1] == (vec, dtaps, "w32")
            assert not dtaps or tc * got[3] <= tdw.DTAPS_MAX_PIXELS
    assert tdw._plan(torch.empty(1, 8, 8, 144), False, 0, 256)[0] == 4
    assert seen[-1][2] == "f32"
    with pytest.raises(ValueError, match="even C"):
        tdw._plan(torch.empty(1, 8, 8, 15, dtype=torch.bfloat16), False, 0, 256)


# ------------------------------------------------------------ one block

@pytest.mark.parametrize("kernels,block_env", [(("off", "mdta", "dwconv"), "0"),
                                               (("head", "gram", "dwconv"), "head")],
                         ids=["off-mdta-dwconv", "head-gram-dwconv"])
def test_one_bf16_block_in_the_opt_in_tiers_matches_jax_pallas(kernels, block_env):
    """A bias-free transformer block (dim 16, two heads of 8 channels, hid
    42) on a bf16 input, forward and VJP for a bf16 cotangent, the fp32
    parameters' gradients too (the dwconv tier's taps fp32 on both sides),
    against transformer_block under the JAX env of the same choice; the
    summed rule of the docstring."""
    composition, core, depthwise = kernels
    dim, heads = 16, 2
    params = init_transformer_block(jax.random.PRNGKey(90), dim, heads, 2.66, bias=False,
                                    ln_bias=True)
    rng = np.random.default_rng(90)
    x = rng.normal(size=(1, 8, 8, dim)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    env = {**PALLAS_ENV, "RCOT_PALLAS_BLOCK": block_env, "RCOT_PALLAS_FUSED": "0",
           "RCOT_PALLAS_DWCONV": "1", **({"RCOT_PALLAS_MDTA": "1"} if core == "mdta" else {})}

    def jax_side(dtype, env):
        with _jax_env(env):
            if env:
                assert jdispatch.block_mode() == composition
            out, (dp, dx) = _strict_vjp(lambda p, x: transformer_block(p, x, heads),
                                        (params, jnp.asarray(x, dtype)),
                                        jnp.asarray(jnp.asarray(cot, BF), dtype))
        grads = {"x": dx}
        jax_params._block(grads, "b", dp)
        return _np(out), {k: _np(v) for k, v in grads.items()}
    out16, want16 = jax_side(BF, env)
    out32, want32 = jax_side(jnp.float32, {})

    sd = {}
    jax_params._block(sd, "b", params)
    block = TransformerBlock(dim, heads, 2.66, bias=False, ln_bias=True)
    block.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                          strict=True)
    block.composition, block.attention_core, block.depthwise = kernels
    named = list(block.named_parameters())
    xt = _bf(x).requires_grad_()
    out = block(xt)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, [xt] + [q for _, q in named], _bf(cot))
    got = {"x": _np(grads[0]), **{f"b.{n}": _np(g) for (n, _), g in zip(named, grads[1:])}}
    assert got.keys() == want16.keys()
    assert grads[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in grads[1:])

    def ratio(pairs):
        err = sum(float(np.abs(g - w16).sum()) for g, w16, _ in pairs)
        gap = sum(float(np.abs(w32 - w16).sum()) for _, w16, w32 in pairs)
        return err / gap
    out_ratio = ratio([(_np(out), out16, out32)])
    grad_ratio = ratio([(got[k], want16[k], want32[k]) for k in got])
    print(f"one bf16 block in {'/'.join(kernels)}: sum|port - JAX| / sum|fp32 - bf16| output "
          f"{out_ratio:.4f}, gradients {grad_ratio:.4f}")
    assert out_ratio <= MODEL_RATIO and grad_ratio <= MODEL_RATIO, (out_ratio, grad_ratio)


# ------------------------------------------------------------ the T_net

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


@pytest.fixture(scope="module")
def served_opt_in(tiny_model_cfg):
    """The tiny T_net's restored 64^2 images of seeds 14 and 63: JAX in bf16
    under off/mdta/dwconv's env, JAX in fp32 (plain path), the port in bf16
    through make_restorer in off/mdta/dwconv, and the port's launches."""
    params = init_tnet(jax.random.PRNGKey(0), tiny_model_cfg)
    sd = tnet_state_dict_from_jax(params, tiny_model_cfg)
    imgs = {s: np.random.default_rng(s).uniform(0, 1, (64, 64, 3)).astype(np.float32)
            for s in (14, 63)}
    outs = {}
    for name, dtype, env in (
            ("bf16", BF, {**PALLAS_ENV, "RCOT_INFER_BLOCK": "off", **OPT_IN_ENV}),
            ("fp32", jnp.float32, {})):
        with _jax_env(env):
            r = _strict_restorer(jinf.make_restorer(params, tiny_model_cfg, dtype=dtype))
            r.buckets = (64,)
            outs[name] = {s: np.asarray(r(img)) for s, img in imgs.items()}
    port = tinf.make_restorer(sd, TModelConfig(**dataclasses.asdict(tiny_model_cfg)),
                              device="cpu", dtype=torch.bfloat16, composition="off",
                              attention_core="mdta", depthwise="dwconv")
    port.buckets = (64,)
    build.reset_launches()
    outs["port"] = {s: port(img) for s, img in imgs.items()}
    return outs, dict(build.LAUNCHES)


@pytest.mark.parametrize("seed", [14, 63])
def test_tiny_tnet_serves_bf16_in_off_mdta_dwconv_as_jax_pallas(served_opt_in, seed):
    """The whole two-pass tiny T_net in bf16 through make_restorer in
    off/mdta/dwconv against the JAX package's make_restorer in bf16 under
    RCOT_INFER_BLOCK=off RCOT_PALLAS_MDTA=1 RCOT_PALLAS_FUSED=0
    RCOT_PALLAS_DWCONV=1: mean|port - JAX bf16| <= MODEL_RATIO * mean|JAX
    fp32 - JAX bf16| (docstring). Its noise_level1 block's heads of 4
    channels take the jnp route, in both packages (two forwards of two
    passes each, one block a pass)."""
    outs, launches = served_opt_in
    got, want16, want32 = outs["port"][seed], outs["bf16"][seed], outs["fp32"][seed]
    assert got.dtype == np.float32 and got.shape == (64, 64, 3)
    assert launches == {"mdta_attend_jnp_bf16": 4}
    gap = float(np.abs(want32 - want16).mean())
    err = float(np.abs(got - want16).mean())
    print(f"tiny T_net served in bf16 off/mdta/dwconv, seed {seed}: mean|port - JAX| "
          f"{err:.3e}, mean|fp32 - bf16| {gap:.3e} ({err / gap:.4f} of the gap)")
    assert gap > 0 and err <= MODEL_RATIO * gap, (err, gap)


# ------------------------------------------------------------ the taps

def test_the_dwconv_tier_takes_fp32_taps_in_serving_and_training(tiny_model_cfg):
    """Serving's bf16 copy for the dwconv tier keeps its depthwise weights
    fp32 (cast_copy), and that tier reads them uncast; the fused tier's copy
    casts them, and the fused tier and the block kernels read the bf16
    weight, as before. In training the taps' gradients reach the fp32
    parameters unrounded."""
    from rcot_torch.models.restormer import _dw_taps
    tcfg = TModelConfig(**dataclasses.asdict(tiny_model_cfg))
    net = TNet(tcfg, device="cpu", seed=3)
    fused, dwconv = (tinf.cast_copy(net, torch.bfloat16, d) for d in ("fused", "dwconv"))
    conv32 = net.encoder_level1[0].attn.qkv_dwconv
    conv16 = fused.encoder_level1[0].attn.qkv_dwconv
    conv = dwconv.encoder_level1[0].attn.qkv_dwconv
    assert conv16.weight.dtype == torch.bfloat16 and torch.equal(conv.weight, conv32.weight)
    assert dwconv.encoder_level1[0].attn.qkv.weight.dtype == torch.bfloat16
    assert torch.equal(_dw_taps(conv, torch.bfloat16, "dwconv"), conv32.weight.view(-1, 3, 3))
    assert torch.equal(_dw_taps(conv16, torch.bfloat16, "fused"), conv16.weight.view(-1, 3, 3))
    assert torch.equal(_dw_taps(conv, torch.bfloat16, "fused"), conv16.weight.view(-1, 3, 3))
    net.composition, net.attention_core, net.depthwise = "tail", "mdta", "dwconv"
    out = net(torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(4)).bfloat16())[0]
    dw = [m.weight for m in net.modules() if getattr(m, "groups", 1) > 1]
    grads = torch.autograd.grad(out.float().square().sum(), dw)
    assert all(g.dtype == torch.float32 for g in grads)
    assert any(not torch.equal(g, g.bfloat16().float()) for g in grads)
