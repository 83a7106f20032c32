"""bf16 in the "head" and "off" block compositions, in the port against the
JAX package's, on the CPU: the head backward and the GDFN forward and
backward, kernel by kernel and in one transformer block.

The JAX package runs every block composition in bf16, casting each weight
to the activation's dtype (rcot_tpu/models/restormer.py:58-98,
rcot_tpu/ops/gdfn.py:44-56). Three of its Pallas kernel configurations sit
only on the paths of "full", "head" and "off": fused_block_bwd in the head
configuration (rcot_tpu/ops/pallas_block.py:401, via block_head's VJP) and
fused_dwconv_fwd / fused_dwconv_bwd in the GDFN configuration
(pallas_fused.py:238, :415, via gdfn_fused). Their backward kernels
recompute the forward with its bf16 rounding points and work in fp32 on
the widened values (RCOT_BWD_BF16 unset). The port's plain bf16 twins
(ops/block.py block_head_bwd_bf16_plain, ops/fused.py fused_dwconv_plain
and fused_dwconv_bwd_plain on bf16), which the CUDA kernels of
csrc/block_bwd_bf16.cu and csrc/fused_dwconv_bf16.cu are held against on
the card, are held here against those kernels under jax.vjp in interpret
mode, the JAX side compiled with xla_allow_excess_precision off
(tests/test_torch_bf16.py says why).

Gates, kernel by kernel: each bf16 output equal to JAX's bit for bit in at
least 99% of its entries and every entry within 2^-6 * max(max|JAX|, 1)
(four bf16 ulps of the largest value: the two sides' fp32 sums, taken in
other orders, now and then round a value next to a bf16 boundary apart);
dln_w and dln_b (fp32) within 1e-5 * max(max|JAX|, 1).

One transformer block in "head" and in "off" (RCOT_PALLAS_BLOCK=head, =0),
forward and VJP for a bf16 cotangent, against the port's TransformerBlock
on the same weights: sum|port - JAX bf16| <= MODEL_RATIO * sum|JAX fp32 -
JAX bf16| over the output, and over every gradient together (the input's
and the fp32 parameters'), the fp32 side JAX's plain path.

The tiny T_net served in bf16 in "head", "tail" and "off":
tests/test_torch_bf16_serve_compositions.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcot_torch.compat import jax_params
from rcot_torch.models.restormer import TransformerBlock
from rcot_torch.ops import block as tblock
from rcot_torch.ops import fused as tfused
from rcot_tpu.models.restormer import init_transformer_block, transformer_block
from rcot_tpu.ops import dispatch as jdispatch
from rcot_tpu.ops.pallas_block import block_head as j_block_head
from rcot_tpu.ops.pallas_fused import gdfn_fused as j_gdfn

BF = jnp.bfloat16
STRICT = {"xla_allow_excess_precision": False}
BF16_RTOL = 2.0 ** -6
EQUAL_SHARE = 0.99
F32_RTOL = 1e-5
MODEL_RATIO = 0.75
PALLAS_ENV = {"RCOT_PALLAS": "1", "RCOT_PALLAS_INTERPRET": "1"}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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
    return None if a is None else torch.from_numpy(a).to(torch.bfloat16)


def _jbf(a):
    return None if a is None else jnp.asarray(a, BF)


def _inputs(rng, b, h, w, c, ln_bias):
    hid = int(c * 2.66)
    m = 3 * c
    f = lambda *s, loc=0.0, scale=1.0: rng.normal(loc, scale, s).astype(np.float32)  # noqa: E731
    return dict(
        x=f(b, h, w, c), g_c=f(b, h, w, c), g_m=f(b, h, w, m),
        ln_w=f(c, loc=1.0, scale=0.1), ln_b=f(c, scale=0.1) if ln_bias else None,
        w_qkv=f(m, c, scale=c ** -0.5), dw_qkv=f(m, 3, 3, scale=0.3),
        w_in=f(2 * hid, c, scale=c ** -0.5), dw_in=f(2 * hid, 3, 3, scale=0.3),
        w_out=f(c, hid, scale=hid ** -0.5))


def _taps(dw):
    """(M, 3, 3) torch taps -> (3, 3, M) Pallas taps."""
    return np.transpose(dw, (1, 2, 0))


def _untaps(dw):
    """(3, 3, M) Pallas taps (or their grads) -> (M, 3, 3)."""
    return jnp.transpose(dw, (2, 0, 1))


# ------------------------------------------------------------ the kernels

@pytest.mark.parametrize("c,ln_bias", [(8, True), (24, False)],
                         ids=["M24_WithBias", "M72_BiasFree"])
def test_block_head_bf16_backward_twin_matches_pallas(c, ln_bias):
    """Row 5, head configuration (block_head), under jax.vjp."""
    p = _inputs(np.random.default_rng(60), 2, 6, 5, c, ln_bias)
    ln = [None if p[k] is None else jnp.asarray(p[k]) for k in ("ln_w", "ln_b")]
    if ln_bias:
        fn = lambda *a: j_block_head(*a, interpret=True)  # noqa: E731
        j_args = (_jbf(p["x"]), *ln, _jbf(p["w_qkv"].T), _jbf(_taps(p["dw_qkv"])))
    else:  # a None primal has no cotangent
        fn = lambda x, lw, wq, dw: j_block_head(x, lw, None, wq, dw,  # noqa: E731
                                                interpret=True)
        j_args = (_jbf(p["x"]), ln[0], _jbf(p["w_qkv"].T), _jbf(_taps(p["dw_qkv"])))
    _, grads = _strict_vjp(fn, j_args, _jbf(p["g_m"]))
    if not ln_bias:
        grads = grads[:2] + (None,) + grads[2:]
    dx, dlnw, dlnb, dwq, ddw = grads
    want = (dx, dlnw, dlnb, dwq.T, _untaps(ddw))
    t_ln = [None if p[k] is None else torch.from_numpy(p[k]) for k in ("ln_w", "ln_b")]
    args = (_bf(p["x"]), *t_ln, _bf(p["w_qkv"]), _bf(p["dw_qkv"]))
    got = tblock.block_head_bwd(*args, _bf(p["g_m"]))
    for name, g, w in zip(("dx", "dln_w", "dln_b", "dw_qkv", "ddw"), got, want):
        if w is None:
            assert g is None
            continue
        _check(f"block_head {name}", g, w)


@pytest.mark.parametrize("c", [8, 16], ids=["C8_hid21", "C16_hid42"])
def test_gdfn_bf16_twins_match_pallas(c):
    """Rows 8 and 9, GDFN configuration (gdfn_fused), forward and VJP."""
    p = _inputs(np.random.default_rng(61), 2, 6, 5, c, False)
    out, (dx, dw_in, ddw, dw_out) = _strict_vjp(
        lambda *a: j_gdfn(*a, interpret=True),
        (_jbf(p["x"]), _jbf(p["w_in"].T), _jbf(_taps(p["dw_in"])), _jbf(p["w_out"].T)),
        _jbf(p["g_c"]))
    args = (_bf(p["x"]), _bf(p["w_in"]), _bf(p["dw_in"]), _bf(p["w_out"]))
    _check("gdfn_fused forward", tfused.gdfn_fused(*args), out)
    got = tfused.fused_dwconv_bwd(*args, _bf(p["g_c"]))
    for name, g, w in zip(("dx", "dw_in", "ddw", "dw_out"), got,
                          (dx, dw_in.T, _untaps(ddw), dw_out.T)):
        _check(f"gdfn_fused {name}", g, w)


def test_bf16_head_and_gdfn_workspaces():
    """The workspaces of the bf16 head and GDFN backwards (the kernels'
    order), which hold no fp32 copy of an operand, a weight or an output:
    the head's recomputed u and h (bf16, two to a float), then the LN
    statistics, dh and du (fp32); the GDFN's recomputed h (bf16), then conv
    (which takes dh), dconv and the gate (fp32)."""
    n, c, hid = 3 * 16 * 16, 48, 127
    m = 3 * c
    head = tblock.head_bwd_bf16_workspace_numel(n, c, m)
    assert head == (n * c // 2, n * m // 2, 2 * n, n * m, n * c)
    gdfn = tfused.gdfn_bwd_bf16_workspace_numel(n, c, hid)
    assert gdfn == (n * hid, 2 * n * hid, 2 * n * hid, n * hid)
    assert tfused.gdfn_bwd_bf16_workspace_numel(5, 7, 9)[0] == 45  # an odd count rounds up
    assert tblock.head_bwd_bf16_workspace_numel(5, 7, 21)[:2] == (18, 53)


def test_the_bf16_gdfn_forward_plan_takes_its_gate_as_a_pass():
    """In bf16 the GDFN takes its gate in its depthwise, as the bf16 block
    tail does (csrc/dwconv.cu's gated depthwise, on kdw.conv_gate_plan's
    plan): no gate pass, 0 in the plan's gate-pass int; in fp32 the gate
    stays in the W_out product up to GATE_FUSED_MAX_C and is a pass of its
    own above it."""
    from rcot_torch.ops import dwconv as tdw
    for c in (48, 96):
        dw = tdw.conv_gate_plan(1, 8, 8, 127, 132)
        fp32 = tfused.fused_fwd_plan(1, 8, 8, c, 254, True, 132, (4, 1, 4), (2, 1, 1, 1))
        bf16 = tfused.fused_fwd_plan(1, 8, 8, c, 254, True, 132, (8, 1, 8), dw, bf16=True)
        assert fp32.gate_pass == int(c > tfused.GATE_FUSED_MAX_C) and bf16.gate_pass == 0
        assert bf16.ints()[8:13] == (*dw, 0)
    qkv = tfused.fused_fwd_plan(1, 8, 8, 48, 144, False, 132, (8, 1, 1), (2, 1, 1, 1), bf16=True)
    assert qkv.gate_pass == 0


# ------------------------------------------------------------ one block

@pytest.fixture
def pallas_block_env():
    """Sets the JAX package's Pallas switches (interpret mode) for one
    call: env(composition) -> a context."""
    import contextlib

    @contextlib.contextmanager
    def env(extra):
        keys = {**PALLAS_ENV, "RCOT_PALLAS_BLOCK": ""}
        saved = {k: os.environ.get(k) for k in keys}
        for k in keys:
            os.environ.pop(k, None)
        os.environ.update(extra)
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
    return env


@pytest.mark.parametrize("composition,block_env", [("head", "head"), ("off", "0")])
def test_one_bf16_block_matches_jax_pallas(composition, block_env, pallas_block_env):
    """A bias-free transformer block (dim 8, two heads, hid 21), forward and
    VJP on a bf16 input for a bf16 cotangent, the fp32 parameters'
    gradients too, against the JAX package's transformer_block in the same
    composition with its Pallas kernels (the GDFN's and, in "head", the head's
    configurations among them); the summed rule of the docstring."""
    dim, heads = 8, 2
    params = init_transformer_block(jax.random.PRNGKey(62), dim, heads, 2.66, bias=False,
                                    ln_bias=True)
    rng = np.random.default_rng(62)
    x = rng.normal(size=(1, 8, 8, dim)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)

    def jax_side(dtype, env):
        with pallas_block_env(env):
            if env:
                assert jdispatch.block_mode() == composition
            out, (dp, dx) = _strict_vjp(lambda p, x: transformer_block(p, x, heads),
                                        (params, jnp.asarray(x, dtype)),
                                        jnp.asarray(jnp.asarray(cot, BF), dtype))
        grads = {"x": dx}
        jax_params._block(grads, "b", dp)
        return _np(out), {k: _np(v) for k, v in grads.items()}
    out16, want16 = jax_side(BF, {**PALLAS_ENV, "RCOT_PALLAS_BLOCK": block_env})
    out32, want32 = jax_side(jnp.float32, {})

    sd = {}
    jax_params._block(sd, "b", params)
    block = TransformerBlock(dim, heads, 2.66, bias=False, ln_bias=True)
    block.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                          strict=True)
    block.composition = composition
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
    print(f"one bf16 block in {composition}: sum|port - JAX| / sum|fp32 - bf16| output "
          f"{out_ratio:.4f}, gradients {grad_ratio:.4f}")
    assert out_ratio <= MODEL_RATIO and grad_ratio <= MODEL_RATIO, (out_ratio, grad_ratio)
