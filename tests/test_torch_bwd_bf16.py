"""The backward kernels with bf16 operands (RCOT_BWD_BF16, the port's
`bwd_bf16` / `cli.train --bwd-bf16`) against the JAX package's, on the CPU.

The JAX package rounds both operands of each product inside four of its
backward kernels to bf16 when RCOT_BWD_BF16 names their tier, and sums in
fp32 (rcot_tpu/ops/pallas_fused.py:123-148 _bwd_dot): row 5
(fused_block_bwd, "block", head and tail), rows 6-7 (mdta_gram_bwd and
attn_apply_bwd, "gram") and row 9 (fused_dwconv_bwd, "fused", qkv and
GDFN). The port's plain twins with bf16_ops (ops/block.py _Mm16, the
explicit formulas of ops/gram.py), which the CUDA kernels' `ops16` forms are
held against on the card, are held here against those kernels in interpret
mode, on inputs drawn with numpy from a seed, in fp32 and on bf16
activations. The env is set with monkeypatch and JAX's caches cleared before
each trace: _bwd_dot reads it when the kernel is traced, so a cached fp32
trace would otherwise be compared silently. bf16 activations compile the
JAX side with xla_allow_excess_precision off (tests/test_torch_bf16.py says
why).

Gates, on every output of each case (the gap: mean|JAX fp32 operands - JAX
bf16 operands|, the JAX kernel under RCOT_BWD_BF16 unset and set):
  1. the gap of the case is not zero: the env took effect;
  2. mean|port - JAX bf16 operands| <= gap / 16 (GAP_SHARE), where the
     output's gap is not zero. An output whose gap is exactly zero reaches
     no rounded product (ddw of the head and the qkv configuration, whose
     dconv is g itself) or takes only operands that are bf16 already (the
     bf16 tail's and GDFN's ddw, from the bf16 g and W_out; dattn on a bf16
     qkv) and is held by the bf16 twins' rule, 2^-6 of max(max|JAX|, 1);
  3. max|port - JAX| <= MAX_RTOL * max(max|JAX|, 1) where every operand of
     the products comes straight from the inputs and the output is fp32
     (rows 6-7 in fp32, dattn). Where an operand is an intermediate that
     rounds (rows 5 and 9: dh, dt, the gate) or the output is bf16, an fp32
     ulp of difference now and then rounds a value to the neighbouring
     bf16: a bf16 output moves by one ulp, at most 2^-7 of the largest
     value, and an fp32 one by an ulp of a product's term. The bound is
     MAX_ROUNDED_RTOL = 2^-7 of max(max|JAX|, 1); measured 1.2e-4 at most
     here (the bf16 tail's dw_in; printed with -s), one ulp of a bf16 da
     (2^-5 at 6.3) on the card.
A cross check: the other tiers' names leave a kernel bitwise at its fp32-
operand result, and an unknown tier name is refused.

One block in every composition and the tiny T_net's gradients in "full",
each with every tier on, are in tests/test_torch_bwd_bf16_block.py and
tests/test_torch_bwd_bf16_tnet.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcot_torch.models.restormer import TransformerBlock
from rcot_torch.ops import block as tblock
from rcot_torch.ops import fused as tfused
from rcot_torch.ops import gram as tgram
from rcot_torch.ops.dispatch import BWD_BF16_TIERS, resolve_bwd_bf16
from rcot_tpu.ops.pallas_block import fused_block_bwd as j_block_bwd
from rcot_tpu.ops.pallas_fused import fused_dwconv_bwd as j_fused_bwd
from rcot_tpu.ops.pallas_gram import attn_apply_bwd as j_apply_bwd
from rcot_tpu.ops.pallas_gram import mdta_gram_bwd as j_gram_bwd

BF = jnp.bfloat16
STRICT = {"xla_allow_excess_precision": False}
GAP_SHARE = 1.0 / 16
MAX_RTOL = 1e-5
MAX_ROUNDED_RTOL = 2.0 ** -7
BF16_RTOL = 2.0 ** -6
DTYPES = ["fp32", "bf16"]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax(monkeypatch, fn, args, tiers):
    """fn(*args) compiled with XLA's excess precision off, RCOT_BWD_BF16 =
    tiers (None: unset), traced afresh."""
    if tiers is None:
        monkeypatch.delenv("RCOT_BWD_BF16", raising=False)
    else:
        monkeypatch.setenv("RCOT_BWD_BF16", tiers)
    jax.clear_caches()
    out = jax.jit(fn).lower(*args).compile(STRICT)(*args)
    monkeypatch.delenv("RCOT_BWD_BF16", raising=False)
    return out


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _check_case(tag, got, want16, want32, rounded):
    """The three gates of the docstring on each (name, port, JAX bf16
    operands, JAX fp32 operands) output."""
    gaps = {}
    for name in got:
        g, w16, w32 = _np(got[name]), _np(want16[name]), _np(want32[name])
        assert g.shape == w16.shape, (tag, name, g.shape, w16.shape)
        gap = float(np.abs(w32 - w16).mean())
        mean = float(np.abs(g - w16).mean())
        err = float(np.abs(g - w16).max())
        big = max(float(np.abs(w16).max()), 1.0)
        exact = not rounded and want16[name].dtype != BF
        tol = (MAX_RTOL if exact else MAX_ROUNDED_RTOL) * big
        gaps[name] = gap
        print(f"{tag} {name}: gap {gap:.3e}, mean|port - JAX| {mean:.3e} "
              f"({mean / gap if gap else 0.0:.4f} of it), max {err:.3e} ({err / big:.2e} "
              f"of max|JAX|; gate {tol / big:.1e})")
        if gap == 0.0:
            assert err <= BF16_RTOL * big, (tag, name, err)
            continue
        assert mean <= GAP_SHARE * gap, (tag, name, mean, gap)
        assert err <= tol, (tag, name, err, tol)
    assert sum(gaps.values()) > 0.0, (tag, "RCOT_BWD_BF16 took no effect")


def _inputs(rng, b, h, w, c, hid):
    f = lambda *s, loc=0.0, scale=1.0: rng.normal(loc, scale, s).astype(np.float32)  # noqa: E731
    m = 3 * c
    return dict(x=f(b, h, w, c), a=f(b, h, w, c), g_c=f(b, h, w, c), g_m=f(b, h, w, m),
                ln_w=f(c, loc=1.0, scale=0.1), ln_b=f(c, scale=0.1),
                w_qkv=f(m, c, scale=c ** -0.5), dw_qkv=f(m, 3, 3, scale=0.3),
                w_proj=f(c, c, scale=c ** -0.5), w_in=f(2 * hid, c, scale=c ** -0.5),
                dw_in=f(2 * hid, 3, 3, scale=0.3), w_out=f(c, hid, scale=hid ** -0.5))


def _cast(dtype):
    """(to torch, to JAX) in the case's activation dtype."""
    if dtype == "fp32":
        return torch.from_numpy, jnp.asarray
    return (lambda a: torch.from_numpy(a).to(torch.bfloat16),
            lambda a: jnp.asarray(a, BF))


def _taps(dw):
    """(M, 3, 3) -> the Pallas kernels' (3, 3, M)."""
    return np.ascontiguousarray(np.transpose(dw, (1, 2, 0)))


def _untaps(dw):
    return jnp.transpose(dw, (2, 0, 1))


def _wgrad(d, dtype):
    """A JAX kernel's fp32 weight gradient as its VJP returns it: in the
    weight's dtype (.astype(w.dtype), pallas_block.py:573-578)."""
    return d if dtype == "fp32" else d.astype(BF)


# ---------------------------------------------------------------- row 5

@pytest.mark.parametrize("dtype", DTYPES)
def test_block_tail_bwd_bf16_operands_match_pallas(monkeypatch, dtype):
    """Row 5, tail configuration, RCOT_BWD_BF16=block."""
    p = _inputs(np.random.default_rng(40), 1, 8, 8, 16, 21)
    tt, jj = _cast(dtype)
    ln = (jnp.asarray(p["ln_w"]), jnp.asarray(p["ln_b"]))
    args = (jj(p["x"]), jj(p["a"]), jj(p["w_proj"].T), *ln, jj(p["w_in"].T),
            jj(_taps(p["dw_in"])), jj(p["w_out"].T), jj(p["g_c"]))

    def fn(*a):
        return j_block_bwd(*a, gate=True, residual=True, interpret=True)

    def named(outs):
        dx, da, dwp, dlnw, dlnb, dwin, ddw, dwout = outs
        return dict(dx=dx, da=da, dw_proj=_wgrad(dwp.T, dtype), dln_w=dlnw[0],
                    dln_b=dlnb[0], dw_in=_wgrad(dwin.T, dtype),
                    ddw=_wgrad(_untaps(ddw), dtype), dw_out=_wgrad(dwout.T, dtype))
    want16 = named(_jax(monkeypatch, fn, args, "block"))
    want32 = named(_jax(monkeypatch, fn, args, None))
    t_args = (tt(p["x"]), tt(p["a"]), tt(p["w_proj"]), torch.from_numpy(p["ln_w"]),
              torch.from_numpy(p["ln_b"]), tt(p["w_in"]), tt(p["dw_in"]), tt(p["w_out"]),
              tt(p["g_c"]))
    got = dict(zip(want16, tblock.block_tail_bwd(*t_args, bf16_ops=True)))
    _check_case(f"block_tail {dtype}", got, want16, want32, rounded=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_head_bwd_bf16_operands_match_pallas(monkeypatch, dtype):
    """Row 5, head configuration (no pre-product, no gate, no W_out),
    RCOT_BWD_BF16=block."""
    p = _inputs(np.random.default_rng(41), 1, 8, 8, 16, 21)
    tt, jj = _cast(dtype)
    args = (jj(p["x"]), jnp.asarray(p["ln_w"]), jnp.asarray(p["ln_b"]), jj(p["w_qkv"].T),
            jj(_taps(p["dw_qkv"])), jj(p["g_m"]))

    def fn(x, lw, lb, wq, dk, g):
        return j_block_bwd(x, None, None, lw, lb, wq, dk, None, g, gate=False,
                           residual=False, interpret=True)

    def named(outs):
        dx, _, _, dlnw, dlnb, dwin, ddw, _ = outs
        return dict(dx=dx, dln_w=dlnw[0], dln_b=dlnb[0], dw_qkv=_wgrad(dwin.T, dtype),
                    ddw=_wgrad(_untaps(ddw), dtype))
    want16 = named(_jax(monkeypatch, fn, args, "block"))
    want32 = named(_jax(monkeypatch, fn, args, None))
    t_args = (tt(p["x"]), torch.from_numpy(p["ln_w"]), torch.from_numpy(p["ln_b"]),
              tt(p["w_qkv"]), tt(p["dw_qkv"]), tt(p["g_m"]))
    got = dict(zip(want16, tblock.block_head_bwd(*t_args, bf16_ops=True)))
    _check_case(f"block_head {dtype}", got, want16, want32, rounded=True)


# ---------------------------------------------------------------- row 9

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("config", ["qkv", "gdfn"])
def test_fused_dwconv_bwd_bf16_operands_match_pallas(monkeypatch, config, dtype):
    """Row 9 in both configurations, RCOT_BWD_BF16=fused."""
    p = _inputs(np.random.default_rng(42), 1, 8, 8, 16, 21)
    tt, jj = _cast(dtype)
    gdfn = config == "gdfn"
    w_in, dwk = (p["w_in"], p["dw_in"]) if gdfn else (p["w_qkv"], p["dw_qkv"])
    g = p["g_c"] if gdfn else p["g_m"]
    args = (jj(p["x"]), jj(w_in.T), jj(_taps(dwk)), jj(p["w_out"].T) if gdfn else None, jj(g))

    def fn(x, wi, dk, wo, g):
        return j_fused_bwd(x, wi, dk, wo, g, gate=gdfn, interpret=True)

    def named(outs):
        dx, dwin, ddw, dwout = outs
        d = dict(dx=dx, dw_in=_wgrad(dwin.T, dtype), ddw=_wgrad(_untaps(ddw), dtype))
        if gdfn:
            d["dw_out"] = _wgrad(dwout.T, dtype)
        return d
    want16 = named(_jax(monkeypatch, fn, args, "fused"))
    want32 = named(_jax(monkeypatch, fn, args, None))
    outs = tfused.fused_dwconv_bwd(tt(p["x"]), tt(w_in), tt(dwk),
                                   tt(p["w_out"]) if gdfn else None, tt(g), bf16_ops=True)
    assert (outs[3] is None) != gdfn
    got = dict(zip(want16, outs))
    _check_case(f"fused {config} {dtype}", got, want16, want32, rounded=True)


# ------------------------------------------------------------- rows 6-7

@pytest.mark.parametrize("dtype", DTYPES)
def test_gram_bwd_bf16_operands_match_pallas(monkeypatch, dtype):
    """Rows 6 and 7 (two heads of 8 channels), RCOT_BWD_BF16=gram: every
    operand of their products comes straight from the inputs."""
    rng = np.random.default_rng(43)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    b, h, w, heads, ch = 2, 8, 8, 2, 8
    c = heads * ch
    qkv, g = f(b, h, w, 3 * c), f(b, h, w, c)
    dgram, dnq, dnk = f(b, heads, ch, ch), f(b, heads, ch), f(b, heads, ch)
    attn = np.array(jax.nn.softmax(f(b, heads, ch, ch) * 2.0, axis=-1))
    tt, jj = _cast(dtype)

    def fn(qkv, dgram, dnq, dnk, attn, g):
        return (j_gram_bwd(qkv, dgram, dnq, dnk, heads, interpret=True),
                *j_apply_bwd(qkv, attn, g, interpret=True))

    args = (jj(qkv), jnp.asarray(dgram), jnp.asarray(dnq), jnp.asarray(dnk), jnp.asarray(attn),
            jj(g))
    names = ("dqdk", "dv", "dattn")
    want16 = dict(zip(names, _jax(monkeypatch, fn, args, "gram")))
    want32 = dict(zip(names, _jax(monkeypatch, fn, args, None)))
    t = [torch.from_numpy(a) for a in (dgram, dnq, dnk, attn)]
    got = dict(dqdk=tgram.mdta_gram_bwd(tt(qkv), *t[:3], heads, bf16_ops=True),
               **dict(zip(names[1:], tgram.attn_apply_bwd(tt(qkv), t[3], tt(g),
                                                          bf16_ops=True))))
    _check_case(f"gram {dtype}", got, want16, want32, rounded=False)


# ---------------------------------------------------------- the switch

def test_other_tiers_leave_a_kernel_at_its_fp32_operands(monkeypatch):
    """RCOT_BWD_BF16=fused,gram leaves the block kernel bitwise at its
    fp32-operand result in JAX, and so does the port's tier set in a block
    whose composition runs no kernel of those tiers' ("full" runs the Gram
    core, so "fused" alone)."""
    p = _inputs(np.random.default_rng(44), 1, 8, 8, 16, 21)
    args = (jnp.asarray(p["x"]), jnp.asarray(p["ln_w"]), jnp.asarray(p["ln_b"]),
            jnp.asarray(p["w_qkv"].T), jnp.asarray(_taps(p["dw_qkv"])), jnp.asarray(p["g_m"]))

    def fn(x, lw, lb, wq, dk, g):
        return j_block_bwd(x, None, None, lw, lb, wq, dk, None, g, gate=False,
                           residual=False, interpret=True)
    other = _jax(monkeypatch, fn, args, "fused,gram")
    plain = _jax(monkeypatch, fn, args, None)
    for a, b in zip(other, plain):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    torch.manual_seed(0)
    blk = TransformerBlock(16, 2, 2.66, bias=False, ln_bias=True)
    with torch.no_grad():
        for prm in blk.parameters():
            prm.normal_(0.0, 0.2)
    x = torch.from_numpy(p["x"])
    grads = {}
    for tiers in ("0", "fused", "all"):
        blk.bwd_bf16 = tiers
        leaf = x.clone().requires_grad_()
        out = blk(leaf)
        grads[tiers] = torch.autograd.grad(out, [leaf, *blk.parameters()], torch.ones_like(out))
    for a, b in zip(grads["0"], grads["fused"]):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(grads["0"], grads["all"]))


def test_resolve_bwd_bf16_values_and_refusal():
    assert resolve_bwd_bf16("0") == resolve_bwd_bf16("") == frozenset()
    assert resolve_bwd_bf16("1") == resolve_bwd_bf16("all") == frozenset(BWD_BF16_TIERS)
    assert resolve_bwd_bf16("fused,gram") == {"fused", "gram"}
    assert resolve_bwd_bf16(frozenset({"block"})) == {"block"}
    with pytest.raises(ValueError, match="blok"):
        resolve_bwd_bf16("blok")
    with pytest.raises(ValueError, match="blok"):
        TransformerBlock(8, 1, 2.66, bias=False, ln_bias=True).bwd_bf16 = "block,blok"
