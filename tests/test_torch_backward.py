"""The port's backward: block head, block tail and the MDTA core, on the CPU.

- Grads through the autograd Functions (rcot_torch/ops/block.py BlockHead,
  BlockTail; rcot_torch/ops/gram.py MdtaCore), which on the CPU take the
  plain twins, against jax.vjp of the JAX package's custom-VJP functions
  with their Pallas kernels in interpret mode (fused_block_bwd,
  mdta_gram_bwd, attn_apply_bwd). This pins the Functions' wiring:
  argument order, weight layouts, which grads come back.
- Each plain backward twin against the Pallas backward kernel it replaces,
  called directly in interpret mode.

Odd widths on purpose: C = 6 gives M = 18 and a GDFN hidden width of 15,
C = 8 gives 24 and 21. The JAX weights are (in, out) and (3, 3, M); the
port's (out, in) and (M, 3, 3), so the comparisons transpose.

Tolerances (fp32 on both sides, only the order of sums differs): 2e-5
absolute for per-pixel grads (dx, da, dqkv, dv, d[q|k]); 1e-4 of the
largest magnitude for grads summed over pixels (weights, LN, dattn,
dtemperature).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcot_torch.kernels import build
from rcot_torch.ops import block as tblock
from rcot_torch.ops import gram as tgram
from rcot_tpu.ops.pallas_block import block_head as j_block_head
from rcot_tpu.ops.pallas_block import block_tail as j_block_tail
from rcot_tpu.ops.pallas_block import fused_block_bwd as j_fused_block_bwd
from rcot_tpu.ops.pallas_gram import attn_apply_bwd as j_apply_bwd
from rcot_tpu.ops.pallas_gram import mdta_core_gram as j_core_gram
from rcot_tpu.ops.pallas_gram import mdta_gram_bwd as j_gram_bwd

PIXEL_ATOL = 2e-5
SUM_RTOL = 1e-4


def _block_inputs(rng, b, h, w, c, ln_bias):
    hid = int(c * 2.66)
    m = 3 * c
    f = lambda *s, loc=0.0, scale=1.0: rng.normal(loc, scale, s).astype(np.float32)  # noqa: E731
    return dict(
        x=f(b, h, w, c), a=f(b, h, w, c),
        ln_w=f(c, loc=1.0, scale=0.1), ln_b=f(c, scale=0.1) if ln_bias else None,
        w_qkv=f(m, c, scale=c ** -0.5), dw_qkv=f(m, 3, 3, scale=0.3),
        w_proj=f(c, c, scale=c ** -0.5), w_in=f(2 * hid, c, scale=c ** -0.5),
        dw_in=f(2 * hid, 3, 3, scale=0.3), w_out=f(c, hid, scale=hid ** -0.5),
        g_head=f(b, h, w, m), g_tail=f(b, h, w, c))


def _taps(dw):
    """(M, 3, 3) port taps <-> (3, 3, M) Pallas taps."""
    return np.transpose(dw, (1, 2, 0))


def _untaps(dw):
    return np.transpose(np.asarray(dw), (2, 0, 1))


def _jax_vjp(fn, args, g):
    """Grads of fn(*args) for the cotangent g; None arguments stay None."""
    live = [i for i, a in enumerate(args) if a is not None]

    def f(*vals):
        full = list(args)
        for i, v in zip(live, vals):
            full[i] = v
        return fn(*full)
    _, vjp = jax.vjp(f, *(jnp.asarray(args[i]) for i in live))
    out = [None] * len(args)
    for i, gr in zip(live, vjp(jnp.asarray(g))):
        out[i] = np.asarray(gr)
    return out


def _torch_grads(fn, args, g):
    """Grads of fn(*args) for the cotangent g by torch.autograd."""
    leaves = [None if a is None else torch.from_numpy(np.array(a)).requires_grad_()
              for a in args]
    fn(*leaves).backward(torch.from_numpy(g))
    return [None if t is None else t.grad.numpy() for t in leaves]


def _close(name, got, want, per_pixel):
    if want is None:
        assert got is None, name
        return
    want = np.asarray(want)
    atol = PIXEL_ATOL if per_pixel else SUM_RTOL * max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=0, err_msg=name)


C_CASES = pytest.mark.parametrize("c", [6, 8], ids=["M18_hid15", "M24_hid21"])
LN_CASES = pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias", "BiasFree"])


@C_CASES
@LN_CASES
def test_block_head_grads_match_jax_vjp(c, ln_bias):
    p = _block_inputs(np.random.default_rng(10), 2, 6, 5, c, ln_bias)
    want = _jax_vjp(lambda *a: j_block_head(*a, interpret=True),
                    [p["x"], p["ln_w"], p["ln_b"], p["w_qkv"].T, _taps(p["dw_qkv"])],
                    p["g_head"])
    got = _torch_grads(tblock.block_head,
                       [p["x"], p["ln_w"], p["ln_b"], p["w_qkv"], p["dw_qkv"]],
                       p["g_head"])
    _close("dx", got[0], want[0], True)
    _close("dln_w", got[1], want[1], False)
    _close("dln_b", got[2], want[2], False)
    _close("dw_qkv", got[3], want[3].T, False)
    _close("ddw", got[4], _untaps(want[4]), False)


@C_CASES
@LN_CASES
def test_block_tail_grads_match_jax_vjp(c, ln_bias):
    p = _block_inputs(np.random.default_rng(11), 2, 6, 5, c, ln_bias)
    want = _jax_vjp(lambda *a: j_block_tail(*a, interpret=True),
                    [p["x"], p["a"], p["w_proj"].T, p["ln_w"], p["ln_b"],
                     p["w_in"].T, _taps(p["dw_in"]), p["w_out"].T], p["g_tail"])
    got = _torch_grads(tblock.block_tail,
                       [p[k] for k in ("x", "a", "w_proj", "ln_w", "ln_b", "w_in",
                                       "dw_in", "w_out")], p["g_tail"])
    _close("dx", got[0], want[0], True)
    _close("da", got[1], want[1], True)
    _close("dw_proj", got[2], want[2].T, False)
    _close("dln_w", got[3], want[3], False)
    _close("dln_b", got[4], want[4], False)
    _close("dw_in", got[5], want[5].T, False)
    _close("ddw", got[6], _untaps(want[6]), False)
    _close("dw_out", got[7], want[7].T, False)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@C_CASES
@LN_CASES
def test_block_head_bwd_plain_matches_fused_block_bwd(c, ln_bias):
    p = _block_inputs(np.random.default_rng(12), 2, 6, 5, c, ln_bias)
    outs = j_fused_block_bwd(_j(p["x"]), None, None, _j(p["ln_w"]), _j(p["ln_b"]),
                             jnp.asarray(p["w_qkv"].T), jnp.asarray(_taps(p["dw_qkv"])),
                             None, jnp.asarray(p["g_head"]), gate=False, residual=False,
                             interpret=True)
    dx, _, _, dlnw, dlnb, dwin, ddw, _ = (np.asarray(o) for o in outs)
    got = tblock.block_head_bwd(*(_t(p[k]) for k in ("x", "ln_w", "ln_b", "w_qkv",
                                                     "dw_qkv", "g_head")))
    _close("dx", got[0], dx, True)
    _close("dln_w", got[1], dlnw[0], False)
    _close("dln_b", got[2], dlnb[0] if ln_bias else None, False)
    _close("dw_qkv", got[3], dwin.T, False)
    _close("ddw", got[4], _untaps(ddw), False)


@C_CASES
@LN_CASES
def test_block_tail_bwd_plain_matches_fused_block_bwd(c, ln_bias):
    p = _block_inputs(np.random.default_rng(13), 2, 6, 5, c, ln_bias)
    outs = j_fused_block_bwd(_j(p["x"]), _j(p["a"]), jnp.asarray(p["w_proj"].T),
                             _j(p["ln_w"]), _j(p["ln_b"]), jnp.asarray(p["w_in"].T),
                             jnp.asarray(_taps(p["dw_in"])), jnp.asarray(p["w_out"].T),
                             jnp.asarray(p["g_tail"]), gate=True, residual=True,
                             interpret=True)
    dx, da, dwpre, dlnw, dlnb, dwin, ddw, dwout = (np.asarray(o) for o in outs)
    got = tblock.block_tail_bwd(*(_t(p[k]) for k in ("x", "a", "w_proj", "ln_w", "ln_b",
                                                     "w_in", "dw_in", "w_out", "g_tail")))
    _close("dx", got[0], dx, True)
    _close("da", got[1], da, True)
    _close("dw_proj", got[2], dwpre.T, False)
    _close("dln_w", got[3], dlnw[0], False)
    _close("dln_b", got[4], dlnb[0] if ln_bias else None, False)
    _close("dw_in", got[5], dwin.T, False)
    _close("ddw", got[6], _untaps(ddw), False)
    _close("dw_out", got[7], dwout.T, False)


HEAD_CASES = pytest.mark.parametrize("heads,ch", [(1, 8), (2, 6), (4, 5)])


@HEAD_CASES
def test_mdta_core_grads_match_jax_vjp(heads, ch):
    rng = np.random.default_rng(14)
    c = heads * ch
    qkv = rng.normal(size=(2, 5, 7, 3 * c)).astype(np.float32)
    temp = rng.uniform(0.5, 2.0, (heads, 1, 1)).astype(np.float32)
    g = rng.normal(size=(2, 5, 7, c)).astype(np.float32)
    want_temp, want_qkv = _jax_vjp(
        lambda t, q: j_core_gram(t, q, heads, interpret=True), [temp, qkv], g)
    got_temp, got_qkv = _torch_grads(
        lambda t, q: tgram.mdta_core_gram(t, q, heads), [temp, qkv], g)
    _close("dqkv", got_qkv, want_qkv, True)
    _close("dtemperature", got_temp, want_temp, False)


@HEAD_CASES
def test_gram_bwd_plain_twins_match_pallas(heads, ch):
    rng = np.random.default_rng(15)
    c = heads * ch
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    qkv, dgram, dnq, dnk = f(2, 6, 7, 3 * c), f(2, heads, ch, ch), f(2, heads, ch), f(2, heads, ch)
    want = j_gram_bwd(*(jnp.asarray(a) for a in (qkv, dgram, dnq, dnk)), heads,
                      interpret=True)
    got = tgram.mdta_gram_bwd(*(_t(a) for a in (qkv, dgram, dnq, dnk)), heads)
    _close("d[q|k]", got.numpy(), want, True)
    attn = torch.softmax(torch.from_numpy(f(2, heads, ch, ch)), -1).numpy()
    g = f(2, 6, 7, c)
    want_dv, want_dattn = j_apply_bwd(jnp.asarray(qkv), jnp.asarray(attn), jnp.asarray(g),
                                      interpret=True)
    got_dv, got_dattn = tgram.attn_apply_bwd(_t(qkv), _t(attn), _t(g))
    _close("dv", got_dv.numpy(), want_dv, True)
    _close("dattn", got_dattn.numpy(), want_dattn, False)


def test_cpu_backward_takes_the_plain_twins_and_launches_nothing():
    p = _block_inputs(np.random.default_rng(16), 1, 4, 4, 6, True)
    before = dict(build.LAUNCHES)
    x = _t(p["x"]).requires_grad_()
    qkv = tblock.block_head(x, *(_t(p[k]) for k in ("ln_w", "ln_b", "w_qkv", "dw_qkv")))
    a = tgram.mdta_core_gram(torch.ones(2, 1, 1), qkv, 2)
    y = tblock.block_tail(x, a, *(_t(p[k]) for k in ("w_proj", "ln_w", "ln_b", "w_in",
                                                      "dw_in", "w_out")))
    # a strided cotangent, as torch.cat's backward hands a block
    torch.cat([y, y], dim=-1).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert dict(build.LAUNCHES) == before
