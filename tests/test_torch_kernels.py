"""The port's kernel modules (rcot_torch/ops/block.py, rcot_torch/ops/gram.py).

On the CPU: each plain twin against the Pallas kernel it replaces, run in
interpret mode (called directly, as tests/test_pallas_block.py does), and
against the composed jnp ops. Odd widths on purpose: C = 6 gives M = 3C = 18
and a GDFN hidden width of 15; C = 8 gives hidden 21.

Tolerances: fp32 on both sides, only the order of sums differs: 2e-5 for
the blocks (sums over C and 9 taps), 1e-4 relative for the Gram (sums over
all pixels), 1e-5 for the apply and the whole core.

The CUDA kernels themselves are held against these twins on a card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcot_torch.kernels import build
from rcot_torch.ops import block as tblock
from rcot_torch.ops import gram as tgram
from rcot_torch.ops.attention import mdta_core as t_mdta_core
from rcot_tpu.ops.attention import mdta_attend as j_mdta_attend
from rcot_tpu.ops.pallas_block import block_head as j_block_head
from rcot_tpu.ops.pallas_block import block_tail as j_block_tail
from rcot_tpu.ops.pallas_gram import attn_apply_fwd as j_apply
from rcot_tpu.ops.pallas_gram import mdta_core_gram as j_core_gram
from rcot_tpu.ops.pallas_gram import mdta_gram_fwd as j_gram


def _block_inputs(rng, b, h, w, c, ln_bias):
    hid = int(c * 2.66)
    m = 3 * c
    f = lambda *s, loc=0.0, scale=1.0: rng.normal(loc, scale, s).astype(np.float32)  # noqa: E731
    return dict(
        x=f(b, h, w, c), a=f(b, h, w, c),
        ln_w=f(c, loc=1.0, scale=0.1), ln_b=f(c, scale=0.1) if ln_bias else None,
        w_qkv=f(m, c, scale=c ** -0.5), dw_qkv=f(m, 3, 3, scale=0.3),
        w_proj=f(c, c, scale=c ** -0.5), w_in=f(2 * hid, c, scale=c ** -0.5),
        dw_in=f(2 * hid, 3, 3, scale=0.3), w_out=f(c, hid, scale=hid ** -0.5))


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _taps(dw):
    """(M, 3, 3) torch taps -> (3, 3, M) Pallas taps."""
    return np.transpose(dw, (1, 2, 0))


@pytest.mark.parametrize("c", [6, 8], ids=["M18_hid15", "M24_hid21"])
@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias", "BiasFree"])
def test_block_head_plain_matches_pallas(c, ln_bias):
    p = _block_inputs(np.random.default_rng(0), 2, 6, 5, c, ln_bias)
    want = j_block_head(_j(p["x"]), _j(p["ln_w"]), _j(p["ln_b"]),
                        jnp.asarray(p["w_qkv"].T), jnp.asarray(_taps(p["dw_qkv"])),
                        interpret=True)
    got = tblock.block_head(_t(p["x"]), _t(p["ln_w"]), _t(p["ln_b"]),
                            _t(p["w_qkv"]), _t(p["dw_qkv"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("c", [6, 8], ids=["M18_hid15", "M24_hid21"])
@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias", "BiasFree"])
def test_block_tail_plain_matches_pallas(c, ln_bias):
    p = _block_inputs(np.random.default_rng(1), 2, 6, 5, c, ln_bias)
    want = j_block_tail(_j(p["x"]), _j(p["a"]), jnp.asarray(p["w_proj"].T),
                        _j(p["ln_w"]), _j(p["ln_b"]), jnp.asarray(p["w_in"].T),
                        jnp.asarray(_taps(p["dw_in"])), jnp.asarray(p["w_out"].T),
                        interpret=True)
    got = tblock.block_tail(*(_t(p[k]) for k in ("x", "a", "w_proj", "ln_w", "ln_b",
                                                  "w_in", "dw_in", "w_out")))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("heads,ch", [(1, 8), (2, 6), (4, 5)])
def test_gram_and_apply_plain_match_pallas(heads, ch):
    rng = np.random.default_rng(2)
    c = heads * ch
    qkv = rng.normal(size=(2, 6, 7, 3 * c)).astype(np.float32)
    g, nq, nk = tgram.mdta_gram_fwd(_t(qkv), heads)
    jg, jq, jk = j_gram(jnp.asarray(qkv), heads, interpret=True)
    for got, want in ((g, jg), (nq, jq), (nk, jk)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    attn = torch.softmax(torch.from_numpy(rng.normal(size=(2, heads, ch, ch))
                                          .astype(np.float32)), -1)
    got = tgram.attn_apply_fwd(_t(qkv), attn)
    want = j_apply(jnp.asarray(qkv), jnp.asarray(attn.numpy()), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("heads,ch", [(1, 8), (2, 6), (4, 5)])
def test_mdta_core_gram_matches_pallas_and_attend(heads, ch):
    rng = np.random.default_rng(3)
    c = heads * ch
    qkv = rng.normal(size=(1, 5, 9, 3 * c)).astype(np.float32)
    temp = rng.uniform(0.5, 2.0, (heads, 1, 1)).astype(np.float32)
    got = tgram.mdta_core_gram(_t(temp), _t(qkv), heads).numpy()
    want = j_core_gram(jnp.asarray(temp), jnp.asarray(qkv), heads, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    # the transpose formulation: jnp mdta_attend and the port's mdta_core
    parts = np.transpose(qkv.reshape(1, 45, 3, heads, ch), (2, 0, 3, 4, 1))
    att = np.asarray(j_mdta_attend(*(jnp.asarray(a) for a in parts), jnp.asarray(temp)))
    want2 = np.transpose(att, (0, 3, 1, 2)).reshape(1, 5, 9, c)
    np.testing.assert_allclose(got, want2, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_mdta_core(_t(temp), _t(qkv), heads).numpy(), want2,
                               atol=1e-5, rtol=0)


def test_cpu_tensors_take_the_plain_twin_and_launch_nothing():
    p = _block_inputs(np.random.default_rng(4), 1, 4, 4, 6, True)
    before = dict(build.LAUNCHES)
    qkv = tblock.block_head(_t(p["x"]), _t(p["ln_w"]), _t(p["ln_b"]),
                            _t(p["w_qkv"]), _t(p["dw_qkv"]))
    torch.testing.assert_close(qkv, tblock.block_head_plain(
        _t(p["x"]), _t(p["ln_w"]), _t(p["ln_b"]), _t(p["w_qkv"]), _t(p["dw_qkv"])),
        rtol=0, atol=0)
    tgram.mdta_core_gram(torch.ones(2, 1, 1), qkv, 2)
    assert dict(build.LAUNCHES) == before
