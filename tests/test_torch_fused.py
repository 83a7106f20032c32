"""The port's fused dwconv tier (rcot_torch/ops/fused.py) and the four block
compositions of its T_net, against the JAX package, on the CPU.

- conv1x1_dw_fused and gdfn_fused, forward and VJP through the autograd
  Function (which on the CPU takes the plain twins), against the JAX
  package's conv1x1_dw_fused / gdfn_fused with their Pallas kernels in
  interpret mode, under jax.vjp; and each plain backward twin against the
  Pallas backward kernel fused_dwconv_bwd called directly. C = 8 gives
  M = 24 and h = int(8 * 2.66) = 21, so 2h = 42 with an odd gate half;
  C = 6 gives 18 and 15.
- A tiny T_net (dim 8, one block per level) in each of the compositions
  full, head, tail and off against apply_tnet: the three outputs, and
  every parameter's gradient for one cotangent on them.
- The JAX model in its own training default, RCOT_PALLAS=1 with the Pallas
  kernels in interpret mode and RCOT_PALLAS_BLOCK=tail, against the port's
  "tail" composition, forward.

Tolerances (fp32 on both sides, only the order of sums differs): 2e-5
absolute per pixel (outputs, dx); 1e-4 of the largest magnitude for grads
summed over pixels (weights). The Pallas gelu's erf is the
Abramowitz-Stegun polynomial (|error| < 1.5e-7); the port's is exact, a
difference far inside both. The model-level comparisons run some forty ops
deep and use 1e-4 absolute on outputs and 1e-4 of each gradient's largest
(of 1e-3 where its largest is smaller; GRAD_FLOOR says why).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcot_torch.compat.jax_params import tnet_state_dict_from_jax
from rcot_torch.kernels import build
from rcot_torch.models.restormer import TNet
from rcot_torch.ops import fused as tfused
from rcot_torch.ops.dispatch import COMPOSITIONS, resolve_composition
from rcot_torch.utils.config import ModelConfig as TModelConfig
from rcot_tpu.models.restormer import apply_tnet, init_tnet
from rcot_tpu.ops import dispatch as jdispatch
from rcot_tpu.ops.pallas_fused import conv1x1_dw_fused as j_conv1x1_dw
from rcot_tpu.ops.pallas_fused import fused_dwconv_bwd as j_fused_bwd
from rcot_tpu.ops.pallas_fused import gdfn_fused as j_gdfn
from rcot_tpu.utils.config import ModelConfig

PIXEL_ATOL = 2e-5
SUM_RTOL = 1e-4
MODEL_ATOL = 1e-4
# a gradient whose entries all lie below this is a sum of terms that
# cancel (a head's temperature: ~1e-3 terms over every pixel), and carries
# the absolute error of those sums, ~1e-8
GRAD_FLOOR = 1e-3


def _inputs(rng, b, h, w, c):
    hid = int(c * 2.66)
    f = lambda *s, scale=1.0: (rng.normal(0, scale, s)).astype(np.float32)  # noqa: E731
    return dict(x=f(b, h, w, c), w_qkv=f(3 * c, c, scale=c ** -0.5),
                dw_qkv=f(3 * c, 3, 3, scale=0.3), w_in=f(2 * hid, c, scale=c ** -0.5),
                dw_in=f(2 * hid, 3, 3, scale=0.3), w_out=f(c, hid, scale=hid ** -0.5),
                g_qkv=f(b, h, w, 3 * c), g=f(b, h, w, c))


def _taps(dw):
    """(M, 3, 3) port taps -> (3, 3, M) Pallas taps."""
    return np.transpose(dw, (1, 2, 0))


def _untaps(dw):
    return np.transpose(np.asarray(dw), (2, 0, 1))


def _close(name, got, want, per_pixel):
    want = np.asarray(want)
    atol = PIXEL_ATOL if per_pixel else SUM_RTOL * max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=0, err_msg=name)


def _torch_vjp(fn, args, g):
    leaves = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    out = fn(*leaves)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


C_CASES = pytest.mark.parametrize("c", [6, 8], ids=["M18_hid15", "M24_hid21"])


@C_CASES
def test_conv1x1_dw_fused_matches_pallas_vjp(c):
    p = _inputs(np.random.default_rng(20), 2, 6, 5, c)
    args = [jnp.asarray(p["x"]), jnp.asarray(p["w_qkv"].T), jnp.asarray(_taps(p["dw_qkv"]))]
    want, vjp = jax.vjp(lambda *a: j_conv1x1_dw(*a, interpret=True), *args)
    dx, dw_in, ddw = vjp(jnp.asarray(p["g_qkv"]))
    got, grads = _torch_vjp(tfused.conv1x1_dw_fused, [p["x"], p["w_qkv"], p["dw_qkv"]],
                            p["g_qkv"])
    _close("qkv", got, want, True)
    _close("dx", grads[0], dx, True)
    _close("dw_in", grads[1], np.asarray(dw_in).T, False)
    _close("ddw", grads[2], _untaps(ddw), False)


@C_CASES
def test_gdfn_fused_matches_pallas_vjp(c):
    p = _inputs(np.random.default_rng(21), 2, 6, 5, c)
    args = [jnp.asarray(p["x"]), jnp.asarray(p["w_in"].T), jnp.asarray(_taps(p["dw_in"])),
            jnp.asarray(p["w_out"].T)]
    want, vjp = jax.vjp(lambda *a: j_gdfn(*a, interpret=True), *args)
    dx, dw_in, ddw, dw_out = vjp(jnp.asarray(p["g"]))
    got, grads = _torch_vjp(tfused.gdfn_fused,
                            [p["x"], p["w_in"], p["dw_in"], p["w_out"]], p["g"])
    _close("y", got, want, True)
    _close("dx", grads[0], dx, True)
    _close("dw_in", grads[1], np.asarray(dw_in).T, False)
    _close("ddw", grads[2], _untaps(ddw), False)
    _close("dw_out", grads[3], np.asarray(dw_out).T, False)


@C_CASES
@pytest.mark.parametrize("gdfn", [False, True], ids=["qkv", "gdfn"])
def test_bwd_plain_matches_fused_dwconv_bwd(c, gdfn):
    """The Pallas backward kernel called directly, without the wrapper's
    gate-half padding: hid odd and unpadded is within what it takes."""
    p = _inputs(np.random.default_rng(22), 2, 8, 5, c)
    if gdfn:
        w_in, dwk, w_out, g = p["w_in"], p["dw_in"], p["w_out"], p["g"]
    else:
        w_in, dwk, w_out, g = p["w_qkv"], p["dw_qkv"], None, p["g_qkv"]
    dx, dw_in, ddw, dw_out = j_fused_bwd(
        jnp.asarray(p["x"]), jnp.asarray(w_in.T), jnp.asarray(_taps(dwk)),
        None if w_out is None else jnp.asarray(w_out.T), jnp.asarray(g),
        gate=gdfn, interpret=True)
    got = tfused.fused_dwconv_bwd(*(None if a is None else torch.from_numpy(a)
                                    for a in (p["x"], w_in, dwk, w_out, g)))
    _close("dx", got[0].numpy(), dx, True)
    _close("dw_in", got[1].numpy(), np.asarray(dw_in).T, False)
    _close("ddw", got[2].numpy(), _untaps(ddw), False)
    if gdfn:
        _close("dw_out", got[3].numpy(), np.asarray(dw_out).T, False)
    else:
        assert got[3] is None


def test_cpu_fused_takes_the_plain_twins_and_launches_nothing():
    p = _inputs(np.random.default_rng(23), 1, 4, 4, 8)
    before = dict(build.LAUNCHES)
    x = torch.from_numpy(p["x"]).requires_grad_()
    qkv = tfused.conv1x1_dw_fused(x, *(torch.from_numpy(p[k]) for k in ("w_qkv", "dw_qkv")))
    y = tfused.gdfn_fused(qkv[..., :8], *(torch.from_numpy(p[k])
                                          for k in ("w_in", "dw_in", "w_out")))
    # a strided cotangent, as torch.cat's backward hands a block
    torch.cat([y, y], dim=-1).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert dict(build.LAUNCHES) == before


def test_resolve_composition():
    assert resolve_composition("auto", training=True) == "tail"
    assert resolve_composition("auto", training=False) == "full"
    for mode in COMPOSITIONS:
        assert resolve_composition(mode, training=True) == mode
    with pytest.raises(ValueError, match="composition"):
        resolve_composition("1", training=True)
    with pytest.raises(ValueError, match="composition"):
        TNet(TModelConfig(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                          parity_params=False), device="cpu", composition="fused")


# ------------------------------------------------------------- the model

TINY = ModelConfig(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                   parity_params=False)


def _model_case(seed, shape):
    params = init_tnet(jax.random.PRNGKey(seed), TINY)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    cots = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    return params, x, cots


def _jax_model(params, x, cots):
    @jax.jit
    def fwd_bwd(p, x, cots):
        outs, vjp = jax.vjp(lambda p: apply_tnet(p, x, TINY), p)
        return outs, vjp(cots)[0]
    outs, grads = fwd_bwd(params, jnp.asarray(x), tuple(jnp.asarray(c) for c in cots))
    sd = tnet_state_dict_from_jax(grads, TINY)
    return [np.asarray(o) for o in outs], {k: np.asarray(v) for k, v in sd.items()}


def _port_model(params, x, cots, composition):
    net = TNet(TModelConfig(**dataclasses.asdict(TINY)), device="cpu", seed=None,
               composition=composition)
    sd = tnet_state_dict_from_jax(params, TINY)
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                        strict=True)
    outs = net(torch.from_numpy(x))
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
    return ([o.detach().numpy() for o in outs],
            {n: p.grad.numpy() for n, p in net.named_parameters()})


def _assert_model_close(got, want):
    (g_outs, g_grads), (w_outs, w_grads) = got, want
    for name, a, b in zip(("out2", "out1", "res"), g_outs, w_outs):
        np.testing.assert_allclose(a, b, atol=MODEL_ATOL, rtol=0, err_msg=name)
    assert set(g_grads) == set(w_grads)
    for name, gw in w_grads.items():
        np.testing.assert_allclose(g_grads[name], gw, rtol=0,
                                   atol=SUM_RTOL * max(np.abs(gw).max(), GRAD_FLOOR),
                                   err_msg=name)


@pytest.fixture(scope="module")
def model_case():
    params, x, cots = _model_case(3, (2, 16, 16, 3))
    return params, x, cots, _jax_model(params, x, cots)


@pytest.mark.parametrize("composition", COMPOSITIONS)
def test_tnet_compositions_match_apply_tnet(model_case, composition):
    params, x, cots, want = model_case
    _assert_model_close(_port_model(params, x, cots, composition), want)


def test_tnet_tail_matches_jax_pallas_tail(monkeypatch):
    """The JAX model as its trainer runs it by default (Pallas kernels,
    block mode "tail": LN1 + conv1x1_dw_fused, the Gram core, block_tail)
    against the port's "tail", forward. (Its gradients through the Pallas
    VJPs take minutes to trace in interpret mode; each of those VJPs is
    held against the port's op by op above and in test_torch_backward.py.)"""
    params, x, cots = _model_case(4, (1, 16, 16, 3))
    monkeypatch.setenv("RCOT_PALLAS", "1")
    monkeypatch.setenv("RCOT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RCOT_PALLAS_BLOCK", "tail")
    jdispatch.pallas_enabled.cache_clear()
    try:
        assert jdispatch.block_mode() == "tail"
        want = jax.jit(lambda p, x: apply_tnet(p, x, TINY))(params, jnp.asarray(x))
    finally:
        monkeypatch.undo()
        jdispatch.pallas_enabled.cache_clear()
    got, _ = _port_model(params, x, cots, "tail")
    for name, a, b in zip(("out2", "out1", "res"), got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=MODEL_ATOL, rtol=0, err_msg=name)
