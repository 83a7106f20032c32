"""The port's opt-in attention core and depthwise tier (rcot_torch/ops/mdta.py,
rcot_torch/ops/dwconv.py) and their routing in the T_net, against the JAX
package, on the CPU.

- mdta_attend and dwconv3x3, forward and VJP through their autograd
  Functions (which on the CPU take the plain twins), against the JAX
  package's mdta_attend_pallas and dwconv3x3_pallas with their Pallas
  kernels in interpret mode, under jax.vjp; and dwconv3x3 at a width the
  JAX kernel refuses (W % 8 != 0) against depthwise3x3.
- A T_net with head widths that are multiples of 8 (dim 16, heads
  (1, 1, 2, 2): the JAX MDTA kernel takes its jnp path otherwise) at 64^2
  (the JAX dwconv kernel needs W % 8 == 0 down to the latent), one pass,
  forward,
  against apply_tnet under the JAX env of the port's "off" with the fused
  attend and the standalone depthwise kernel, and of its "tail" with the
  fused attend.
- A tiny T_net (dim 8, one block per level) in every composition x
  attention core x depthwise tier against the plain apply_tnet: the three
  outputs and every parameter's gradient.
- Routing: the CPU path launches nothing, and unknown values of either
  axis raise.

Tolerances (fp32 on both sides, only the order of sums differs): 2e-5
absolute per pixel (outputs, dq, dk, dv, dx); 1e-4 of the largest
magnitude for grads summed over pixels (dtemperature, dtaps). The
model-level comparisons run some forty ops deep and use 1e-4 absolute on
outputs and 1e-4 of each gradient's largest (of 1e-3 where its largest is
smaller: a head's temperature gradient is a sum of terms that cancel).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcot_torch.compat.jax_params import tnet_state_dict_from_jax
from rcot_torch.kernels import build
from rcot_torch.models.restormer import TNet
from rcot_torch.ops import attention as tatt
from rcot_torch.ops import dwconv as tdw
from rcot_torch.ops import gdfn as tgdfn
from rcot_torch.ops import mdta as tmdta
from rcot_torch.ops.conv import depthwise3x3
from rcot_torch.ops.dispatch import (ATTENTION_CORES, COMPOSITIONS, DEPTHWISE,
                                     resolve_attention_core, resolve_composition,
                                     resolve_depthwise)
from rcot_torch.utils.config import ModelConfig as TModelConfig
from rcot_tpu.models.restormer import apply_tnet, init_tnet
from rcot_tpu.ops import dispatch as jdispatch
from rcot_tpu.ops.pallas_dwconv import dwconv3x3_fwd as j_dwconv_fwd
from rcot_tpu.ops.pallas_dwconv import dwconv3x3_pallas as j_dwconv
from rcot_tpu.ops.pallas_mdta import mdta_attend_fused as j_mdta_fused
from rcot_tpu.ops.pallas_mdta import mdta_attend_pallas as j_mdta
from rcot_tpu.utils.config import ModelConfig

PIXEL_ATOL = 2e-5
SUM_RTOL = 1e-4
MODEL_ATOL = 1e-4
GRAD_FLOOR = 1e-3


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads, as tests/test_torch_trainer.py sets them:
    beside busy pytest-xdist workers torch's one thread per core spins."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(name, got, want, per_pixel):
    want = np.asarray(want)
    atol = PIXEL_ATOL if per_pixel else SUM_RTOL * max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=0, err_msg=name)


def _torch_vjp(fn, args, g):
    leaves = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    out = fn(*leaves)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


# ------------------------------------------------------------- the kernels

@pytest.mark.parametrize("c", [8, 24, 48])
@pytest.mark.parametrize("n", [300, 2304], ids=["N300", "N2304"])
def test_mdta_attend_matches_pallas_vjp(c, n):
    """N = 300 is one whole-array chunk of the TPU kernel; 2304 = 18 * 128
    streams in nine chunks of 256."""
    rng = np.random.default_rng(30 + c)
    q, k, v, g = (rng.normal(size=(2, 2, c, n)).astype(np.float32) for _ in range(4))
    temp = rng.uniform(0.5, 2.0, (2, 1, 1)).astype(np.float32)
    args = [jnp.asarray(a) for a in (q, k, v, temp)]
    _, vjp = jax.vjp(lambda *a: j_mdta(*a, True), *args)
    dq, dk, dv, dtemp = vjp(jnp.asarray(g))
    got, grads = _torch_vjp(tmdta.mdta_attend, [q, k, v, temp], g)
    _close("out", got, j_mdta_fused(*args, interpret=True), True)
    for name, a, b in zip(("dq", "dk", "dv"), grads, (dq, dk, dv)):
        _close(name, a, b, True)
    _close("dtemperature", grads[3], dtemp, False)


def _taps(w):
    """(3, 3, C) Pallas taps -> (C, 3, 3) port taps."""
    return np.ascontiguousarray(np.transpose(w, (2, 0, 1)))


@pytest.mark.parametrize("shape", [(2, 16, 16, 48), (1, 8, 16, 254), (3, 32, 16, 96),
                                   (1, 4, 8, 8)], ids=lambda s: "x".join(map(str, s)))
def test_dwconv3x3_matches_pallas_vjp(shape):
    """The JAX kernel test's shapes (tests/test_pallas_dwconv.py): 254
    channels (a GDFN width), non-square."""
    rng = np.random.default_rng(40 + shape[-1])
    x, g = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    w = (rng.normal(size=(3, 3, shape[-1])) * 0.3).astype(np.float32)
    want, vjp = jax.vjp(lambda x, w: j_dwconv(x, w, True), jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))
    _close("fwd_kernel", tdw.dwconv3x3_fwd(torch.from_numpy(x), torch.from_numpy(_taps(w))),
           j_dwconv_fwd(jnp.asarray(x), jnp.asarray(w), interpret=True), True)
    got, grads = _torch_vjp(tdw.dwconv3x3, [x, _taps(w)], g)
    _close("out", got, want, True)
    _close("dx", grads[0], dx, True)
    _close("dtaps", grads[1], _taps(np.asarray(dw)), False)


def test_dwconv3x3_takes_what_the_jax_kernel_refuses():
    """W % 8 != 0 and an odd C: the JAX kernel raises; the port's
    dwconv3x3 matches depthwise3x3 (cuDNN's function), forward and VJP."""
    rng = np.random.default_rng(44)
    x, g = (rng.normal(size=(2, 7, 13, 5)).astype(np.float32) for _ in range(2))
    taps = (rng.normal(size=(5, 3, 3)) * 0.3).astype(np.float32)
    with pytest.raises(ValueError, match="unsupported dwconv shape"):
        j_dwconv_fwd(jnp.asarray(x), jnp.asarray(np.transpose(taps, (1, 2, 0))),
                     interpret=True)
    got, grads = _torch_vjp(tdw.dwconv3x3, [x, taps], g)
    want, want_grads = _torch_vjp(depthwise3x3, [x, taps], g)
    _close("out", got, want, True)
    _close("dx", grads[0], want_grads[0], True)
    _close("dtaps", grads[1], want_grads[1], False)


# ----------------------------------------------------- the model, forward

# one pass (decoder=False): the second pass runs the same blocks again, and
# each block instance costs seconds of interpret-mode tracing
WIDE8 = ModelConfig(dim=16, heads=(1, 1, 2, 2), num_blocks=(1, 1, 1, 1),
                    num_refinement_blocks=1, parity_params=False, decoder=False)
JAX_ENVS = {
    ("off", "mdta", "dwconv"): {"RCOT_PALLAS_BLOCK": "0", "RCOT_PALLAS_MDTA": "1",
                                "RCOT_PALLAS_FUSED": "0", "RCOT_PALLAS_DWCONV": "1"},
    ("tail", "mdta", "fused"): {"RCOT_PALLAS_BLOCK": "tail", "RCOT_PALLAS_MDTA": "1"},
}


def _load(cfg, params, **kernels):
    net = TNet(TModelConfig(**dataclasses.asdict(cfg)), device="cpu", seed=None, **kernels)
    sd = tnet_state_dict_from_jax(params, cfg)
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                        strict=True)
    return net


@pytest.mark.parametrize("kernels", list(JAX_ENVS), ids="-".join)
def test_tnet_matches_jax_pallas_opt_in(monkeypatch, kernels):
    """The JAX model with its Pallas kernels in interpret mode under the
    env of `kernels` against the port in the same composition, attention
    core and depthwise tier, forward. (Gradients through the interpret-mode
    VJPs take minutes to trace; each VJP is held against the port's above.)"""
    params = init_tnet(jax.random.PRNGKey(5), WIDE8)
    x = np.random.default_rng(5).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    monkeypatch.setenv("RCOT_PALLAS", "1")
    monkeypatch.setenv("RCOT_PALLAS_INTERPRET", "1")
    for key, val in JAX_ENVS[kernels].items():
        monkeypatch.setenv(key, val)
    jdispatch.pallas_enabled.cache_clear()
    try:
        assert jdispatch.block_mode() == kernels[0]
        want = jax.jit(lambda p, x: apply_tnet(p, x, WIDE8))(params, jnp.asarray(x))
    finally:
        monkeypatch.undo()
        jdispatch.pallas_enabled.cache_clear()
    net = _load(WIDE8, params, **dict(zip(("composition", "attention_core", "depthwise"),
                                          kernels)))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for name, a, b in zip(("out2", "out1", "res"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=MODEL_ATOL, rtol=0,
                                   err_msg=name)


# --------------------------------------------------- the model, gradients

TINY = ModelConfig(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                   parity_params=False)


@pytest.fixture(scope="module")
def plain_case():
    """The plain apply_tnet (no Pallas: RCOT_PALLAS off on the CPU): outputs
    and every parameter's gradient for one cotangent on the outputs."""
    assert not jdispatch.pallas_enabled()
    params = init_tnet(jax.random.PRNGKey(6), TINY)
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    cots = [rng.normal(size=x.shape).astype(np.float32) for _ in range(3)]

    @jax.jit
    def fwd_bwd(p, x, cots):
        outs, vjp = jax.vjp(lambda p: apply_tnet(p, x, TINY), p)
        return outs, vjp(cots)[0]
    outs, grads = fwd_bwd(params, jnp.asarray(x), tuple(map(jnp.asarray, cots)))
    want = ([np.asarray(o) for o in outs],
            {k: np.asarray(v) for k, v in tnet_state_dict_from_jax(grads, TINY).items()})
    return params, x, cots, want


@pytest.mark.parametrize("kernels", list(itertools.product(COMPOSITIONS, ATTENTION_CORES,
                                                           DEPTHWISE)), ids="-".join)
def test_every_tier_matches_apply_tnet(plain_case, kernels):
    params, x, cots, (w_outs, w_grads) = plain_case
    net = _load(TINY, params, **dict(zip(("composition", "attention_core", "depthwise"),
                                         kernels)))
    before = dict(build.LAUNCHES)
    outs = net(torch.from_numpy(x))
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
    assert dict(build.LAUNCHES) == before  # the CPU path launches nothing
    for name, a, b in zip(("out2", "out1", "res"), outs, w_outs):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=MODEL_ATOL, rtol=0,
                                   err_msg=name)
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    assert set(grads) == set(w_grads)
    for name, gw in w_grads.items():
        np.testing.assert_allclose(grads[name], gw, rtol=0,
                                   atol=SUM_RTOL * max(np.abs(gw).max(), GRAD_FLOOR),
                                   err_msg=name)


# ----------------------------------------------------------------- routing

def test_unknown_values_of_either_axis_raise():
    assert resolve_attention_core("mdta") == "mdta"
    assert resolve_depthwise("dwconv") == "dwconv"
    assert resolve_composition("auto", training=True) == "tail"  # with either core
    with pytest.raises(ValueError, match="attention core"):
        resolve_attention_core("pallas")
    with pytest.raises(ValueError, match="depthwise"):
        resolve_depthwise("shifts")
    cfg = TModelConfig(**dataclasses.asdict(TINY))
    with pytest.raises(ValueError, match="attention core"):
        TNet(cfg, device="cpu", attention_core="attend")
    net = TNet(cfg, device="cpu")
    with pytest.raises(ValueError, match="depthwise"):
        net.depthwise = "dw"
    assert (net.attention_core, net.depthwise) == ("gram", "fused")
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="attention core"):
        tatt.mdta_core(torch.ones(1, 1, 1), torch.zeros(1, 4, 4, 24), 1, "gramm")
    with pytest.raises(ValueError, match="depthwise"):
        tatt.mdta_qkv(x, torch.zeros(24, 8), torch.zeros(24, 3, 3), depthwise="dw")
    with pytest.raises(ValueError, match="depthwise"):
        tgdfn.gdfn(x, torch.zeros(4, 8), torch.zeros(4, 3, 3), torch.zeros(8, 2),
                   depthwise="dw")


def test_the_tiers_propagate_to_every_block():
    net = TNet(TModelConfig(**dataclasses.asdict(TINY)), device="cpu", seed=0,
               composition="off", attention_core="mdta", depthwise="dwconv")
    blocks = [m for m in net.modules() if type(m).__name__ == "TransformerBlock"]
    assert len(blocks) == 15
    assert {(b.composition, b.attention_core, b.depthwise) for b in blocks} == {
        ("off", "mdta", "dwconv")}
    net.attention_core, net.depthwise = "gram", "fused"
    assert {(b.attention_core, b.depthwise) for b in blocks} == {("gram", "fused")}


def test_cpu_kernels_take_the_plain_twins_and_launch_nothing():
    rng = np.random.default_rng(45)
    before = dict(build.LAUNCHES)
    x = torch.from_numpy(rng.normal(size=(1, 4, 5, 6)).astype(np.float32)).requires_grad_()
    y = tdw.dwconv3x3(x, torch.from_numpy(rng.normal(size=(6, 3, 3)).astype(np.float32)))
    q = y.reshape(1, 2, 3, 20)
    out = tmdta.mdta_attend(q, q * 2, q + 1, torch.ones(2, 1, 1))
    out.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert dict(build.LAUNCHES) == before

