"""The port's plain ops (rcot_torch/ops, rcot_torch/metrics) against their
JAX counterparts on the same numpy inputs, on the CPU.

Tolerance: fp32 on both sides with the same algorithm; only the order of
sums differs, so atol 1e-5 at these O(1) magnitudes.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcot_torch.metrics import quality as tq
from rcot_torch.ops import attention as tatt
from rcot_torch.ops import conv as tconv
from rcot_torch.ops import gdfn as tgdfn
from rcot_torch.ops import layernorm as tln
from rcot_torch.ops import resample as trs

# rcot_tpu.ops re-exports functions under its modules' names, so the JAX
# modules are taken from the import system rather than as attributes
jq, jatt, jconv, jgdfn, jln, jrs = (
    importlib.import_module(f"rcot_tpu.{m}")
    for m in ("metrics.quality", "ops.attention", "ops.conv", "ops.gdfn",
              "ops.layernorm", "ops.resample"))

ATOL = 1e-5


def _hwio(w):
    """torch OIHW -> JAX HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


@pytest.fixture
def nrng():
    return np.random.default_rng(1234)


@pytest.mark.parametrize("with_bias", [True, False], ids=["WithBias", "BiasFree"])
def test_layernorm(nrng, with_bias):
    x = nrng.normal(0.5, 2.0, (2, 5, 6, 12)).astype(np.float32)
    w = nrng.normal(1.0, 0.1, 12).astype(np.float32)
    b = nrng.normal(0.0, 0.1, 12).astype(np.float32) if with_bias else None
    p = {"w": jnp.asarray(w)} if b is None else {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    want = jln.layernorm(p, jnp.asarray(x))
    got = tln.layernorm(torch.from_numpy(x), torch.from_numpy(w),
                        None if b is None else torch.from_numpy(b))
    _close(got, want)


@pytest.mark.parametrize("k,groups,bias", [(3, 1, True), (1, 1, False), (3, 6, False)],
                         ids=["conv3x3_bias", "conv1x1", "depthwise3x3"])
def test_conv2d(nrng, k, groups, bias):
    x = nrng.normal(size=(2, 7, 9, 6)).astype(np.float32)
    cout = 6 if groups > 1 else 5
    w = nrng.normal(0, 0.3, (cout, 6 // groups, k, k)).astype(np.float32)
    b = nrng.normal(0, 0.1, cout).astype(np.float32) if bias else None
    p = {"w": jnp.asarray(_hwio(w))}
    if b is not None:
        p["b"] = jnp.asarray(b)
    want = jconv.conv2d(p, jnp.asarray(x), groups=groups)
    tb = None if b is None else torch.from_numpy(b)
    got = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w), tb, groups=groups)
    _close(got, want)
    if groups > 1:
        _close(tconv.depthwise3x3(torch.from_numpy(x), torch.from_numpy(w)), want)
    if k == 1:
        _close(tconv.conv1x1(torch.from_numpy(x), torch.from_numpy(w)), want)


def test_pixel_shuffle_roundtrip_order(nrng):
    x = nrng.normal(size=(2, 4, 6, 12)).astype(np.float32)
    _close(trs.pixel_unshuffle(torch.from_numpy(x)), jrs.pixel_unshuffle(jnp.asarray(x)), 0)
    _close(trs.pixel_shuffle(torch.from_numpy(x)), jrs.pixel_shuffle(jnp.asarray(x)), 0)
    # torch's own NCHW pixel_unshuffle defines the channel order
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    ref = torch.nn.functional.pixel_unshuffle(nchw, 2).permute(0, 2, 3, 1)
    _close(trs.pixel_unshuffle(torch.from_numpy(x)), ref.numpy(), 0)


@pytest.mark.parametrize("down", [True, False], ids=["downsample", "upsample"])
def test_resample(nrng, down):
    x = nrng.normal(size=(1, 8, 8, 8)).astype(np.float32)
    cout = 4 if down else 16
    w = nrng.normal(0, 0.2, (cout, 8, 3, 3)).astype(np.float32)
    p = {"conv": {"w": jnp.asarray(_hwio(w))}}
    jfn, tfn = (jrs.downsample, trs.downsample) if down else (jrs.upsample, trs.upsample)
    _close(tfn(torch.from_numpy(w), torch.from_numpy(x)), jfn(p, jnp.asarray(x)))


def test_mdta_attend(nrng):
    q, k, v = (nrng.normal(size=(2, 3, 4, 20)).astype(np.float32) for _ in range(3))
    temp = nrng.uniform(0.5, 2.0, (3, 1, 1)).astype(np.float32)
    want = jatt.mdta_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(temp))
    got = tatt.mdta_attend(*(torch.from_numpy(a) for a in (q, k, v, temp)))
    _close(got, want)


def test_mdta_whole(nrng):
    c, heads = 8, 2
    x = nrng.normal(size=(2, 6, 5, c)).astype(np.float32)
    wq = nrng.normal(0, 0.3, (3 * c, c, 1, 1)).astype(np.float32)
    wd = nrng.normal(0, 0.3, (3 * c, 1, 3, 3)).astype(np.float32)
    wp = nrng.normal(0, 0.3, (c, c, 1, 1)).astype(np.float32)
    temp = nrng.uniform(0.5, 2.0, (heads, 1, 1)).astype(np.float32)
    p = {"temperature": jnp.asarray(temp), "qkv": {"w": jnp.asarray(_hwio(wq))},
         "qkv_dw": {"w": jnp.asarray(_hwio(wd))}, "proj": {"w": jnp.asarray(_hwio(wp))}}
    want = jatt.mdta(p, jnp.asarray(x), heads)
    got = tatt.mdta(*(torch.from_numpy(a) for a in (x, temp, wq, wd, wp)), heads)
    _close(got, want)


@pytest.mark.parametrize("dim", [8, 48], ids=["hid21", "hid127"])
def test_gdfn(nrng, dim):
    hid = tgdfn.hidden_features(dim, 2.66)
    assert hid == jgdfn.hidden_features(dim, 2.66) == int(dim * 2.66)
    x = nrng.normal(size=(1, 5, 7, dim)).astype(np.float32)
    wi = nrng.normal(0, dim ** -0.5, (2 * hid, dim, 1, 1)).astype(np.float32)
    wd = nrng.normal(0, 0.3, (2 * hid, 1, 3, 3)).astype(np.float32)
    wo = nrng.normal(0, hid ** -0.5, (dim, hid, 1, 1)).astype(np.float32)
    p = {"proj_in": {"w": jnp.asarray(_hwio(wi))}, "dw": {"w": jnp.asarray(_hwio(wd))},
         "proj_out": {"w": jnp.asarray(_hwio(wo))}}
    want = jgdfn.gdfn(p, jnp.asarray(x))
    got = tgdfn.gdfn(*(torch.from_numpy(a) for a in (x, wi, wd, wo)))
    _close(got, want)


def test_psnr_and_ssim(nrng):
    a = nrng.uniform(0, 1, (23, 19, 3)).astype(np.float32)
    b = np.clip(a + nrng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    _close(tq.psnr(torch.from_numpy(a), torch.from_numpy(b)),
           jq.psnr(jnp.asarray(a), jnp.asarray(b)))
    want = jq.ssim_ref_single(jnp.asarray(a) * 255.0, jnp.asarray(b) * 255.0)
    got = tq.ssim_ref_single(torch.from_numpy(a) * 255.0, torch.from_numpy(b) * 255.0)
    _close(got, want)
    # single-channel input takes the 2-D path
    _close(tq.ssim_ref_single(torch.from_numpy(a[..., 0]) * 255.0,
                              torch.from_numpy(b[..., 0]) * 255.0),
           jq.ssim_ref_single(jnp.asarray(a[..., 0]) * 255.0,
                              jnp.asarray(b[..., 0]) * 255.0))


def test_average_meter():
    m = tq.AverageMeter()
    assert np.isnan(m.avg)
    m.update(2.0)
    m.update(4.0, n=3)
    assert m.avg == pytest.approx(3.5)
