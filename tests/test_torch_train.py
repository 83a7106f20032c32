"""The port's training pieces against the JAX package, on the CPU.

- F_net (rcot_torch/models/critic.py) against apply_fnet, both heads, with
  weights carried across by fnet_state_dict_from_jax; its input gradient
  against jax.grad; the reference golden tests/goldens/fnet_p64.npz
  without JAX; the parameter pin of 30,588,609 at patch 128.
- The Fourier cost, the RMSE, t_loss, the WGAN loss and the gradient
  penalty (JAX's alpha injected), values and gradients.
- RMSprop and Adam over 3 steps with the learning rate set per step, and
  step_decay_lr.
- The config sections read from the JAX package's Config.to_dict().

Tolerances (fp32 on both sides; only the order of sums differs): critic
scores atol 1e-5, rtol 1e-4 (the golden's own tolerance in
tests/test_golden_parity.py); losses rtol 1e-5; gradients within 1e-4 of
the largest magnitude of each tensor; optimizer states rtol 1e-5,
atol 1e-8.
"""

import dataclasses
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rcot_torch.compat.jax_params import fnet_state_dict_from_jax
from rcot_torch.models.critic import FNet
from rcot_torch.models.restormer import count_params
from rcot_torch.ops.fourier import fourier_residual_penalty, residual_rmse
from rcot_torch.train import losses as tl
from rcot_torch.train.optim import make_optimizer, set_lr, step_decay_lr
from rcot_torch.utils import config as tc
from rcot_tpu.compat.torch_port import port_fnet_state_dict
from rcot_tpu.models.critic import apply_fnet, init_fnet
from rcot_tpu.ops import fourier as jf
from rcot_tpu.train import losses as jl
from rcot_tpu.train import optim as jo
from rcot_tpu.utils import config as jc

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
SCORE_TOL = dict(atol=1e-5, rtol=1e-4)


def synth_param(name: str, shape) -> np.ndarray:
    """Must stay in sync with tools/make_goldens.py."""
    rng = np.random.default_rng(zlib.crc32(name.encode()) & 0xFFFFFFFF)
    return (rng.standard_normal(shape) * 0.02).astype(np.float32)


def _tcritic(cfg: jc.CriticConfig) -> tc.CriticConfig:
    return tc.CriticConfig(**dataclasses.asdict(cfg))


def _port_fnet(params, cfg: jc.CriticConfig) -> FNet:
    net = FNet(_tcritic(cfg), device="cpu", seed=None)
    sd = fnet_state_dict_from_jax(params, cfg)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return net


def _close_grad(got, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-4 * max(np.abs(want).max(), 1e-8), err_msg=name)


CRITICS = pytest.mark.parametrize("cfg", [
    jc.CriticConfig(patch_size=64), jc.CriticConfig(patch_size=40, head="pooled")],
    ids=["flatten_p64", "pooled_p40"])


@CRITICS
def test_fnet_matches_apply_fnet(cfg):
    params = init_fnet(jax.random.PRNGKey(1), cfg)
    x = np.random.default_rng(0).uniform(0, 1, (2, cfg.patch_size, cfg.patch_size, 3)
                                         ).astype(np.float32)
    want = np.asarray(apply_fnet(params, jnp.asarray(x), cfg))
    with torch.no_grad():
        got = _port_fnet(params, cfg)(torch.from_numpy(x)).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, **SCORE_TOL)


@CRITICS
def test_critic_input_gradient_matches_jax_grad(cfg):
    params = init_fnet(jax.random.PRNGKey(2), cfg)
    x = np.random.default_rng(1).uniform(0, 1, (2, cfg.patch_size, cfg.patch_size, 3)
                                         ).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(apply_fnet(params, v, cfg)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    _port_fnet(params, cfg)(xt).sum().backward()
    _close_grad(xt.grad.numpy(), want)


def test_fnet_state_dict_is_the_exact_inverse_of_the_porter():
    cfg = jc.CriticConfig(patch_size=64)
    params = init_fnet(jax.random.PRNGKey(3), cfg)
    back = port_fnet_state_dict(fnet_state_dict_from_jax(params, cfg), cfg)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fnet_matches_reference_golden_without_jax():
    z = np.load(os.path.join(GOLDENS, "fnet_p64.npz"))
    sd = {str(n): synth_param(str(n), tuple(int(v) for v in str(s).split(",")))
          for n, s in zip(z["names"], z["shapes"])}
    net = FNet(tc.CriticConfig(patch_size=64), device="cpu", seed=None)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    x = torch.from_numpy(np.transpose(z["input"], (0, 2, 3, 1)).copy())
    with torch.no_grad():
        got = net(x).numpy()
    np.testing.assert_allclose(got, z["score"], **SCORE_TOL)


def test_fnet_parameter_pin_and_config_checks():
    assert count_params(FNet(tc.CriticConfig(), device="cpu", seed=None)) == 30_588_609
    a = FNet(tc.CriticConfig(patch_size=32), device="cpu", seed=4)
    b = FNet(tc.CriticConfig(patch_size=32), device="cpu", seed=4)
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), n
    assert float(a.features["0"].weight.detach().std()) == pytest.approx(0.02, rel=0.1)
    with pytest.raises(ValueError, match="% 32"):
        FNet(tc.CriticConfig(patch_size=48), device="cpu")
    with pytest.raises(ValueError, match="fc_mid"):
        FNet(tc.CriticConfig(head="pooled", fc_mid=64), device="cpu")
    with pytest.raises(ValueError, match="unknown critic head"):
        FNet(tc.CriticConfig(head="max"), device="cpu")


# ------------------------------------------------------------------ losses

def _grad_pair(jfn, tfn, *arrays):
    """Value and gradient in every argument, JAX against torch."""
    jval, jgrads = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tval = tfn(*leaves)
    tgrads = torch.autograd.grad(tval, leaves)
    return (float(jval), [np.asarray(g) for g in jgrads],
            float(tval.detach()), [g.numpy() for g in tgrads])


@pytest.mark.parametrize("loss_math", ["reference", "clean"])
def test_fourier_penalty_and_rmse_match_jax(loss_math):
    rng = np.random.default_rng(5)
    res = rng.normal(0, 0.1, (3, 16, 12, 3)).astype(np.float32)
    for de in ([0, 3, 4], [2, 5, 1]):
        de_id = np.array(de, np.int32)
        jv, jg, tv, tg = _grad_pair(
            lambda r: jf.fourier_residual_penalty(r, jnp.asarray(de_id), loss_math),
            lambda r: fourier_residual_penalty(r, torch.from_numpy(de_id), loss_math),
            res)
        assert tv == pytest.approx(jv, rel=1e-5)
        _close_grad(tg[0], jg[0])
    jv, jg, tv, tg = _grad_pair(jf.residual_rmse, residual_rmse, res)
    assert tv == pytest.approx(jv, rel=1e-5)
    _close_grad(tg[0], jg[0])
    with pytest.raises(ValueError, match="loss_math"):
        fourier_residual_penalty(torch.from_numpy(res), torch.zeros(3), "rms")


@pytest.mark.parametrize("paired", [True, False], ids=["paired", "unpaired"])
def test_t_loss_matches_jax(paired):
    rng = np.random.default_rng(6)
    out, inp, target = (rng.uniform(0, 1, (3, 16, 16, 3)).astype(np.float32)
                        for _ in range(3))
    score = rng.normal(size=3).astype(np.float32)
    de_id = np.array([0, 3, 4], np.int32)
    kw = dict(sigma=1.0, Sigma=1e4, loss_math="reference")
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda o, s: jl.t_loss(o, jnp.asarray(inp), jnp.asarray(target),
                               jnp.asarray(de_id), s, paired=jnp.asarray(paired), **kw),
        argnums=(0, 1), has_aux=True)(jnp.asarray(out), jnp.asarray(score))
    o, s = (torch.from_numpy(a).requires_grad_() for a in (out, score))
    tloss, taux = tl.t_loss(o, torch.from_numpy(inp), torch.from_numpy(target),
                            torch.from_numpy(de_id), s, paired=paired, **kw)
    assert float(tloss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    assert set(taux) == set(jaux)
    for k in jaux:
        assert float(taux[k].detach()) == pytest.approx(float(jaux[k]), rel=1e-5), k
    for got, want in zip(torch.autograd.grad(tloss, (o, s)), jgrads):
        _close_grad(got.numpy(), want)


def test_wgan_critic_loss_matches_jax():
    rng = np.random.default_rng(7)
    real, fake = rng.normal(size=4).astype(np.float32), rng.normal(size=4).astype(np.float32)
    jv, jg, tv, tg = _grad_pair(jl.wgan_critic_loss, tl.wgan_critic_loss, real, fake)
    assert tv == pytest.approx(jv, rel=1e-6)
    for got, want in zip(tg, jg):
        _close_grad(got, want)


def test_gradient_penalty_matches_jax_with_its_alpha():
    cfg = jc.CriticConfig(patch_size=32)
    params = init_fnet(jax.random.PRNGKey(8), cfg)
    rng = np.random.default_rng(9)
    real, fake = (rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(10)
    want, jgrads = jax.value_and_grad(lambda fp: jl.gradient_penalty(
        lambda x: apply_fnet(fp, x, cfg), jnp.asarray(real), jnp.asarray(fake), key,
        10.0))(params)
    # the draw gradient_penalty makes from its key
    alpha = np.array(jax.random.uniform(key, (2, 1, 1, 1), dtype=jnp.float32))
    net = _port_fnet(params, cfg)
    got = tl.gradient_penalty(net, torch.from_numpy(real), torch.from_numpy(fake),
                              torch.from_numpy(alpha), 10.0)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    names = [n for n, _ in net.named_parameters()]
    # fc2's bias does not reach the input gradient: None here, zeros in JAX
    tgrads = torch.autograd.grad(got, list(net.parameters()), allow_unused=True)
    want_sd = fnet_state_dict_from_jax(jgrads, cfg)
    assert [n for n, g in zip(names, tgrads) if g is None] == ["fc2.bias"]
    assert not np.any(want_sd["fc2.bias"])
    for name, g in zip(names, tgrads):
        if g is not None:
            _close_grad(g.numpy(), want_sd[name], name)


# --------------------------------------------------------------- optimizers

@pytest.mark.parametrize("name", ["RMSprop", "Adam"])
def test_optimizers_match_jax_over_three_steps(name):
    rng = np.random.default_rng(11)
    params = {"w": rng.normal(size=(4, 5)).astype(np.float32),
              "b": rng.normal(size=5).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    lrs = [1e-3, 1e-3, 1e-4]
    tx = jo.make_optimizer(name, lrs[0])
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    opt = make_optimizer(name, list(tp.values()), lrs[0])
    for lr, g in zip(lrs, grads):
        hp = dict(state.hyperparams)
        hp["learning_rate"] = jnp.asarray(lr, jnp.float32)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state._replace(hyperparams=hp), jp)
        jp = optax.apply_updates(jp, upd)
        set_lr(opt, lr)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-8, err_msg=k)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("SGD", list(tp.values()), 1e-3)


def test_step_decay_lr_matches_jax():
    for epoch in (0, 19, 20, 39, 40, 61):
        assert step_decay_lr(1e-4, epoch, 20) == pytest.approx(
            float(jo.step_decay_lr(1e-4, epoch, 20)), rel=1e-6)


def test_config_sections_read_the_jax_dict():
    for jcfg in (jc.Config(), jc.get_preset("derain_turbo"), jc.get_preset("dehaze")):
        got = tc.config_from_dict(jcfg.to_dict())
        for section in ("model", "critic", "train"):
            tsec, jsec = getattr(got, section), getattr(jcfg, section)
            for f in dataclasses.fields(tsec):
                assert getattr(tsec, f.name) == getattr(jsec, f.name), (section, f.name)
    assert tc.config_from_dict({}) == tc.Config()
