"""One minimax iteration of the port (rcot_torch/train/steps.py) against
jax.jit(make_train_iteration) of the JAX package, on the CPU, at the
`tiny_config` fixture (dim 8, one block per level, critic patch 32, B = 2).

Both sides start from the JAX create_train_state, carried across by
tnet_state_dict_from_jax / fnet_state_dict_from_jax, and take the same
batch (de_id 0 and 3, so both Fourier branches run) and the same GP draw
alpha = jax.random.uniform(key, (B,1,1,1)). One iteration, paired or not.

- The metrics agree within rtol 1e-4 (fp32 through some hundred ops and
  their backward, sums in another order).
- After the iteration, each optimizer's square_avg is 0.01 g^2 for
  T and 0.0099 g1^2 + 0.01 g2^2 for F (two critic steps), so it holds the
  gradients: it agrees within 1e-3 of each tensor's largest entry.
- The parameter deltas are compared only on entries whose first gradient
  and whose sqrt(square_avg) are both well above the fp32 noise: an
  RMSprop step moves an entry by about lr g / rms(g), +-10 lr for a first
  step whatever |g| is, so a gradient that is small beside its tensor's
  largest turns the sums' absolute error into a large relative one, and a
  near-zero gradient is decided by its sign. T (one step, 10 lr): entries
  above 1e-3 of the tensor's largest, within 1e-3 of the step (about 97%
  of T's entries). F (two steps, 20 lr): its second gradient is the GP's
  at the critic the first step updated, so the first step's sign noise on
  near-zero entries (+-10 lr each) reaches every entry of the second:
  entries above 1e-2 (about 30% of F's entries, the conv stack's
  gradients being heavy-tailed), 99.9% of them within 1e-2 of the step
  and all within a quarter of it (a flipped sign would be two steps). F's
  first gradient (the WGAN step's) is taken on the port's side before the
  iteration, from the same weights and batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcot_torch.compat.jax_params import fnet_state_dict_from_jax, tnet_state_dict_from_jax
from rcot_torch.train import losses as tlosses
from rcot_torch.train import steps as tsteps
from rcot_torch.train.optim import step_decay_lr
from rcot_torch.utils.config import config_from_dict
from rcot_tpu.train import steps as jsteps

METRIC_RTOL = 1e-4
STATE_RTOL = 1e-3
# (which entries, tolerance, tolerance of the worst 0.1%) of the delta
# check, as fractions of each tensor's largest gradient and of the step
T_DELTA = (1e-3, 1e-3, 1e-3)
F_DELTA = (1e-2, 1e-2, 0.25)


def _named(sd_fn, tree, cfg):
    return {k: np.asarray(v) for k, v in sd_fn(tree, cfg).items()}


def _carried_state(cfg, jstate):
    ts = tsteps.create_train_state(config_from_dict(cfg.to_dict()), seed=0, device="cpu")
    for net, sd in ((ts.t_net, tnet_state_dict_from_jax(jstate.t_params, cfg.model)),
                    (ts.f_net, fnet_state_dict_from_jax(jstate.f_params, cfg.critic))):
        net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                            strict=True)
    return ts


@pytest.mark.parametrize("paired", [True, False], ids=["paired", "unpaired"])
def test_iteration_matches_make_train_iteration(tiny_config, paired):
    cfg = tiny_config
    b, patch = cfg.train.batch_size, cfg.critic.patch_size
    state = jsteps.create_train_state(jax.random.PRNGKey(0), cfg)
    ts = _carried_state(cfg, state)
    t0 = {n: p.detach().clone() for n, p in ts.t_net.named_parameters()}
    f0 = {n: p.detach().clone() for n, p in ts.f_net.named_parameters()}

    rng = np.random.default_rng(0)
    deg, tgt = (rng.uniform(0, 1, (b, patch, patch, 3)).astype(np.float32) for _ in range(2))
    de_id = np.array([0, 3], np.int32)
    jbatch = jsteps.Batch(jnp.asarray(deg), jnp.asarray(tgt), jnp.asarray(de_id))
    tbatch = tsteps.Batch(*(torch.from_numpy(a) for a in (deg, tgt, de_id)))
    lr = step_decay_lr(cfg.train.lr, 0, cfg.train.lr_step)
    g_wgan = _critic_wgan_grad(ts, tbatch)

    key = jax.random.PRNGKey(10)
    state, jm = jax.jit(jsteps.make_train_iteration(cfg))(
        state, jbatch, key, jnp.asarray(paired), jnp.asarray(lr, jnp.float32))
    alpha = np.array(jax.random.uniform(key, (b, 1, 1, 1), dtype=jnp.float32))
    ts, tm = tsteps.make_train_iteration(config_from_dict(cfg.to_dict()))(
        ts, tbatch, torch.from_numpy(alpha), paired, lr)
    assert set(tm) == set(jm) == {"f_wgan", "f_gp", "t_loss", "t_adv", "rmse",
                                  "fourier", "paired_l1"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=METRIC_RTOL,
                                   atol=1e-7, err_msg=k)
    assert ts.step == 1 and int(state.step) == 1
    _check_first_step(cfg, ts, state, t0, f0, g_wgan, lr)


def _critic_wgan_grad(ts, batch):
    """d f_wgan / d F at the starting weights: the gradient of F's first
    step."""
    with torch.no_grad():
        fake = ts.t_net(batch.degraded)[0]
    scores = ts.f_net(torch.cat([batch.target, fake]))
    b = fake.shape[0]
    loss = tlosses.wgan_critic_loss(scores[:b], scores[b:])
    names = [n for n, _ in ts.f_net.named_parameters()]
    return dict(zip(names, (g.numpy() for g in torch.autograd.grad(
        loss, list(ts.f_net.parameters())))))


def _check_first_step(cfg, ts, jstate, t0, f0, g_wgan, lr):
    t_sq = _named(tnet_state_dict_from_jax, jstate.t_opt.inner_state[0].square_avg,
                  cfg.model)
    sides = (
        ("T", ts.t_net, ts.t_opt, t0, t_sq,
         _named(tnet_state_dict_from_jax, jstate.t_params, cfg.model),
         {k: np.sqrt(v / 0.01) for k, v in t_sq.items()}, 10 * lr / 2, T_DELTA),
        ("F", ts.f_net, ts.f_opt, f0,
         _named(fnet_state_dict_from_jax, jstate.f_opt.inner_state[0].square_avg, cfg.critic),
         _named(fnet_state_dict_from_jax, jstate.f_params, cfg.critic), g_wgan, 20 * lr,
         F_DELTA),
    )
    for side, net, opt, before, want_sq, want_p, first_g, step, (live_at, tol, worst) in sides:
        compared = total = outside = 0
        for name, p in net.named_parameters():
            sq = opt.state[p]["square_avg"].numpy()
            scale = max(np.abs(want_sq[name]).max(), 1e-30)
            np.testing.assert_allclose(sq, want_sq[name], rtol=0, atol=STATE_RTOL * scale,
                                       err_msg=f"{side} square_avg {name}")
            g, rms = np.abs(first_g[name]), np.sqrt(want_sq[name])
            live = ((g > live_at * max(g.max(), 1e-30))
                    & (rms > live_at * max(rms.max(), 1e-30)))
            compared, total = compared + int(live.sum()), total + live.size
            got_d = (p.detach() - before[name]).numpy()[live]
            want_d = (want_p[name] - before[name].numpy())[live]
            np.testing.assert_allclose(got_d, want_d, rtol=0, atol=worst * step,
                                       err_msg=f"{side} delta {name}")
            outside += int((np.abs(got_d - want_d) > tol * step).sum())
        assert compared > total // 4, (side, compared, total)
        assert outside <= compared // 1000, (side, outside, compared)
