"""chip_smoke.py's card-against-CPU comparison of the critic's gradients, on
the CPU: why it pins the critic's LeakyReLU sign pattern (LeakyPattern).

A change of 1e-7 in the critic's input, the size of the card's rounding
against the CPU's in the T_net's output, moves a fp32 gradient of the critic
by far more than GRAD_RTOL of its largest entry where a pre-activation sits
within that change of 0 (inputs 9 and 10 below, at the critic of seed 1,
patch 64). With the sign pattern of the unmoved input pinned, the same
change moves it by a few 1e-5 of its largest entry, as at the inputs that
have no such unit.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from rcot_torch.models.critic import FNet
from rcot_torch.train import losses
from rcot_torch.utils.config import CriticConfig


@pytest.fixture(scope="module")
def critic_net():
    return FNet(CriticConfig(patch_size=64), device="cpu", seed=1)


def _inputs(seed):
    """real, fake (1, 64, 64, 3) in [0, 1], and fake moved by N(0, 1e-7)."""
    rng = np.random.default_rng(seed)
    real, fake = (torch.from_numpy(rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
                  for _ in range(2))
    moved = fake + torch.from_numpy((rng.standard_normal(fake.shape) * 1e-7)
                                    .astype(np.float32))
    return real, fake, moved


def _wgan_grads(f, real, fake):
    scores = f(torch.cat([real, fake]))
    return torch.autograd.grad(losses.wgan_critic_loss(scores[:1], scores[1:]),
                               list(f.parameters()))


def _worst(got, want):
    return max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))


def test_a_rounding_sized_change_moves_the_critic_gradient_past_the_tolerance(critic_net):
    jumps = []
    for seed in (9, 10):
        real, fake, moved = _inputs(seed)
        jumps.append(_worst(_wgan_grads(critic_net, real, moved),
                            _wgan_grads(critic_net, real, fake)))
    assert max(jumps) > 10 * chip_smoke.GRAD_RTOL, jumps


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_the_pinned_pattern_keeps_the_critic_gradient_smooth(critic_net, seed):
    real, fake, moved = _inputs(seed)
    pattern = chip_smoke.LeakyPattern()
    with pattern.recording():
        want = _wgan_grads(critic_net, real, fake)
    with pattern.replaying():
        got = _wgan_grads(critic_net, real, moved)
    assert _worst(got, want) < chip_smoke.GRAD_RTOL / 2


def test_replay_holds_the_calls_to_the_recording(critic_net):
    real, fake, _ = _inputs(0)
    pattern = chip_smoke.LeakyPattern()
    with pattern.recording():
        plain = critic_net(fake)
    with pattern.replaying():
        assert torch.equal(critic_net(fake), plain)
    with pytest.raises(AssertionError, match="not made"):
        with pattern.replaying():
            pass
    with pytest.raises(AssertionError, match="no recorded pattern"):
        with pattern.replaying():
            critic_net(torch.cat([real, fake]))
    # the critic's own LeakyReLU is back after each of them
    assert torch.equal(critic_net(fake), plain)


# ---- the floor for cancelling sums (chip_smoke.SUM_ULPS, grad_allowance)

def _cancelling_terms(n=96 * 96, seed=0):
    """fp32 terms whose float64 sum is ~1e-8 of the sum of their magnitudes."""
    t = np.random.default_rng(seed).standard_normal(n)
    return torch.from_numpy((t - t.mean()).astype(np.float32))


def test_a_cancelling_fp32_sum_is_held_to_the_floor_not_to_itself():
    t = _cancelling_terms()
    exact = t.double().sum()
    got = t.sum()
    err = abs(float(got) - float(exact))
    assert err > chip_smoke.GRAD_RTOL * abs(float(exact))  # the old gate fails it
    allowed = chip_smoke.grad_allowance(exact.reshape(1).float(), t.abs().sum().reshape(1))
    assert err <= float(allowed)


def _one_head_core(dtype, qkv, cot, temp):
    """The Gram core of one head on the CPU: output and dtemperature."""
    from rcot_torch.ops import gram as tgram
    t = temp.to(dtype).clone().requires_grad_()
    out = tgram.mdta_core_gram(t, qkv.to(dtype), 1)
    (dt,) = torch.autograd.grad(out, t, cot.to(dtype))
    return dt


class _Head(torch.nn.Module):
    def __init__(self, temp):
        super().__init__()
        self.temperature = torch.nn.Parameter(temp.clone())


def test_a_one_head_temperature_gradient_lies_within_the_floor():
    """A cotangent chosen so that the float64 temperature gradient cancels:
    fp32 then misses it by far more than 2e-4 of itself, and stays inside
    SUM_ULPS ulps of sum|dlogits * g_hat|, which the recorder reads."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((1, 8, 8, 3 * 24)).astype(np.float32))
    c1, c2 = (torch.from_numpy(rng.standard_normal((1, 8, 8, 24))) for _ in range(2))
    temp = torch.full((1, 1, 1), 1.3)
    d1, d2 = (_one_head_core(torch.float64, qkv, c, temp) for c in (c1, c2))
    cot = (c1 - (d1 / d2).item() * c2).float()
    exact = _one_head_core(torch.float64, qkv, cot, temp)
    head = _Head(temp)
    terms = chip_smoke.TemperatureTerms(head)
    with terms.recording():
        from rcot_torch.ops import gram as tgram
        out = tgram.mdta_core_gram(head.temperature, qkv, 1)
        (got,) = torch.autograd.grad(out, head.temperature, cot)
    s = terms.sums["T temperature"]
    err = float((got.double() - exact).abs().max())
    assert err > chip_smoke.GRAD_RTOL * float(exact.abs().max())
    assert s.shape == (1, 1, 1) and float(s) > 1e3 * float(exact.abs().max())
    rel, bad = chip_smoke.grad_errors({"T temperature": got.double()},
                                      {"T temperature": exact}, terms.sums)
    assert bad == {}, bad
    rel, bad = chip_smoke.grad_errors({"T temperature": got.double()},
                                      {"T temperature": exact}, {})
    assert "T temperature" in bad  # without its floor the same gradient fails


def test_the_recorded_terms_are_those_of_the_temperature_gradient():
    """sum|terms| from the recorder equals sum|dlogits * g_hat| computed by
    hand, and the recorded run's gradient is the plain run's (in float64
    here, but the glue casts the temperature and so its gradient to fp32,
    per entry in the recorded run and after the sum in the plain one)."""
    from rcot_torch.ops import gram as tgram
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((2, 4, 5, 3 * 12)))
    cot = torch.from_numpy(rng.standard_normal((2, 4, 5, 12)))
    head = _Head(torch.tensor([[[0.7]], [[1.4]]], dtype=torch.float64))
    terms = chip_smoke.TemperatureTerms(head)
    with terms.recording():
        (got,) = torch.autograd.grad(tgram.mdta_core_gram(head.temperature, qkv, 2),
                                     head.temperature, cot)
    (plain,) = torch.autograd.grad(tgram.mdta_core_gram(head.temperature, qkv, 2),
                                   head.temperature, cot)
    torch.testing.assert_close(got, plain, rtol=1e-6, atol=0)
    gram, nq, nk = tgram.mdta_gram_plain(qkv, 2)
    ghat = gram / (nq.sqrt()[..., :, None] * nk.sqrt()[..., None, :])
    logits = (ghat * head.temperature.detach()[None]).requires_grad_()
    (dlogits,) = torch.autograd.grad(tgram.attn_apply_plain(qkv, logits.softmax(-1)),
                                     logits, cot)
    want = (dlogits * ghat).sum(0).abs().sum(dim=(1, 2), keepdim=True)
    torch.testing.assert_close(terms.sums["T temperature"], want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["weight", "temperature"])
def test_a_gradient_off_by_1e_3_of_its_largest_still_fails(kind):
    """The floor leaves the gate for everything else as it was: a weight
    gradient (no terms), and a temperature whose terms do not cancel, each
    moved by 1e-3 of its largest entry, fail."""
    rng = np.random.default_rng(5)
    if kind == "weight":
        ref = torch.from_numpy(rng.standard_normal((48, 48)).astype(np.float32))
        terms = {}
    else:
        t = torch.from_numpy(np.abs(rng.standard_normal((2, 24, 24))).astype(np.float32))
        ref = t.sum(dim=(1, 2), keepdim=True)
        terms = {"g": t.abs().sum(dim=(1, 2), keepdim=True)}
    moved = ref.clone()
    moved.view(-1)[0] += 1e-3 * float(ref.abs().max())
    assert chip_smoke.grad_errors({"g": ref}, {"g": ref}, terms)[1] == {}
    assert "g" in chip_smoke.grad_errors({"g": moved}, {"g": ref}, terms)[1]
