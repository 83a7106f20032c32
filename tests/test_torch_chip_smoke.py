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
