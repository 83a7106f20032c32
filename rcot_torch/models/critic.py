"""F_net: the OT potential / WGAN critic.

Counterpart of rcot_tpu/models/critic.py; reference Net_Restormer.py:436-522.
Ten convs with LeakyReLU(0.2): the 5x5 stride-1 stem, then alternating 3x3
stride-1 and 4x4 stride-2 stages, 64 -> ... -> 512 channels, the last four
bias-free, five halvings in all. Heads:

- "flatten" (the reference's): flatten -> fc (num_fea -> num_fea / 4) ->
  fc1 (-> 64) -> LeakyReLU -> fc2 (-> 1), num_fea = patch_size^2 / 2. There
  is no nonlinearity between fc and fc1, as in the reference.
- "pooled": a global average over pixels to 512 features, then fc
  (512 -> 128), fc1 and fc2 as above.

The state_dict carries the reference's names (features.{0,2,...,18}, fc,
fc1, fc2), so a reference checkpoint loads with strict=True, and the
flatten head flattens in torch's (C, H, W) order. Activations are
(B, H, W, C); 30,588,609 parameters at patch 128.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import conv2d, linear
from ..utils.config import CriticConfig
from ..utils.device import resolve_device
from .restormer import Conv

# (cin, cout, kernel, stride, bias); the stem takes cfg.in_channels
CONV_SPECS = [
    (3, 64, 5, 1, True),
    (64, 64, 4, 2, True),
    (64, 128, 3, 1, True),
    (128, 128, 4, 2, True),
    (128, 256, 3, 1, True),
    (256, 256, 4, 2, True),
    (256, 512, 3, 1, False),
    (512, 512, 4, 2, False),
    (512, 512, 3, 1, False),
    (512, 512, 4, 2, False),
]


# the slope in bf16, as jax.nn.leaky_relu takes it against a bf16 x
SLOPE_BF16 = float(torch.tensor(0.2).to(torch.bfloat16))


def _leaky(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2); on bf16 as jax.nn.leaky_relu computes it,
    where(x >= 0, x, slope * x) with the slope in bf16 (0.2001953125; its
    gradient 1 at 0), which F.leaky_relu's fp32 slope would round apart."""
    if x.dtype == torch.bfloat16:
        return torch.where(x >= 0, x, x * SLOPE_BF16)
    return F.leaky_relu(x, negative_slope=0.2)


class FNet(nn.Module):
    """The RCOT critic: x (B, H, W, C) -> (B,) scores. `seed` draws every
    parameter from one torch.Generator on the CPU: conv weights
    N(0, 0.02^2), conv biases and the linear layers as torch's defaults
    (uniform in +-1/sqrt(fan_in))."""

    def __init__(self, cfg: CriticConfig = CriticConfig(), *, device="cuda",
                 seed: Optional[int] = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if cfg.head == "flatten":
            if cfg.patch_size % 32:
                raise ValueError(
                    f"flatten critic head requires patch_size % 32 == 0 (got "
                    f"{cfg.patch_size}); use head='pooled' for other sizes")
            num_fea = cfg.patch_size * cfg.patch_size // 2
            mid = cfg.fc_mid if cfg.fc_mid is not None else num_fea // 4
        elif cfg.head == "pooled":
            if cfg.fc_mid is not None:
                raise ValueError("fc_mid only applies to the flatten head")
            num_fea, mid = 512, 128
        else:
            raise ValueError(f"unknown critic head {cfg.head!r}")
        self.features = nn.ModuleDict({
            str(2 * i): Conv(cfg.in_channels if i == 0 else cin, cout, k, bias=bias)
            for i, (cin, cout, k, _s, bias) in enumerate(CONV_SPECS)})
        self.fc = nn.Linear(num_fea, mid)
        self.fc1 = nn.Linear(mid, 64)
        self.fc2 = nn.Linear(64, 1)
        if seed is not None:
            self.init_weights_(seed)
        self.to(dev)

    @torch.no_grad()
    def init_weights_(self, seed: int = 0, std: float = 0.02) -> "FNet":
        gen = torch.Generator().manual_seed(seed)
        for conv in self.features.values():
            w = torch.empty(conv.weight.shape).normal_(0.0, std, generator=gen)
            conv.weight.copy_(w)
            if conv.bias is not None:
                bound = conv.weight[0].numel() ** -0.5
                conv.bias.copy_(torch.empty(conv.bias.shape)
                                .uniform_(-bound, bound, generator=gen))
        for lin in (self.fc, self.fc1, self.fc2):
            bound = lin.in_features ** -0.5
            for p in (lin.weight, lin.bias):
                p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=gen))
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for conv, (_cin, _cout, k, s, _b) in zip(self.features.values(), CONV_SPECS):
            # torch padding: 2 for the 5x5 stem, 1 for every other conv
            h = _leaky(conv2d(h, conv.weight, conv.bias, stride=s,
                              padding=2 if k == 5 else 1))
        if self.cfg.head == "flatten":
            feat = h.permute(0, 3, 1, 2).reshape(h.shape[0], -1)
        else:
            feat = h.mean(dim=(1, 2))
        out = linear(linear(feat, self.fc.weight, self.fc.bias),
                     self.fc1.weight, self.fc1.bias)
        out = linear(_leaky(out), self.fc2.weight, self.fc2.bias)
        return out[:, 0]
