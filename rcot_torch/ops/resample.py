"""Pixel (un)shuffle resamplers on NHWC, in torch's channel order
(reference Net_Restormer.py:86-111):

- pixel_unshuffle: out channel c*r^2 + i*r + j;
- pixel_shuffle:   in channel  c*r^2 + i*r + j.
"""

from __future__ import annotations

import torch

from .conv import conv2d


def pixel_unshuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/r, W/r, C*r^2)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // r, w // r, c * r * r)


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, H, W, C*r^2) -> (B, H*r, W*r, C)."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def downsample(weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """3x3 conv C -> C/2, then pixel_unshuffle(2)."""
    return pixel_unshuffle(conv2d(x, weight), 2)


def upsample(weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """3x3 conv C -> 2C, then pixel_shuffle(2)."""
    return pixel_shuffle(conv2d(x, weight), 2)
