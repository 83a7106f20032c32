"""LPIPS perceptual distance (AlexNet variant), an nn.Module (NCHW inside).

Counterpart of rcot_tpu/metrics/lpips.py, the lpips package's 'alex' scorer
(Zhang et al. 2018, "The Unreasonable Effectiveness of Deep Features as a
Perceptual Metric"; the reference lists it, env.yml:40, and left its
calls commented out, evaluate.py:95-96):

  1. [0,1] -> [-1,1], then the package's shift/scale constants;
  2. the AlexNet features, tapping the five ReLU outputs (max pools after
     the first two);
  3. per layer: both maps unit-normalised over channels (eps added to the
     norm), the squared difference, a non-negative 1x1 head of shape (C,),
     the spatial mean;
  4. the sum over layers.

Weights load from the .npz tools/port_lpips.py writes (conv*.w HWIO,
conv*.b, lin*.w), the JAX package's file, or fall back to the same
crc32-seeded surrogate; surrogate scores compare only with each other.
"""

from __future__ import annotations

import functools
import os
import warnings
import zlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device

# lpips package scaling layer constants (ScalingLayer in lpips/lpips.py)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# AlexNet feature convs: (name, cin, cout, kernel, stride, pad)
ALEX_SPECS = [
    ("conv1", 3, 64, 11, 4, 2),
    ("conv2", 64, 192, 5, 1, 2),
    ("conv3", 192, 384, 3, 1, 1),
    ("conv4", 384, 256, 3, 1, 1),
    ("conv5", 256, 256, 3, 1, 1),
]
# channels of the five tapped ReLU outputs (linear head widths)
LIN_CHANNELS = [64, 192, 384, 256, 256]


def init_lpips_params(weights_path: Optional[str] = None) -> Dict:
    """{conv*: {"w": OIHW tensor, "b": tensor}, lin*: (C,) tensor} from a
    ported .npz (conv*.w HWIO) or the deterministic surrogate."""
    params: Dict = {}
    if weights_path and os.path.exists(weights_path):
        with np.load(weights_path) as z:
            for name, cin, cout, k, _s, _p in ALEX_SPECS:
                w = z[name + ".w"]
                if w.shape != (k, k, cin, cout):
                    raise ValueError(f"{weights_path}: {name}.w has shape {w.shape}")
                params[name] = (w, z[name + ".b"])
            for i, c in enumerate(LIN_CHANNELS):
                w = z[f"lin{i}.w"]
                if w.shape != (c,):
                    raise ValueError(f"{weights_path}: lin{i}.w has shape {w.shape}")
                params[f"lin{i}"] = w
    else:
        warnings.warn(
            "LPIPS weights file not found: using a DETERMINISTIC SURROGATE "
            "init. Scores are only comparable to other surrogate scores.")
        for name, cin, cout, k, _s, _p in ALEX_SPECS:
            rng = np.random.default_rng(zlib.crc32(name.encode()) & 0xFFFFFFFF)
            w = rng.standard_normal((k, k, cin, cout)) * np.sqrt(2.0 / (cin * k * k))
            params[name] = (w, np.zeros((cout,)))
        for i, c in enumerate(LIN_CHANNELS):
            rng = np.random.default_rng(zlib.crc32(f"lin{i}".encode()) & 0xFFFFFFFF)
            params[f"lin{i}"] = rng.uniform(0.0, 1.0, (c,))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))
    out = {f"lin{i}": t(params[f"lin{i}"]) for i in range(len(LIN_CHANNELS))}
    for name, *_ in ALEX_SPECS:
        w, b = params[name]
        out[name] = {"w": t(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))),
                     "b": t(b)}
    return out


class LPIPS(nn.Module):
    """AlexNet features and the five linear heads; forward(x, y) on
    (B, 3, H, W) already scaled to [-1, 1] -> (B,) distances."""

    def __init__(self, weights_path: Optional[str] = None, device="cuda"):
        super().__init__()
        params = init_lpips_params(weights_path)
        self.convs = nn.ModuleList()
        for name, cin, cout, k, s, p in ALEX_SPECS:
            conv = nn.Conv2d(cin, cout, k, stride=s, padding=p)
            with torch.no_grad():
                conv.weight.copy_(params[name]["w"])
                conv.bias.copy_(params[name]["b"])
            self.convs.append(conv)
        for i in range(len(LIN_CHANNELS)):
            self.register_buffer(f"lin{i}", params[f"lin{i}"])
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1))
        self.to(resolve_device(device)).eval()

    def _features(self, x: torch.Tensor) -> list:
        x = (x - self.shift) / self.scale
        feats = []
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            feats.append(x)
            if i < 2:  # max pool after relu1 and relu2 (torchvision AlexNet)
                x = F.max_pool2d(x, 3, stride=2)
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for i, (a, b) in enumerate(zip(self._features(x), self._features(y))):
            d = (_unit_normalize(a) - _unit_normalize(b)).square()
            w = getattr(self, f"lin{i}").view(1, -1, 1, 1)
            total = total + (d * w).sum(dim=1).mean(dim=(1, 2))
        return total


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """lpips normalize_tensor: unit L2 over channels, eps on the norm."""
    return f / (f.square().sum(dim=1, keepdim=True).sqrt() + eps)


@torch.inference_mode()
def lpips(net: LPIPS, x, y) -> torch.Tensor:
    """x, y: (B, H, W, 3) in [0, 1] (tensors or numpy) -> (B,) LPIPS
    distances on the net's device."""
    dev = next(net.parameters()).device

    def prep(v):
        v = torch.as_tensor(v, dtype=torch.float32).to(dev).permute(0, 3, 1, 2)
        return (2.0 * v - 1.0).contiguous()
    return net(prep(x), prep(y))


@functools.lru_cache(maxsize=4)
def _cached_lpips_net(weights: Optional[str], device: str) -> LPIPS:
    """One net per (weights, device): a pair per call must not re-read the
    .npz or rebuild the net."""
    return LPIPS(weights, device)


def lpips_pair(x: np.ndarray, y: np.ndarray, weights: Optional[str] = None,
               device="cuda") -> float:
    """One (H, W, 3) pair in [0, 1] -> float."""
    net = _cached_lpips_net(weights, str(resolve_device(device)))
    return float(lpips(net, x[None], y[None])[0])
