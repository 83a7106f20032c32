"""InceptionV3 (FID variant) pool3 features, an nn.Module (NCHW inside).

Counterpart of rcot_tpu/metrics/inception.py, the pool3 path of
pytorch-fid's InceptionV3 (the reference vendors its score code,
fid_score.py): a bilinear resize to 299 (half-pixel centres, no antialias,
on downscale too), [0,1] -> [-1,1], the Inception A/B/C/D/E towers, a
global average pool -> 2048. The FID variant's pools are kept: average
pools divide by the count of real pixels (count_include_pad=False), and
Mixed_7c's pool branch takes the max.

Weights: each BasicConv2d's BatchNorm is folded into its convolution
(conv + bias + ReLU). They load from the .npz tools/port_inception.py
writes (HWIO, `name.w` / `name.b`), the JAX package's file, or fall back to
the same crc32-seeded surrogate, drawn in HWIO order as the JAX package
draws it, then transposed to OIHW. Surrogate FID values compare only with
other surrogate values; a warning says so.
"""

from __future__ import annotations

import os
import warnings
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device

# ------------------------------------------------------------ architecture
# Each conv spec: (name, cin, cout, (kh, kw), (sh, sw), (ph, pw))


def _conv(name, cin, cout, k, s=(1, 1), p=(0, 0)):
    kh, kw = (k, k) if isinstance(k, int) else k
    return (name, cin, cout, (kh, kw), s if isinstance(s, tuple) else (s, s),
            p if isinstance(p, tuple) else (p, p))


def _inception_a(prefix: str, cin: int, pool_features: int) -> List:
    return [
        _conv(f"{prefix}.branch1x1", cin, 64, 1),
        _conv(f"{prefix}.branch5x5_1", cin, 48, 1),
        _conv(f"{prefix}.branch5x5_2", 48, 64, 5, 1, (2, 2)),
        _conv(f"{prefix}.branch3x3dbl_1", cin, 64, 1),
        _conv(f"{prefix}.branch3x3dbl_2", 64, 96, 3, 1, (1, 1)),
        _conv(f"{prefix}.branch3x3dbl_3", 96, 96, 3, 1, (1, 1)),
        _conv(f"{prefix}.branch_pool", cin, pool_features, 1),
    ]


def _inception_b(prefix: str, cin: int) -> List:
    return [
        _conv(f"{prefix}.branch3x3", cin, 384, 3, 2),
        _conv(f"{prefix}.branch3x3dbl_1", cin, 64, 1),
        _conv(f"{prefix}.branch3x3dbl_2", 64, 96, 3, 1, (1, 1)),
        _conv(f"{prefix}.branch3x3dbl_3", 96, 96, 3, 2),
    ]


def _inception_c(prefix: str, cin: int, c7: int) -> List:
    return [
        _conv(f"{prefix}.branch1x1", cin, 192, 1),
        _conv(f"{prefix}.branch7x7_1", cin, c7, 1),
        _conv(f"{prefix}.branch7x7_2", c7, c7, (1, 7), 1, (0, 3)),
        _conv(f"{prefix}.branch7x7_3", c7, 192, (7, 1), 1, (3, 0)),
        _conv(f"{prefix}.branch7x7dbl_1", cin, c7, 1),
        _conv(f"{prefix}.branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0)),
        _conv(f"{prefix}.branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3)),
        _conv(f"{prefix}.branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0)),
        _conv(f"{prefix}.branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3)),
        _conv(f"{prefix}.branch_pool", cin, 192, 1),
    ]


def _inception_d(prefix: str, cin: int) -> List:
    return [
        _conv(f"{prefix}.branch3x3_1", cin, 192, 1),
        _conv(f"{prefix}.branch3x3_2", 192, 320, 3, 2),
        _conv(f"{prefix}.branch7x7x3_1", cin, 192, 1),
        _conv(f"{prefix}.branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3)),
        _conv(f"{prefix}.branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0)),
        _conv(f"{prefix}.branch7x7x3_4", 192, 192, 3, 2),
    ]


def _inception_e(prefix: str, cin: int) -> List:
    return [
        _conv(f"{prefix}.branch1x1", cin, 320, 1),
        _conv(f"{prefix}.branch3x3_1", cin, 384, 1),
        _conv(f"{prefix}.branch3x3_2a", 384, 384, (1, 3), 1, (0, 1)),
        _conv(f"{prefix}.branch3x3_2b", 384, 384, (3, 1), 1, (1, 0)),
        _conv(f"{prefix}.branch3x3dbl_1", cin, 448, 1),
        _conv(f"{prefix}.branch3x3dbl_2", 448, 384, 3, 1, (1, 1)),
        _conv(f"{prefix}.branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1)),
        _conv(f"{prefix}.branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0)),
        _conv(f"{prefix}.branch_pool", cin, 192, 1),
    ]


def conv_specs() -> List:
    """All convolutions of the pool3 path, in torchvision naming."""
    specs = [
        _conv("Conv2d_1a_3x3", 3, 32, 3, 2),
        _conv("Conv2d_2a_3x3", 32, 32, 3),
        _conv("Conv2d_2b_3x3", 32, 64, 3, 1, (1, 1)),
        _conv("Conv2d_3b_1x1", 64, 80, 1),
        _conv("Conv2d_4a_3x3", 80, 192, 3),
    ]
    specs += _inception_a("Mixed_5b", 192, 32)
    specs += _inception_a("Mixed_5c", 256, 64)
    specs += _inception_a("Mixed_5d", 288, 64)
    specs += _inception_b("Mixed_6a", 288)
    specs += _inception_c("Mixed_6b", 768, 128)
    specs += _inception_c("Mixed_6c", 768, 160)
    specs += _inception_c("Mixed_6d", 768, 160)
    specs += _inception_c("Mixed_6e", 768, 192)
    specs += _inception_d("Mixed_7a", 768)
    specs += _inception_e("Mixed_7b", 1280)
    specs += _inception_e("Mixed_7c", 2048)
    return specs


def init_inception_params(weights_path: Optional[str] = None) -> Dict:
    """{name: {"w": OIHW float32 tensor, "b": tensor}} from a folded-BN
    .npz (HWIO), or the deterministic surrogate where there is none."""
    specs = conv_specs()
    hwio = {}
    if weights_path and os.path.exists(weights_path):
        with np.load(weights_path) as z:
            for name, cin, cout, (kh, kw), _s, _p in specs:
                w, b = z[name + ".w"], z[name + ".b"]
                if w.shape != (kh, kw, cin, cout):
                    raise ValueError(f"{weights_path}: {name}.w has shape {w.shape}")
                hwio[name] = (np.asarray(w, np.float32), np.asarray(b, np.float32))
    else:
        warnings.warn(
            "InceptionV3 weights file not found: using a DETERMINISTIC SURROGATE "
            "init. FID values are internally consistent but NOT comparable to "
            "published FID numbers. Port real weights with tools/port_inception.py.")
        for name, cin, cout, (kh, kw), _s, _p in specs:
            rng = np.random.default_rng(zlib.crc32(name.encode()) & 0xFFFFFFFF)
            w = rng.standard_normal((kh, kw, cin, cout)) * np.sqrt(2.0 / (cin * kh * kw))
            hwio[name] = (w.astype(np.float32), np.zeros((cout,), np.float32))
    return {name: {"w": torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
                   "b": torch.from_numpy(b)} for name, (w, b) in hwio.items()}


# ------------------------------------------------------------ forward

def _avgpool3_s1_p1(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average over the real pixels only (FID variant)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _maxpool3_s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


def _maxpool3_s1_p1(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=1, padding=1)  # pads with -inf


class InceptionV3(nn.Module):
    """The pool3 path with folded BatchNorms; forward takes NCHW in [-1, 1]
    at 299 and returns (B, 2048). Parameters are `<conv name>.weight/.bias`
    (dots of the torchvision name as '_')."""

    def __init__(self, weights_path: Optional[str] = None, device="cuda"):
        super().__init__()
        self._spec = {s[0]: s for s in conv_specs()}
        self.convs = nn.ModuleDict()
        for name, p in init_inception_params(weights_path).items():
            _, cin, cout, k, s, pad = self._spec[name]
            conv = nn.Conv2d(cin, cout, k, stride=s, padding=pad)
            with torch.no_grad():
                conv.weight.copy_(p["w"])
                conv.bias.copy_(p["b"])
            self.convs[name.replace(".", "_")] = conv
        self.to(resolve_device(device)).eval()

    def _c(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """BasicConv2d with its BatchNorm folded: conv + bias + ReLU."""
        return F.relu(self.convs[name.replace(".", "_")](x))

    def _block_a(self, p, x):
        b1 = self._c(f"{p}.branch1x1", x)
        b5 = self._c(f"{p}.branch5x5_2", self._c(f"{p}.branch5x5_1", x))
        b3 = self._c(f"{p}.branch3x3dbl_1", x)
        b3 = self._c(f"{p}.branch3x3dbl_3", self._c(f"{p}.branch3x3dbl_2", b3))
        bp = self._c(f"{p}.branch_pool", _avgpool3_s1_p1(x))
        return torch.cat([b1, b5, b3, bp], 1)

    def _block_b(self, p, x):
        b3 = self._c(f"{p}.branch3x3", x)
        bd = self._c(f"{p}.branch3x3dbl_1", x)
        bd = self._c(f"{p}.branch3x3dbl_3", self._c(f"{p}.branch3x3dbl_2", bd))
        return torch.cat([b3, bd, _maxpool3_s2(x)], 1)

    def _block_c(self, p, x):
        b1 = self._c(f"{p}.branch1x1", x)
        b7 = x
        for i in (1, 2, 3):
            b7 = self._c(f"{p}.branch7x7_{i}", b7)
        bd = x
        for i in (1, 2, 3, 4, 5):
            bd = self._c(f"{p}.branch7x7dbl_{i}", bd)
        bp = self._c(f"{p}.branch_pool", _avgpool3_s1_p1(x))
        return torch.cat([b1, b7, bd, bp], 1)

    def _block_d(self, p, x):
        b3 = self._c(f"{p}.branch3x3_2", self._c(f"{p}.branch3x3_1", x))
        b7 = x
        for i in (1, 2, 3, 4):
            b7 = self._c(f"{p}.branch7x7x3_{i}", b7)
        return torch.cat([b3, b7, _maxpool3_s2(x)], 1)

    def _block_e(self, p, x, *, max_pool_branch: bool):
        b1 = self._c(f"{p}.branch1x1", x)
        b3 = self._c(f"{p}.branch3x3_1", x)
        b3 = torch.cat([self._c(f"{p}.branch3x3_2a", b3),
                        self._c(f"{p}.branch3x3_2b", b3)], 1)
        bd = self._c(f"{p}.branch3x3dbl_2", self._c(f"{p}.branch3x3dbl_1", x))
        bd = torch.cat([self._c(f"{p}.branch3x3dbl_3a", bd),
                        self._c(f"{p}.branch3x3dbl_3b", bd)], 1)
        pooled = _maxpool3_s1_p1(x) if max_pool_branch else _avgpool3_s1_p1(x)
        bp = self._c(f"{p}.branch_pool", pooled)
        return torch.cat([b1, b3, bd, bp], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
            x = self._c(name, x)
        x = _maxpool3_s2(x)
        x = self._c("Conv2d_4a_3x3", self._c("Conv2d_3b_1x1", x))
        x = _maxpool3_s2(x)
        for p in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = self._block_a(p, x)
        x = self._block_b("Mixed_6a", x)
        for p in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = self._block_c(p, x)
        x = self._block_d("Mixed_7a", x)
        x = self._block_e("Mixed_7b", x, max_pool_branch=False)
        x = self._block_e("Mixed_7c", x, max_pool_branch=True)
        return x.mean(dim=(2, 3))  # adaptive average pool to 1x1 -> 2048


@torch.inference_mode()
def inception_pool3(net: InceptionV3, x, *, resize_input: bool = True,
                    normalize_input: bool = True) -> torch.Tensor:
    """x: (B, H, W, 3) in [0, 1] (a tensor or numpy array) -> (B, 2048)
    pool3 features on the net's device."""
    dev = next(net.parameters()).device
    x = torch.as_tensor(x, dtype=torch.float32).to(dev).permute(0, 3, 1, 2)
    if resize_input:
        x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                          antialias=False)
    if normalize_input:
        x = 2.0 * x - 1.0
    return net(x.contiguous())
