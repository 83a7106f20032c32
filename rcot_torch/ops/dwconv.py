"""Bias-free depthwise 3x3 SAME convolution on NHWC, forward and backward.

Counterpart of rcot_tpu/ops/pallas_dwconv.py (`dwconv3x3_fwd`, its
`_kernel` at :28-54, and the custom VJP `dwconv3x3_pallas` at :106-138),
the standalone depthwise tier that the JAX package runs with
RCOT_PALLAS_FUSED=0 RCOT_PALLAS_DWCONV=1:

  dwconv3x3(x, taps):  x (B,H,W,C), taps (C,3,3) -> (B,H,W,C)

`DwConv3x3` is the autograd Function. As the JAX custom VJP does, its
backward computes dx with the same kernel on the cotangent, the taps
rotated by 180 degrees (launches counted under `dwconv3x3_dx`), and dw as
the 9-tap pixel reduction sum g * x_shifted, here in PyTorch ops on both
devices (the JAX package does it in jnp outside its kernel). A CUDA tensor
goes to the kernel of csrc/dwconv.cu, a CPU tensor to the plain twin
`dwconv3x3_plain` (ops/conv.py depthwise3x3); the forward's launches are
counted under `dwconv3x3`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..kernels import build
from .conv import depthwise3x3


def dwconv3x3_plain(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The plain twin: cuDNN's (or the CPU's) depthwise convolution."""
    return depthwise3x3(x, taps)


def _launch(x: torch.Tensor, taps: torch.Tensor, name: str) -> torch.Tensor:
    if not x.is_cuda:
        return dwconv3x3_plain(x, taps)
    b, h, w, c = x.shape
    build.check_arg("x", x, (b, h, w, c), x.device)
    build.check_arg("taps", taps, (c, 3, 3), x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        build.call("rcot_dwconv3x3", x.data_ptr(), taps.data_ptr(), out.data_ptr(),
                   b, h, w, c, build.stream())
    build.LAUNCHES[name] += 1
    return out


def dwconv3x3_fwd(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """x (B,H,W,C), taps (C,3,3) -> (B,H,W,C), zeros outside the image."""
    return _launch(x, taps, "dwconv3x3")


def dwconv3x3_dx(g: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """dx of dwconv3x3_fwd for the cotangent g: the forward on g with the
    taps rotated by 180 degrees (pallas_dwconv.py:118-120)."""
    return _launch(g, taps.flip(1, 2).contiguous(), "dwconv3x3_dx")


def dwconv3x3_bwd(x: torch.Tensor, taps: torch.Tensor, g: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of dwconv3x3_fwd for the cotangent g -> (dx, dtaps):
    dwconv3x3_dx, and dtaps[c, i, j] = sum over pixels of
    g[b, y, x, c] * x[b, y + i - 1, x + j - 1, c] (pallas_dwconv.py:121-134)."""
    dx = dwconv3x3_dx(g, taps)
    h, w = x.shape[1:3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    dtaps = torch.stack([(g * xp[:, i:i + h, j:j + w]).sum(dim=(0, 1, 2))
                         for i in range(3) for j in range(3)], dim=-1)
    return dx, dtaps.reshape(-1, 3, 3)


class DwConv3x3(torch.autograd.Function):
    """dwconv3x3_fwd with its backward; saves x and the taps
    (pallas_dwconv.py _fwd)."""

    @staticmethod
    def forward(ctx, x, taps):
        ctx.save_for_backward(x, taps)
        return dwconv3x3_fwd(x, taps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # a strided slice of torch.chunk's backward may arrive here
        return dwconv3x3_bwd(*ctx.saved_tensors, g.contiguous())


def dwconv3x3(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The bias-free depthwise 3x3 SAME conv, differentiable: x (B,H,W,C),
    taps (C,3,3) -> (B,H,W,C)."""
    return DwConv3x3.apply(x, taps)
