"""PSNR, the reference's SSIM and a running mean (rcot_tpu/metrics/quality.py).

- psnr: skimage peak_signal_noise_ratio semantics with a given data range.
- ssim_ref_single: the reference's custom SSIM (evaluate.py:53-73): a
  cv2.getGaussianKernel(2, 1) outer-product window, cv2.filter2D with its
  default reflect-101 border, a [5:-5, 5:-5] crop, C1 = (0.01*255)^2,
  C2 = (0.03*255)^2, inputs in [0, 255]. Computed on [0, 1] with C1 and
  C2 scaled by 1/255^2, which leaves SSIM unchanged and keeps fp32
  cancellation in sigma = filt(x^2) - mu^2 small.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = (pred.float() - target.float()).square().mean()
    return 10.0 * torch.log10(data_range ** 2 / mse)


def _gaussian_kernel_cv2(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel parity."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).reshape(-1, 1)


def _filter2d_reflect101(img: torch.Tensor, window: np.ndarray) -> torch.Tensor:
    """cv2.filter2D with BORDER_REFLECT_101 on (H, W, C) or (H, W): the
    kernel is anchored at ((k-1)//2, (k-1)//2), so an even k pads
    k-1-anchor before and anchor after."""
    k = window.shape[0]
    anchor = (k - 1) // 2
    lo, hi = k - 1 - anchor, anchor
    x = img[..., None] if img.dim() == 2 else img
    c = x.shape[-1]
    x = x.permute(2, 0, 1)[None]  # (1, C, H, W)
    x = F.pad(x, (lo, hi, lo, hi), mode="reflect")
    w = torch.as_tensor(window, dtype=torch.float32, device=img.device)
    y = F.conv2d(x, w[None, None].expand(c, 1, k, k).contiguous(), groups=c)
    y = y[0].permute(1, 2, 0)
    return y[..., 0] if img.dim() == 2 else y


def ssim_ref_single(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    img1 = img1.float() / 255.0
    img2 = img2.float() / 255.0
    window = _gaussian_kernel_cv2(2, 1.0)
    window2d = np.outer(window, window)
    c1, c2 = 0.01 ** 2, 0.03 ** 2

    def filt(x):
        return _filter2d_reflect101(x, window2d)[5:-5, 5:-5]

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = filt(img1 ** 2) - mu1_sq
    sigma2_sq = filt(img2 ** 2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()


class AverageMeter:
    """Running mean (reference: util/val_utils.py:8-26)."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else float("nan")
