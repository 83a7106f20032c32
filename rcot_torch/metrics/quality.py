"""PSNR and SSIM variants, the NIQE facade, a timer and a running mean
(rcot_tpu/metrics/quality.py).

- psnr: skimage peak_signal_noise_ratio semantics with a given data range.
- psnr_peak_max: the reference's data-dependent-peak PSNR (evaluate.py:42-51).
- ssim_ref_single: the reference's custom SSIM (evaluate.py:53-73): a
  cv2.getGaussianKernel(2, 1) outer-product window, cv2.filter2D with its
  default reflect-101 border, a [5:-5, 5:-5] crop, C1 = (0.01*255)^2,
  C2 = (0.03*255)^2, inputs in [0, 255]. Computed on [0, 1] with C1 and
  C2 scaled by 1/255^2, which leaves SSIM unchanged and keeps fp32
  cancellation in sigma = filt(x^2) - mu^2 small.
- ssim_skimage_single: skimage structural_similarity defaults (7x7 uniform
  window, VALID, unbiased N/(N-1) moments, per-channel mean).
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from . import niqe as _niqe


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = (pred.float() - target.float()).square().mean()
    return 10.0 * torch.log10(data_range ** 2 / mse)


def psnr_peak_max(pred: torch.Tensor, target: torch.Tensor,
                  shave_border: int = 0) -> torch.Tensor:
    """20*log10(pred.max() / rmse) with an optional border shave. The shave
    is axis-aware (H, W = the leading two of the last three dims), so a
    batched (B,H,W,C) input shaves the image, not the batch; identical
    images give the 100 dB cap instead of inf."""
    if shave_border:
        s = shave_border
        hw = pred.dim() - 3 if pred.dim() >= 3 else 0  # index of the H axis
        sl = [slice(None)] * pred.dim()
        sl[hw] = sl[hw + 1] = slice(s, -s)
        pred, target = pred[tuple(sl)], target[tuple(sl)]
    rmse = (pred.float() - target.float()).square().mean().sqrt()
    peak = 20.0 * torch.log10(pred.max().float() / rmse)
    return torch.where(rmse == 0, torch.full_like(peak, 100.0), peak)


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


def ssim_skimage_single(img1: torch.Tensor, img2: torch.Tensor,
                        data_range: float = 1.0) -> torch.Tensor:
    """SSIM of one (H, W) or (H, W, C) pair, skimage defaults: K1 = 0.01,
    K2 = 0.03, a 7x7 uniform window over the valid region, unbiased
    moments; multichannel is the mean of the per-channel means."""
    win = 7
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    cov_norm = win * win / (win * win - 1.0)

    def planes(x):  # (C, 1, H, W)
        x = x.float()
        return (x[None] if x.dim() == 2 else x.permute(2, 0, 1))[:, None]

    a, b = planes(img1), planes(img2)
    kernel = torch.full((1, 1, win, win), 1.0 / (win * win), device=a.device)

    def filt(x):
        return F.conv2d(x, kernel)

    ux, uy = filt(a), filt(b)
    vx = cov_norm * (filt(a * a) - ux * ux)
    vy = cov_norm * (filt(b * b) - uy * uy)
    vxy = cov_norm * (filt(a * b) - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return s.mean(dim=(1, 2, 3)).mean()


def compute_psnr_ssim(recovered: torch.Tensor, clean: torch.Tensor,
                      data_range: float = 1.0):
    """Per-sample skimage PSNR and SSIM of (B, H, W, C) in [0, data_range],
    averaged (reference: util/val_utils.py:50-66). -> (psnr, ssim, B)."""
    b = recovered.shape[0]
    ps = torch.stack([psnr(recovered[i], clean[i], data_range) for i in range(b)])
    ss = torch.stack([ssim_skimage_single(recovered[i], clean[i], data_range)
                      for i in range(b)])
    return ps.mean(), ss.mean(), b


def niqe(img, model=None, model_path: str = None) -> float:
    """No-reference NIQE of one image (metrics/niqe.py). The pristine model
    is `model` (a fit_niqe_model dict), or read from `model_path` or the
    RCOT_NIQE_MODEL environment variable (a .mat or .npz params file)."""
    if model is None:
        path = model_path or os.environ.get("RCOT_NIQE_MODEL")
        if not path:
            raise ValueError(
                "NIQE needs a pristine model: pass model=fit_niqe_model(...) "
                "or model_path=/RCOT_NIQE_MODEL= a niqe params .mat/.npz")
        model = _load_niqe_model_cached(path)
    return _niqe.niqe(np.asarray(img), model)


@functools.lru_cache(maxsize=4)
def _load_niqe_model_cached(path: str):
    # an N-image eval through the facade reads the params file once
    return _niqe.load_niqe_model(path)


class Timer:
    """Cumulative wall-clock timer (reference: util/val_utils.py:76-97)."""

    def __init__(self):
        self.acc = 0.0
        self.t0 = time.time()

    def tic(self) -> None:
        self.t0 = time.time()

    def toc(self, restart: bool = False) -> float:
        diff = time.time() - self.t0
        if restart:
            self.t0 = time.time()
        return diff

    def hold(self) -> None:
        self.acc += self.toc()

    def release(self) -> float:
        ret, self.acc = self.acc, 0.0
        return ret


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
