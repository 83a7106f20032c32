"""Augmentation and degradation synthesis on the device.

Counterpart of rcot_tpu/data/degradations.py:27-75. The host only decodes
and crops uint8 patches; the batched augment and the Gaussian noise run on
the batch's device:

- dihedral augmentation: mode uniform in 1..7, never the identity (the
  reference's draw, util/image_utils.py:177-182); a paired sample's two
  images share one mode. Modes: 1 flipud; 2 rot90; 3 rot90 + flipud;
  4 rot180; 5 rot180 + flipud; 6 rot270; 7 rot270 + flipud.
- noise for denoise ids 0/1/2 at sigma 15/25/50: clip(clean + N(0,1) sigma,
  0, 255), floored (numpy's uint8 truncation), then / 255.

Random draws come from an explicit torch.Generator, or are passed in
(`modes`, `noise`), so a test can hand in the JAX package's draws. The
batch comes out in fp32, or in bf16 for bf16 training, each image divided
by 255 in fp32 and then rounded (rcot_tpu/data/degradations.py:69-75).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

# sigma per de_id (reference: util/degradation_utils.py:29-38)
SIGMAS = (15.0, 25.0, 50.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def dihedral(x: torch.Tensor, mode: int) -> torch.Tensor:
    """Dihedral transform `mode` (0..7) of one (H, W, C) image, H == W;
    rot90 turns counterclockwise in the (H, W) plane, as numpy's does."""
    y = torch.rot90(x, k=mode // 2, dims=(0, 1))
    return torch.flip(y, dims=(0,)) if mode % 2 else y


@functools.lru_cache(maxsize=8)
def _dihedral_index(size: int, device: torch.device) -> torch.Tensor:
    """(8, size * size) source pixel of every output pixel, per mode."""
    grid = torch.arange(size * size, device=device).reshape(size, size, 1)
    return torch.stack([dihedral(grid, m).reshape(-1) for m in range(8)])


def dihedral_batch(x: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    """dihedral(x[i], modes[i]) for a (B, P, P, C) batch, as one gather on
    the device (no host sync on the modes)."""
    b, p, _, c = x.shape
    index = _dihedral_index(p, x.device)[modes.long()]  # (B, P*P)
    flat = x.reshape(b, p * p, c)
    return flat.gather(1, index[..., None].expand(b, p * p, c)).reshape(b, p, p, c)


def augment_and_degrade(clean: torch.Tensor, degraded: torch.Tensor,
                        de_id: torch.Tensor, *,
                        generator: Optional[torch.Generator] = None,
                        modes: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None,
                        out_dtype: torch.dtype = torch.float32
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """clean, degraded (B, P, P, C) uint8 (degraded == clean for denoise
    ids); de_id (B,) -> (degraded, clean) in [0, 1], out_dtype. `modes`
    (B,) and `noise` (B, P, P, C), when not given, are drawn from
    `generator` in that order."""
    dev = clean.device
    b = clean.shape[0]
    if modes is None:
        modes = torch.randint(1, 8, (b,), generator=generator, device=dev)
    clean = dihedral_batch(clean, modes).float()
    degraded = dihedral_batch(degraded, modes).float()
    if noise is None:
        noise = torch.randn(clean.shape, generator=generator, device=dev)
    sigma = torch.tensor(SIGMAS, device=dev)[de_id.long().clamp(0, 7)]
    noisy = torch.floor((clean + noise * sigma[:, None, None, None]).clamp(0.0, 255.0))
    is_noise = (de_id < 3)[:, None, None, None]
    degraded = torch.where(is_noise, noisy, degraded)
    return (degraded / 255.0).to(out_dtype), (clean / 255.0).to(out_dtype)
