"""Total-variation-style edge map (counterpart of rcot_tpu/ops/edges.py).

Reference: util/image_utils.py:14-45 `EdgeComputation`, unused by its main
path. The absolute difference of each pair of horizontal neighbours is
added to both pixels of the pair (likewise vertically); the result is
summed over channels and divided by 3 (a hard-coded RGB assumption, kept)
and then by 4 (the four contributions).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def edge_map(x: torch.Tensor) -> torch.Tensor:
    """x: (..., H, W, C) float -> (..., H, W, 1)."""
    dx = (x[..., :, 1:, :] - x[..., :, :-1, :]).abs()  # (..., H, W-1, C)
    dy = (x[..., 1:, :, :] - x[..., :-1, :, :]).abs()  # (..., H-1, W, C)
    # F.pad lists (last dim before, after), then the one before it, ...
    y = (F.pad(dx, (0, 0, 1, 0)) + F.pad(dx, (0, 0, 0, 1))
         + F.pad(dy, (0, 0, 0, 0, 1, 0)) + F.pad(dy, (0, 0, 0, 0, 0, 1)))
    # the reference divides the channel sum by a literal 3 whatever C is
    return y.sum(dim=-1, keepdim=True) / 3.0 / 4.0
