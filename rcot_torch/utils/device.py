"""Device selection: every entry point names its device; CUDA is the default
and its absence is an error, never a silent move to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was asked for but torch.cuda.is_available() "
            "is false; pass device='cpu' to run the plain PyTorch path")
    return dev
