"""Fused MDTA attend on (B, heads, c, N): softmax(q_hat k_hat^T * t) @ v.

Counterpart of rcot_tpu/ops/pallas_mdta.py (`mdta_attend_fused`, its
`_kernel` at :41-76, and the custom VJP `mdta_attend_pallas` at
:138-156), the attention core that the JAX package runs with
RCOT_PALLAS_MDTA=1. Per (b, head), q and k are L2-normalised along N (eps
1e-12, as F.normalize), attn = softmax((q_hat k_hat^T) * temperature[head])
is (c, c), and out = attn @ v. On a CUDA tensor the whole attend, softmax
included, is one call into csrc/mdta.cu (two launches, counted once as
`mdta_attend`); a CPU tensor takes the plain twin `mdta_attend_plain`.

Backward. The JAX package has no backward kernel for this op: its VJP
saves (q, k, v, temperature) and differentiates the jnp formula again
(pallas_mdta.py:143-153). `MdtaAttend` does the same, by autograd through
`mdta_attend_plain`, which on the card is cuBLAS products and elementwise
ops. That is the JAX package's own design, not a fallback; a fused
backward kernel is later performance work (ROADMAP.md, Queue 2).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..kernels import build
from .block import _vjp_plain

L2_EPS = 1e-12


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    norm = x.square().sum(dim=-1, keepdim=True).sqrt()
    return x / norm.clamp_min(L2_EPS)


def mdta_attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      temperature: torch.Tensor) -> torch.Tensor:
    """Transposed attention on (B, heads, c, HW) tensors -> same shape;
    temperature (heads, 1, 1)."""
    q = _l2_normalize(q)
    k = _l2_normalize(k)
    attn = torch.einsum("bhcn,bhdn->bhcd", q, k) * temperature
    attn = attn.softmax(dim=-1)
    return torch.einsum("bhcd,bhdn->bhcn", attn, v)


def mdta_attend_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    temperature: torch.Tensor) -> torch.Tensor:
    """q, k, v (B, heads, c, N), temperature (heads, 1, 1) -> (B, heads, c, N)."""
    if not q.is_cuda:
        return mdta_attend_plain(q, k, v, temperature)
    b, heads, c, n = q.shape
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_arg(name, t, (b, heads, c, n), dev)
    temp = temperature.reshape(-1)
    build.check_arg("temperature", temp, (heads,), dev)
    if c > 128:
        raise ValueError(f"head width {c} > 128 is not supported")
    out = torch.empty_like(q)
    ws = torch.empty(b * heads * c * (c + 2), device=dev)  # G, sum q^2, sum k^2
    with torch.cuda.device(dev):
        build.call("rcot_mdta_attend", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   temp.data_ptr(), out.data_ptr(), ws.data_ptr(), b * heads, heads,
                   c, n, build.stream())
    build.LAUNCHES["mdta_attend"] += 1
    return out


class MdtaAttend(torch.autograd.Function):
    """mdta_attend_fwd; saves (q, k, v, temperature) and recomputes through
    the plain formula in the backward (pallas_mdta.py _fwd/_bwd)."""

    @staticmethod
    def forward(ctx, q, k, v, temperature):
        ctx.save_for_backward(q, k, v, temperature)
        return mdta_attend_fwd(q, k, v, temperature)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _vjp_plain(mdta_attend_plain, ctx.saved_tensors, g)


def mdta_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                temperature: torch.Tensor) -> torch.Tensor:
    """The fused MDTA attend, differentiable in q, k, v and the temperature."""
    return MdtaAttend.apply(q, k, v, temperature)
