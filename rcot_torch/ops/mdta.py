"""Fused MDTA attend on (B, heads, c, N): softmax(q_hat k_hat^T * t) @ v.

Counterpart of rcot_tpu/ops/pallas_mdta.py (`mdta_attend_fused`, its
`_kernel` at :41-76, and the custom VJP `mdta_attend_pallas` at
:138-156), the attention core that the JAX package runs with
RCOT_PALLAS_MDTA=1. Per (b, head), q and k are L2-normalised along N (eps
1e-12, as F.normalize), attn = softmax((q_hat k_hat^T) * temperature[head])
is (c, c), and out = attn @ v. On a CUDA tensor the whole attend, softmax
included, is one call into csrc/mdta.cu (three launches: the Gram's
fixed-order partials on the tensor cores, their sum and the softmax, the
apply; a fourth adds the slots of a head wider than 128 channels), counted
once as `mdta_attend`, on the plan of `mdta_plan`; a CPU tensor takes the
plain twin `mdta_attend_plain`.

Backward. The JAX package has no backward kernel for this op: its VJP
saves (q, k, v, temperature) and differentiates the jnp formula again
(pallas_mdta.py:143-153). `MdtaAttend` does the same, by autograd through
`mdta_attend_plain`, which on the card is cuBLAS products and elementwise
ops. That is the JAX package's own design, not a fallback; a fused
backward kernel is later performance work (ROADMAP.md, Queue 2).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ..kernels import build
from .block import _vjp_plain
from .gram import _cdiv, channel_blocks, gram_pairs_plan, pair_runs, sm_count

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


# The launch plan of csrc/mdta.cu, a pure function of the shape and the SM
# count. The Gram's pixel ranges are the Gram core's (ops/gram.py
# gram_plan: about one block an SM, whole 64-pixel stages, at most 512
# pixels a range, since a range's error grows with its pixels), its
# channel-block pairs counted as heads; the apply walks runs of
# MDTA_APPLY_TILE-pixel tiles, two blocks an SM where a channel block is at
# most MDTA_APPLY_TWO_MAX_CH wide (98 KB of shared memory a block at 48
# channels) and one above; the softmax sums each row's ranges with up to
# MDTA_SOFTMAX_WARPS warps, a few ranges each (at serve L1, 128 ranges:
# four a warp, their loads in flight together).
MDTA_APPLY_TILE = 128
MDTA_APPLY_TWO_MAX_CH = 48
MDTA_SOFTMAX_WARPS = 32


class MdtaPlan(NamedTuple):
    splits: int        # pixel ranges of each (bh, channel-block pair)
    per: int           # pixels a range: range s is [s * per, min((s + 1) * per, N))
    blocks: int        # channel blocks of a head (ops/gram.py channel_blocks)
    width: int         # their width, the last one's at most
    apply_blocks: int  # apply blocks of each channel-block pair
    apply_per: int     # 128-pixel tiles an apply block walks
    warps: int         # softmax warps a row


@functools.lru_cache(maxsize=None)
def mdta_plan(b: int, heads: int, c: int, n: int, n_sm: int) -> MdtaPlan:
    """The plan of one mdta_attend_fwd call on (b, heads, c, n)."""
    blocks, width = channel_blocks(c)
    splits, per = gram_pairs_plan(b, n, heads, c, n_sm)
    apply_blocks, apply_per = pair_runs(b * heads * _cdiv(n, MDTA_APPLY_TILE), c,
                                        MDTA_APPLY_TWO_MAX_CH, n_sm)
    return MdtaPlan(splits, per, blocks, width, apply_blocks, apply_per,
                    min(splits, MDTA_SOFTMAX_WARPS))


def mdta_workspace_numel(plan: MdtaPlan, b: int, heads: int, c: int, n: int) -> int:
    """Floats of a call's one workspace: the slots of out (one per channel
    block, where a head is more than one), a record G | nq | nk per range
    and bh, and P (bh, c, c)."""
    bh = b * heads
    slots = plan.blocks * bh * c * n if plan.blocks > 1 else 0
    return slots + plan.splits * bh * (c * c + 2 * c) + bh * c * c


def mdta_vec(n: int, *ptrs: int) -> int:
    """Floats a copy of q, k and v (and a store of out) takes: 4 where every
    row starts 16 bytes aligned (N % 4 == 0, aligned tensors), else 1."""
    return 4 if n % 4 == 0 and all(p % 16 == 0 for p in ptrs) else 1


def mdta_attend_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    temperature: torch.Tensor) -> torch.Tensor:
    """q, k, v (B, heads, c, N), temperature (heads, 1, 1) -> (B, heads, c, N).
    On the card the sums run in a fixed order: two calls give the same
    bits."""
    if not q.is_cuda:
        return mdta_attend_plain(q, k, v, temperature)
    b, heads, c, n = q.shape
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_arg(name, t, (b, heads, c, n), dev)
    temp = temperature.reshape(-1)
    build.check_arg("temperature", temp, (heads,), dev)
    plan = mdta_plan(b, heads, c, n, sm_count(dev.index))
    out = torch.empty_like(q)
    ws = torch.empty(mdta_workspace_numel(plan, b, heads, c, n), device=dev)
    vec = mdta_vec(n, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(dev):
        build.call("rcot_mdta_attend", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   temp.data_ptr(), out.data_ptr(), ws.data_ptr(), b * heads, heads,
                   c, n, plan.splits, plan.per, plan.width, plan.apply_blocks,
                   plan.apply_per, plan.warps, vec, build.stream())
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
