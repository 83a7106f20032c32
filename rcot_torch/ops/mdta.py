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

bf16 (q, k and v bf16, the temperature fp32). The forward is the kernel's
arithmetic on widened values: G, the norms and P in fp32, out rounded to
bf16 once (pallas_mdta.py:56-57, :73, :76). On the card that is
`mdta_attend_bf16` (csrc/mdta.cu on bf16 tiles), on the CPU its twin
`mdta_attend_bf16_plain`. The backward differentiates the jnp formula as
JAX runs it on the bf16 residuals (rcot_tpu/ops/attention.py:43-53),
which rounds where the forward does not: `mdta_attend_jnp_bf16`, with
q-hat, k-hat and attn rounded to bf16. Where the JAX wrapper takes that
formula for the forward too (`mdta_route`: no legal chunk of N, or c % 8
!= 0; pallas_mdta.py:79-95), so does the port, on either device, counted
as `mdta_attend_jnp_bf16`. fp32 takes the kernel at every shape.
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
BF16 = torch.bfloat16
# the Pallas kernel's chunks of N (pallas_mdta.py _CHUNKS): the trailing
# block dim a multiple of 128, or N itself up to 2048
JAX_CHUNKS = (2048, 1024, 512, 256, 128)


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


def mdta_attend_bf16_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           temperature: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's arithmetic (pallas_mdta.py _kernel): q, k and v
    widened, G = q k^T and the sums of squares in fp32, logits G / (max(|q|,
    eps) max(|k|, eps)) * t, the softmax in fp32, out = P v rounded to v's
    dtype once."""
    qf, kf, vf = q.float(), k.float(), v.float()
    g = torch.einsum("bhcn,bhdn->bhcd", qf, kf)
    qn = qf.square().sum(dim=-1).sqrt().clamp_min(L2_EPS)
    kn = kf.square().sum(dim=-1).sqrt().clamp_min(L2_EPS)
    logits = g / (qn.unsqueeze(-1) * kn.unsqueeze(-2)) * temperature.float()
    return torch.einsum("bhcd,bhdn->bhcn", logits.softmax(dim=-1), vf).to(v.dtype)


def _l2_normalize_rounded(x: torch.Tensor) -> torch.Tensor:
    """rcot_tpu/ops/attention.py _l2_normalize in x's dtype: the square
    rounded, its sum taken in fp32 and rounded (jnp.sum's upcast), the
    square root, the clamp and the division each rounded."""
    norm = x.square().float().sum(dim=-1, keepdim=True).to(x.dtype).sqrt()
    return x / norm.clamp_min(L2_EPS)


def mdta_attend_jnp_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         temperature: torch.Tensor) -> torch.Tensor:
    """The jnp formula (rcot_tpu/ops/attention.py:43-53) on bf16 q, k, v:
    q-hat and k-hat rounded, both products of bf16 values taken in fp32
    (widened first: bf16 values are exact in fp32), the softmax in fp32,
    attn rounded to bf16, out rounded once. Differentiable; the
    temperature stays fp32."""
    qh, kh = _l2_normalize_rounded(q), _l2_normalize_rounded(k)
    attn = torch.einsum("bhcn,bhdn->bhcd", qh.float(), kh.float()) * temperature.float()
    attn = attn.softmax(dim=-1).to(v.dtype)
    return torch.einsum("bhcd,bhdn->bhcn", attn.float(), v.float()).to(v.dtype)


def mdta_route(c: int, n: int) -> str:
    """Which forward the JAX wrapper takes at (c, N) (pallas_mdta.py:79-95):
    "jnp" where _pick_chunk finds no chunk (N > 2048 and no multiple of
    128) or c % 8 != 0, else "kernel". The port follows it in bf16."""
    chunk = next((t for t in JAX_CHUNKS if n % t == 0), n if n <= 2048 else 0)
    return "jnp" if chunk == 0 or c % 8 != 0 else "kernel"


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


def mdta_vec(n: int, *ptrs: int, itemsize: int = 4) -> int:
    """Elements a copy of q, k and v (and a store of out) takes: 16 bytes'
    worth (4 floats, 8 bf16) where every row starts 16 bytes aligned (N a
    multiple of it, aligned tensors), else 1."""
    wide = 16 // itemsize
    return wide if n % wide == 0 and all(p % 16 == 0 for p in ptrs) else 1


def mdta_attend_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    temperature: torch.Tensor) -> torch.Tensor:
    """q, k, v (B, heads, c, N), temperature (heads, 1, 1) -> (B, heads, c, N).
    On the card the sums run in a fixed order: two calls give the same
    bits."""
    bf16 = q.dtype == BF16
    if not q.is_cuda:
        return (mdta_attend_bf16_plain if bf16 else mdta_attend_plain)(q, k, v, temperature)
    b, heads, c, n = q.shape
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_arg(name, t, (b, heads, c, n), dev, build.kernel_dtype(q))
    temp = temperature.reshape(-1)
    build.check_arg("temperature", temp, (heads,), dev)
    plan = mdta_plan(b, heads, c, n, sm_count(dev.index))
    out = torch.empty_like(q)
    ws = torch.empty(mdta_workspace_numel(plan, b, heads, c, n), device=dev)
    vec = mdta_vec(n, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   itemsize=q.element_size())
    name = "mdta_attend_bf16" if bf16 else "mdta_attend"
    with torch.cuda.device(dev):
        build.call("rcot_" + name, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   temp.data_ptr(), out.data_ptr(), ws.data_ptr(), b * heads, heads,
                   c, n, plan.splits, plan.per, plan.width, plan.apply_blocks,
                   plan.apply_per, plan.warps, vec, build.stream())
    build.LAUNCHES[name] += 1
    return out


class MdtaAttend(torch.autograd.Function):
    """mdta_attend_fwd; saves (q, k, v, temperature) and recomputes through
    the plain formula in the backward (pallas_mdta.py _fwd/_bwd): in bf16
    the jnp formula's rounding points (mdta_attend_jnp_bf16)."""

    @staticmethod
    def forward(ctx, q, k, v, temperature):
        ctx.save_for_backward(q, k, v, temperature)
        return mdta_attend_fwd(q, k, v, temperature)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q = ctx.saved_tensors[0]
        plain = mdta_attend_jnp_bf16 if q.dtype == BF16 else mdta_attend_plain
        return _vjp_plain(plain, ctx.saved_tensors, g)


def mdta_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                temperature: torch.Tensor) -> torch.Tensor:
    """The fused MDTA attend, differentiable in q, k, v and the temperature.
    In bf16, at a shape where the JAX wrapper takes its jnp formula
    (mdta_route), that formula, counted as mdta_attend_jnp_bf16."""
    if q.dtype == BF16 and mdta_route(q.shape[2], q.shape[3]) == "jnp":
        build.LAUNCHES["mdta_attend_jnp_bf16"] += 1
        return mdta_attend_jnp_bf16(q, k, v, temperature)
    return MdtaAttend.apply(q, k, v, temperature)
