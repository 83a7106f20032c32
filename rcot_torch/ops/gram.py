"""Transpose-free MDTA attention core: Gram and apply kernels.

Counterpart of rcot_tpu/ops/pallas_gram.py. MDTA's
attention matrix is channel by channel and both the Gram matrix and the L2
norms are plain sums over pixels, so they are computed on the packed NHWC
qkv = [q | k | v] without any head transpose:

  mdta_gram_fwd:  G = q^T k, nq = sum q^2, nk = sum k^2 per (b, head)
  _glue:          attn = softmax(G / (max(|q|, eps) max(|k|, eps)) * temp)
                  on (B, heads, ch, ch), plain PyTorch ops
  attn_apply_fwd: out[..., head h] = v_h @ attn[h]^T

One autograd Function, MdtaCore, spans the whole core, as the JAX custom
VJP `_mdta_core` does. Its backward rebuilds the glue, runs the apply
backward (dv and dattn), differentiates the glue by autograd (dG, dnq,
dnk, dtemperature), runs the Gram backward (d[q|k]) and concatenates
dqkv = [dq | dk | dv].

Each kernel wrapper launches its CUDA kernel (csrc/gram.cu) for a CUDA
tensor and runs its plain twin for a CPU tensor; nothing else. The backward
twins differentiate the forward twins by autograd.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from ..kernels import build

L2_EPS = 1e-12


# ------------------------------------------------------------------ plain

def mdta_gram_plain(qkv: torch.Tensor, num_heads: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    ch = c // num_heads
    q = qkv[..., :c].reshape(b, h * w, num_heads, ch)
    k = qkv[..., c:2 * c].reshape(b, h * w, num_heads, ch)
    gram = torch.einsum("bnhc,bnhd->bhcd", q, k)
    return gram, q.square().sum(dim=1), k.square().sum(dim=1)


def attn_apply_plain(qkv: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    heads, ch = attn.shape[1], attn.shape[2]
    v = qkv[..., 2 * c:].reshape(b, h, w, heads, ch)
    return torch.einsum("bxyhd,bhcd->bxyhc", v, attn).reshape(b, h, w, c)


def mdta_gram_bwd_plain(qkv, dgram, dnq, dnk, num_heads):
    """-> d[q|k] (B,H,W,2C), by autograd through mdta_gram_plain."""
    with torch.enable_grad():
        leaf = qkv.detach().requires_grad_()
        outs = mdta_gram_plain(leaf, num_heads)
        (dqkv,) = torch.autograd.grad(outs, leaf, (dgram, dnq, dnk))
    return dqkv[..., :2 * (qkv.shape[-1] // 3)]


def attn_apply_bwd_plain(qkv, attn, g):
    """-> (dv (B,H,W,C), dattn (B,heads,ch,ch)), by autograd through
    attn_apply_plain."""
    with torch.enable_grad():
        leaves = [qkv.detach().requires_grad_(), attn.detach().requires_grad_()]
        dqkv, dattn = torch.autograd.grad(attn_apply_plain(*leaves), leaves, g)
    return dqkv[..., 2 * (qkv.shape[-1] // 3):], dattn


# ---------------------------------------------------------------- kernels

def _check_head_width(ch: int) -> None:
    if ch > 128:
        raise ValueError(f"head width {ch} > 128 is not supported")


# The launch plans of every kernel of csrc/gram.cu that splits its work
# by the card's size; the kernels take them as they are. Each is a pure
# function of the shape and the SM count (sm_count, read once per device).
#
# The Gram forward: each (b, head)'s pixels are split into contiguous
# ranges, one block each, so that the blocks of all (b, head) come to about
# GRAM_BLOCKS_PER_SM an SM. A range holds a multiple of GRAM_PIXEL_STEP
# pixels (the kernel's stage is 64 or 32) and at most GRAM_MAX_PIXELS: a
# block's error grows with the pixels it sums (on the card, 3.2e-6 of
# max|G| with ranges of up to 512 pixels, 6.6e-6 with up to 1,024; PERF.md),
# and the cap holds it there at any image size and batch. A split
# (b, head) sums its ranges' partials in a second launch, in order.
# The apply forward: a grid of about as many blocks an SM as fit its shared
# memory, at most two (two up to ch = APPLY_TWO_MAX_CH, ~100 KB a block;
# one above), each walking a contiguous run of APPLY_TILE-pixel tiles (the
# kernel's kApplyTP). On the card (PERF.md, PR 5) the Gram ran faster with
# one block an SM than with two at every width; the apply with two where
# two fit, and with one where they would run in two waves.
GRAM_BLOCKS_PER_SM = 1
GRAM_PIXEL_STEP = 64
GRAM_MAX_PIXELS = 512
APPLY_TWO_MAX_CH = 48
APPLY_TILE = 128
# The apply backward's dattn = sum over pixels of g^T v: about
# DATTN_BLOCKS_PER_SM blocks an SM over all (b, head), each at least one
# DATTN_STAGE-pixel stage (the kernel's kGramTile).
DATTN_BLOCKS_PER_SM = 4
DATTN_STAGE = 32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gram_plan(b: int, hw: int, heads: int, n_sm: int) -> Tuple[int, int]:
    """-> (splits, pixels per split) of the Gram forward's pixel ranges:
    split s of each (b, head) covers pixels [s * per, min((s + 1) * per, hw)).
    With n = GRAM_BLOCKS_PER_SM * n_sm, splits * b * heads is at most
    n + b * heads - 1 while b * heads <= n, and splits is 1 once b * heads
    alone comes to n, unless ranges that short would pass GRAM_MAX_PIXELS:
    then they hold GRAM_MAX_PIXELS each."""
    want = max(1, _cdiv(GRAM_BLOCKS_PER_SM * n_sm, b * heads))
    per = _cdiv(_cdiv(hw, want), GRAM_PIXEL_STEP) * GRAM_PIXEL_STEP
    per = min(per, GRAM_MAX_PIXELS)
    return _cdiv(hw, per), per


def apply_plan(b: int, hw: int, heads: int, ch: int, n_sm: int) -> Tuple[int, int]:
    """-> (blocks, tiles per block) of the apply forward: tile t of the
    b * heads * ceil(hw / APPLY_TILE) covers pixels [i * APPLY_TILE, ...)
    of (b, head) t // ceil(hw / APPLY_TILE), i = t % that, and block k
    takes tiles [k * per, min((k + 1) * per, tiles)). At most
    two blocks an SM (one where ch > APPLY_TWO_MAX_CH), none of them
    empty."""
    tiles = b * heads * _cdiv(hw, APPLY_TILE)
    per_sm = 2 if ch <= APPLY_TWO_MAX_CH else 1
    per = _cdiv(tiles, min(tiles, per_sm * n_sm))
    return _cdiv(tiles, per), per


def dattn_plan(b: int, hw: int, heads: int, n_sm: int) -> Tuple[int, int]:
    """-> (blocks per (b, head), pixels per block) of the apply backward's
    dattn sum: block s of each (b, head) covers pixels
    [s * per, min((s + 1) * per, hw)), a multiple of DATTN_STAGE pixels."""
    stages = _cdiv(hw, DATTN_STAGE)
    want = min(max(1, _cdiv(DATTN_BLOCKS_PER_SM * n_sm, b * heads)), stages)
    per = _cdiv(stages, want) * DATTN_STAGE
    return _cdiv(hw, per), per


def gram_workspace_numel(splits: int, b: int, heads: int, ch: int) -> int:
    """Floats of workspace the Gram forward needs for `splits` ranges per
    (b, head): one partial G | nq | nk per range, none when each (b, head)
    is one range."""
    return 0 if splits == 1 else splits * b * heads * (ch * ch + 2 * ch)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The card's SM count, read once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def mdta_gram_fwd(qkv: torch.Tensor, num_heads: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """qkv (B,H,W,3C) -> G (B,heads,ch,ch), nq and nk (B,heads,ch), fp32.
    On the card the sums are in a fixed order, so two calls on the same
    input give the same bits."""
    if not qkv.is_cuda:
        return mdta_gram_plain(qkv, num_heads)
    b, h, w, c3 = qkv.shape
    ch = c3 // 3 // num_heads
    dev = qkv.device
    build.check_arg("qkv", qkv, (b, h, w, 3 * num_heads * ch), dev)
    _check_head_width(ch)
    splits, per = gram_plan(b, h * w, num_heads, sm_count(dev.index))
    n_ws = gram_workspace_numel(splits, b, num_heads, ch)
    # three allocations: views of one cost the host more (PERF.md, PR 5)
    gram = torch.empty(b, num_heads, ch, ch, device=dev)
    nq = torch.empty(b, num_heads, ch, device=dev)
    nk = torch.empty(b, num_heads, ch, device=dev)
    ws = torch.empty(n_ws, device=dev) if n_ws else None
    with torch.cuda.device(dev):
        build.call("rcot_mdta_gram", qkv.data_ptr(), gram.data_ptr(), nq.data_ptr(),
                   nk.data_ptr(), build.ptr(ws), b, h * w, num_heads, ch, splits, per,
                   build.stream())
    build.LAUNCHES["mdta_gram_fwd"] += 1
    return gram, nq, nk


def attn_apply_fwd(qkv: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """qkv (B,H,W,3C), attn (B,heads,ch,ch) -> (B,H,W,C)."""
    if not qkv.is_cuda:
        return attn_apply_plain(qkv, attn)
    b, h, w, _ = qkv.shape
    heads, ch = attn.shape[1], attn.shape[2]
    dev = qkv.device
    build.check_arg("qkv", qkv, (b, h, w, 3 * heads * ch), dev)
    build.check_arg("attn", attn, (b, heads, ch, ch), dev)
    _check_head_width(ch)
    blocks, per = apply_plan(b, h * w, heads, ch, sm_count(dev.index))
    out = torch.empty(b, h, w, heads * ch, device=dev)
    with torch.cuda.device(dev):
        build.call("rcot_attn_apply", qkv.data_ptr(), attn.data_ptr(), out.data_ptr(), b,
                   h * w, heads, ch, blocks, per, build.stream())
    build.LAUNCHES["attn_apply_fwd"] += 1
    return out


def mdta_gram_bwd(qkv: torch.Tensor, dgram: torch.Tensor, dnq: torch.Tensor,
                  dnk: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Backward of mdta_gram_fwd: qkv (B,H,W,3C) and the cotangents of G,
    nq, nk -> d[q|k] (B,H,W,2C); the v third is structurally zero and not
    written."""
    if not qkv.is_cuda:
        return mdta_gram_bwd_plain(qkv, dgram, dnq, dnk, num_heads)
    b, h, w, c3 = qkv.shape
    ch = c3 // 3 // num_heads
    dev = qkv.device
    build.check_arg("qkv", qkv, (b, h, w, 3 * num_heads * ch), dev)
    build.check_arg("dgram", dgram, (b, num_heads, ch, ch), dev)
    build.check_arg("dnq", dnq, (b, num_heads, ch), dev)
    build.check_arg("dnk", dnk, (b, num_heads, ch), dev)
    _check_head_width(ch)
    dqdk = torch.empty(b, h, w, 2 * num_heads * ch, device=dev)
    with torch.cuda.device(dev):
        build.call("rcot_mdta_gram_bwd", qkv.data_ptr(), dgram.data_ptr(),
                   dnq.data_ptr(), dnk.data_ptr(), dqdk.data_ptr(), b, h * w,
                   num_heads, ch, build.stream())
    build.LAUNCHES["mdta_gram_bwd"] += 1
    return dqdk


def attn_apply_bwd(qkv: torch.Tensor, attn: torch.Tensor, g: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of attn_apply_fwd for the cotangent g (B,H,W,C) ->
    (dv (B,H,W,C), dattn (B,heads,ch,ch))."""
    if not qkv.is_cuda:
        return attn_apply_bwd_plain(qkv, attn, g)
    b, h, w, _ = qkv.shape
    heads, ch = attn.shape[1], attn.shape[2]
    dev = qkv.device
    build.check_arg("qkv", qkv, (b, h, w, 3 * heads * ch), dev)
    build.check_arg("attn", attn, (b, heads, ch, ch), dev)
    build.check_arg("g", g, (b, h, w, heads * ch), dev)
    _check_head_width(ch)
    blocks, per = dattn_plan(b, h * w, heads, sm_count(dev.index))
    dv = torch.empty(b, h, w, heads * ch, device=dev)
    dattn = torch.empty(b, heads, ch, ch, device=dev)
    with torch.cuda.device(dev):
        build.call("rcot_attn_apply_bwd", qkv.data_ptr(), attn.data_ptr(),
                   g.data_ptr(), dv.data_ptr(), dattn.data_ptr(), b, h * w,
                   heads, ch, blocks, per, build.stream())
    build.LAUNCHES["attn_apply_bwd"] += 1
    return dv, dattn


# ------------------------------------------------------------ module-level

def _glue(gram: torch.Tensor, nq: torch.Tensor, nk: torch.Tensor,
          temperature: torch.Tensor) -> torch.Tensor:
    """Normalise, scale by temperature (heads, 1, 1) and softmax."""
    rq = nq.sqrt().clamp_min(L2_EPS)
    rk = nk.sqrt().clamp_min(L2_EPS)
    ghat = gram / (rq[..., :, None] * rk[..., None, :])
    return (ghat * temperature.float()[None]).softmax(dim=-1)


class MdtaCore(torch.autograd.Function):
    """The MDTA core with its backward kernels; saves qkv, G, nq, nk and
    the temperature (attn is rebuilt in the backward)."""

    @staticmethod
    def forward(ctx, temperature, qkv, num_heads):
        gram, nq, nk = mdta_gram_fwd(qkv, num_heads)
        ctx.save_for_backward(qkv, gram, nq, nk, temperature)
        ctx.num_heads = num_heads
        return attn_apply_fwd(qkv, _glue(gram, nq, nk, temperature))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        qkv, gram, nq, nk, temperature = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (gram, nq, nk, temperature)]
            attn = _glue(*leaves)
        dv, dattn = attn_apply_bwd(qkv, attn.detach(), g.contiguous())
        dgram, dnq, dnk, dtemp = torch.autograd.grad(attn, leaves, dattn)
        dqdk = mdta_gram_bwd(qkv, dgram.contiguous(), dnq.contiguous(),
                             dnk.contiguous(), ctx.num_heads)
        return dtemp, torch.cat([dqdk, dv], dim=-1), None


def mdta_core_gram(temperature: torch.Tensor, qkv: torch.Tensor,
                   num_heads: int) -> torch.Tensor:
    """The whole MDTA core on NHWC qkv (B,H,W,3C) -> (B,H,W,C),
    differentiable in qkv and the temperature (heads, 1, 1)."""
    return MdtaCore.apply(temperature, qkv, num_heads)
