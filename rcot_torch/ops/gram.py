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
twins differentiate the forward twins by autograd. The kernels take heads
of any width: a head wider than HEAD_BLOCK channels runs as channel blocks
(channel_blocks) in a grid of block pairs, each sum over blocks through
slots of a workspace (slots_numel) added in a fixed order.

bf16 (rcot_tpu/ops/pallas_gram.py on a bf16 qkv): the Gram reads a bf16
qkv and writes fp32 G, nq and nk (the JAX kernel upcasts first, :81; a bf16
product is exact in fp32), the glue stays fp32, and the apply rounds attn
to bf16 (:171), sums in fp32 and writes bf16. On the card a bf16 qkv goes
to csrc/gram_bf16.cu's kernels, with the fp32 kernels' plans, counted as
mdta_gram_fwd_bf16 and attn_apply_fwd_bf16. In bf16 training the backward
kernels take the bf16 qkv and cotangent widened to fp32, the fp32 attn
(not the rounded one) and fp32 dG, dnq, dnk, and round d[q|k] and dv to
bf16 (:120-138, :195-216; dattn stays fp32): csrc/gram_bwd_bf16.cu,
counted as mdta_gram_bwd_bf16 and attn_apply_bwd_bf16. Their twins are
the fp32 twins on the widened operands, their outputs rounded.
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
    if qkv.dtype == torch.bfloat16:
        qkv = qkv.float()
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    ch = c // num_heads
    q = qkv[..., :c].reshape(b, h * w, num_heads, ch)
    k = qkv[..., c:2 * c].reshape(b, h * w, num_heads, ch)
    gram = torch.einsum("bnhc,bnhd->bhcd", q, k)
    return gram, q.square().sum(dim=1), k.square().sum(dim=1)


def attn_apply_plain(qkv: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    if qkv.dtype == torch.bfloat16:
        attn = attn.to(torch.bfloat16).float()
        return attn_apply_plain(qkv.float(), attn).to(torch.bfloat16)
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    heads, ch = attn.shape[1], attn.shape[2]
    v = qkv[..., 2 * c:].reshape(b, h, w, heads, ch)
    return torch.einsum("bxyhd,bhcd->bxyhc", v, attn).reshape(b, h, w, c)


def mdta_gram_bwd_plain(qkv, dgram, dnq, dnk, num_heads):
    """-> d[q|k] (B,H,W,2C) in qkv's dtype, by autograd through
    mdta_gram_plain (a bf16 qkv widened first)."""
    if qkv.dtype == torch.bfloat16:
        return mdta_gram_bwd_plain(qkv.float(), dgram, dnq, dnk, num_heads).to(qkv.dtype)
    with torch.enable_grad():
        leaf = qkv.detach().requires_grad_()
        outs = mdta_gram_plain(leaf, num_heads)
        (dqkv,) = torch.autograd.grad(outs, leaf, (dgram, dnq, dnk))
    return dqkv[..., :2 * (qkv.shape[-1] // 3)]


def attn_apply_bwd_plain(qkv, attn, g):
    """-> (dv (B,H,W,C) in qkv's dtype, dattn (B,heads,ch,ch) fp32), by
    autograd through attn_apply_plain (a bf16 qkv and g widened first, attn
    taken unrounded)."""
    if qkv.dtype == torch.bfloat16:
        dv, dattn = attn_apply_bwd_plain(qkv.float(), attn, g.float())
        return dv.to(qkv.dtype), dattn
    with torch.enable_grad():
        leaves = [qkv.detach().requires_grad_(), attn.detach().requires_grad_()]
        dqkv, dattn = torch.autograd.grad(attn_apply_plain(*leaves), leaves, g)
    return dqkv[..., 2 * (qkv.shape[-1] // 3):], dattn


# ---------------------------------------------------------------- kernels

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
# The Gram backward: the same grid over runs of GRAM_BWD_TILE-pixel tiles
# (the kernel's kBwdTP), two blocks an SM up to GRAM_BWD_TWO_MAX_CH, one
# above. Its own limit: at ch = 48 a block takes 107,904 bytes of shared
# memory and 118 registers a thread (ptxas), so two fit an SM (228 KB,
# 64K registers); at ch = 64 it takes 147,968 bytes and only one fits.
# The apply backward sums dattn over the Gram forward's pixel ranges
# (gram_plan), so the cap and its error bound hold for both.
# Heads of any width: each kernel takes a channel block of at most
# HEAD_BLOCK channels, and a wider head runs as channel_blocks's blocks, in
# a grid of block pairs, each pair a head of a plan's (csrc/gram.cu, "Heads
# of any width"); a head of ch <= HEAD_BLOCK is one block of ch and keeps
# its plans. The blocks share out a plan's blocks: the Gram's ranges count
# pairs as heads, the runs of tiles are per pair.
HEAD_BLOCK = 128
GRAM_BLOCKS_PER_SM = 1
GRAM_PIXEL_STEP = 64
GRAM_MAX_PIXELS = 512
APPLY_TWO_MAX_CH = 48
APPLY_TILE = 128
GRAM_BWD_TILE = 64
GRAM_BWD_TWO_MAX_CH = 48


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def channel_blocks(ch: int) -> Tuple[int, int]:
    """-> (blocks, width): a head of ch channels cut into blocks of `width`
    channels, block k covering [k * width, min((k + 1) * width, ch)), every
    one of them at most HEAD_BLOCK wide and none empty: as few blocks as
    HEAD_BLOCK allows, of about equal width, a multiple of 4 where ch is
    (so that 16-byte copies stay aligned). ch <= HEAD_BLOCK is one block."""
    n = _cdiv(ch, HEAD_BLOCK)
    unit = 4 if ch % 4 == 0 else 1
    width = _cdiv(_cdiv(ch, n), unit) * unit
    return _cdiv(ch, width), width


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


def gram_pairs_plan(b: int, hw: int, heads: int, ch: int, n_sm: int) -> Tuple[int, int]:
    """gram_plan for a head of ch channels: its channel-block pairs count
    as heads. The Gram forward's and the apply backward's ranges."""
    return gram_plan(b, hw, heads * channel_blocks(ch)[0] ** 2, n_sm)


def _runs(tiles: int, per_sm: int, n_sm: int) -> Tuple[int, int]:
    """-> (blocks, tiles per block): block k takes tiles
    [k * per, min((k + 1) * per, tiles)), at most per_sm * n_sm blocks and
    none of them empty."""
    per = _cdiv(tiles, min(tiles, per_sm * n_sm))
    return _cdiv(tiles, per), per


def pair_runs(tiles: int, ch: int, two_max_ch: int, n_sm: int) -> Tuple[int, int]:
    """_runs for each channel-block pair of a head of ch channels: two
    blocks an SM where the block width is at most two_max_ch, and the
    pairs share the card's SMs."""
    nb, cb = channel_blocks(ch)
    return _runs(tiles, 2 if cb <= two_max_ch else 1, max(1, n_sm // (nb * nb)))


def apply_plan(b: int, hw: int, heads: int, ch: int, n_sm: int) -> Tuple[int, int]:
    """-> (blocks, tiles per block) of the apply forward, for each
    channel-block pair: tile t of the b * heads * ceil(hw / APPLY_TILE)
    covers pixels [i * APPLY_TILE, ...) of (b, head) t // ceil(hw /
    APPLY_TILE), i = t % that. At most two blocks an SM (one where the
    block width > APPLY_TWO_MAX_CH)."""
    return pair_runs(b * heads * _cdiv(hw, APPLY_TILE), ch, APPLY_TWO_MAX_CH, n_sm)


def gram_bwd_plan(b: int, hw: int, heads: int, ch: int, n_sm: int) -> Tuple[int, int]:
    """-> (blocks, tiles per block) of the Gram backward, as apply_plan's
    over tiles of GRAM_BWD_TILE pixels, at most two blocks an SM (one where
    the block width > GRAM_BWD_TWO_MAX_CH)."""
    return pair_runs(b * heads * _cdiv(hw, GRAM_BWD_TILE), ch, GRAM_BWD_TWO_MAX_CH, n_sm)


def gram_workspace_numel(splits: int, b: int, heads: int, ch: int) -> int:
    """Floats of workspace the Gram forward needs for `splits` ranges per
    (b, head): one partial G | nq | nk per range, none when each (b, head)
    is one range."""
    return 0 if splits == 1 else splits * b * heads * (ch * ch + 2 * ch)


def apply_bwd_workspace_numel(splits: int, b: int, heads: int, ch: int) -> int:
    """Floats of workspace the apply backward needs for `splits` ranges per
    (b, head): one partial dattn per range, none when each (b, head) is one
    range."""
    return 0 if splits == 1 else splits * b * heads * ch * ch


def slots_numel(b: int, hw: int, heads: int, ch: int, width: int) -> int:
    """Floats of the slots of a sum over channel blocks: one (b, hw, width
    * heads * ch) slot per block where a head of ch channels is more than one
    block (the apply's out, width 1; the Gram backward's d[q|k], 2; the apply
    backward's dv, 1), none otherwise."""
    nb = channel_blocks(ch)[0]
    return 0 if nb == 1 else nb * b * hw * width * heads * ch


def bf16_copy_width(ch: int, cb: int, *ptrs: int) -> int:
    """bf16 a copy of a head's rows in the bf16 Gram and apply (csrc/
    gram_bf16.cu): 8 (16 bytes) where ch and the channel block cb are
    multiples of 8 and every pointer is 16-byte aligned, 2 (4 bytes) where
    they are even and 4-byte aligned, else 1 (a 2-byte load by the thread):
    every row offset of a head is then a multiple of the copy."""
    for vec in (8, 2):
        if ch % vec == 0 and cb % vec == 0 and all(p % (2 * vec) == 0 for p in ptrs):
            return vec
    return 1


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
    bf16 = qkv.dtype == torch.bfloat16
    build.check_arg("qkv", qkv, (b, h, w, 3 * num_heads * ch), dev, build.kernel_dtype(qkv))
    cb = channel_blocks(ch)[1]
    splits, per = gram_pairs_plan(b, h * w, num_heads, ch, sm_count(dev.index))
    n_ws = gram_workspace_numel(splits, b, num_heads, ch)
    # three allocations: views of one cost the host more (PERF.md, PR 5)
    gram = torch.empty(b, num_heads, ch, ch, device=dev)
    nq = torch.empty(b, num_heads, ch, device=dev)
    nk = torch.empty(b, num_heads, ch, device=dev)
    ws = torch.empty(n_ws, device=dev) if n_ws else None
    kernel = "mdta_gram_fwd_bf16" if bf16 else "mdta_gram_fwd"
    # the bf16 kernel takes its copy width after the plan
    vec = (bf16_copy_width(ch, cb, qkv.data_ptr()),) if bf16 else ()
    with torch.cuda.device(dev):
        build.call("rcot_mdta_gram_bf16" if bf16 else "rcot_mdta_gram", qkv.data_ptr(),
                   gram.data_ptr(), nq.data_ptr(), nk.data_ptr(), build.ptr(ws), b, h * w,
                   num_heads, ch, cb, splits, per, *vec, build.stream())
    build.LAUNCHES[kernel] += 1
    return gram, nq, nk


def attn_apply_fwd(qkv: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """qkv (B,H,W,3C), attn (B,heads,ch,ch) fp32 -> (B,H,W,C) in qkv's
    dtype."""
    if not qkv.is_cuda:
        return attn_apply_plain(qkv, attn)
    b, h, w, _ = qkv.shape
    heads, ch = attn.shape[1], attn.shape[2]
    dev = qkv.device
    bf16 = qkv.dtype == torch.bfloat16
    build.check_arg("qkv", qkv, (b, h, w, 3 * heads * ch), dev, build.kernel_dtype(qkv))
    build.check_arg("attn", attn, (b, heads, ch, ch), dev)
    cb = channel_blocks(ch)[1]
    blocks, per = apply_plan(b, h * w, heads, ch, sm_count(dev.index))
    n_ws = slots_numel(b, h * w, heads, ch, 1)
    out = torch.empty(b, h, w, heads * ch, device=dev, dtype=qkv.dtype)
    ws = torch.empty(n_ws, device=dev) if n_ws else None
    kernel = "attn_apply_fwd_bf16" if bf16 else "attn_apply_fwd"
    # the bf16 kernel stores pairs of bf16 where it copies two or more
    vec = (bf16_copy_width(ch, cb, qkv.data_ptr(), out.data_ptr()),) if bf16 else ()
    with torch.cuda.device(dev):
        build.call("rcot_attn_apply_bf16" if bf16 else "rcot_attn_apply", qkv.data_ptr(),
                   attn.data_ptr(), out.data_ptr(), build.ptr(ws), b, h * w, heads, ch, cb,
                   blocks, per, *vec, build.stream())
    build.LAUNCHES[kernel] += 1
    return out


def mdta_gram_bwd(qkv: torch.Tensor, dgram: torch.Tensor, dnq: torch.Tensor,
                  dnk: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Backward of mdta_gram_fwd: qkv (B,H,W,3C) and the cotangents of G,
    nq, nk -> d[q|k] (B,H,W,2C); the v third is structurally zero and not
    written; in qkv's dtype (fp32, or bf16 from fp32 cotangents)."""
    if not qkv.is_cuda:
        return mdta_gram_bwd_plain(qkv, dgram, dnq, dnk, num_heads)
    b, h, w, c3 = qkv.shape
    ch = c3 // 3 // num_heads
    dev = qkv.device
    bf16 = qkv.dtype == torch.bfloat16
    build.check_arg("qkv", qkv, (b, h, w, 3 * num_heads * ch), dev, build.kernel_dtype(qkv))
    build.check_arg("dgram", dgram, (b, num_heads, ch, ch), dev)
    build.check_arg("dnq", dnq, (b, num_heads, ch), dev)
    build.check_arg("dnk", dnk, (b, num_heads, ch), dev)
    cb = channel_blocks(ch)[1]
    blocks, per = gram_bwd_plan(b, h * w, num_heads, ch, sm_count(dev.index))
    n_ws = slots_numel(b, h * w, num_heads, ch, 2)
    dqdk = torch.empty(b, h, w, 2 * num_heads * ch, device=dev, dtype=qkv.dtype)
    ws = torch.empty(n_ws, device=dev) if n_ws else None
    # the bf16 kernel's fp32 copies of qkv (its q and k thirds) and of d[q|k]
    wide = [torch.empty(k, device=dev) for k in (qkv.numel(), dqdk.numel())] if bf16 else []
    kernel = "mdta_gram_bwd_bf16" if bf16 else "mdta_gram_bwd"
    with torch.cuda.device(dev):
        build.call("rcot_" + kernel, qkv.data_ptr(), dgram.data_ptr(),
                   dnq.data_ptr(), dnk.data_ptr(), dqdk.data_ptr(),
                   *(t.data_ptr() for t in wide), build.ptr(ws), b,
                   h * w, num_heads, ch, cb, blocks, per, build.stream())
    build.LAUNCHES[kernel] += 1
    return dqdk


def attn_apply_bwd(qkv: torch.Tensor, attn: torch.Tensor, g: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of attn_apply_fwd for the cotangent g (B,H,W,C) ->
    (dv (B,H,W,C) in qkv's dtype, dattn (B,heads,ch,ch) fp32); attn fp32,
    g in qkv's dtype. On the card dattn's pixel sums run in a fixed order,
    so two calls on the same input give the same bits."""
    if not qkv.is_cuda:
        return attn_apply_bwd_plain(qkv, attn, g)
    b, h, w, _ = qkv.shape
    heads, ch = attn.shape[1], attn.shape[2]
    dev = qkv.device
    dt = build.kernel_dtype(qkv)
    bf16 = dt == torch.bfloat16
    build.check_arg("qkv", qkv, (b, h, w, 3 * heads * ch), dev, dt)
    build.check_arg("attn", attn, (b, heads, ch, ch), dev)
    build.check_arg("g", g, (b, h, w, heads * ch), dev, dt)
    cb = channel_blocks(ch)[1]
    splits, per = gram_pairs_plan(b, h * w, heads, ch, sm_count(dev.index))
    # one allocation: the dattn partials, then the slots of dv
    n_ws = (apply_bwd_workspace_numel(splits, b, heads, ch)
            + slots_numel(b, h * w, heads, ch, 1))
    dv = torch.empty(b, h, w, heads * ch, device=dev, dtype=dt)
    dattn = torch.empty(b, heads, ch, ch, device=dev)
    ws = torch.empty(n_ws, device=dev) if n_ws else None
    # the bf16 kernel's fp32 copies of qkv (its v third), g and dv
    wide = ([torch.empty(k, device=dev) for k in (qkv.numel(), g.numel(), dv.numel())]
            if bf16 else [])
    kernel = "attn_apply_bwd_bf16" if bf16 else "attn_apply_bwd"
    with torch.cuda.device(dev):
        build.call("rcot_" + kernel, qkv.data_ptr(), attn.data_ptr(),
                   g.data_ptr(), dv.data_ptr(), dattn.data_ptr(),
                   *(t.data_ptr() for t in wide), build.ptr(ws), b,
                   h * w, heads, ch, cb, splits, per, build.stream())
    build.LAUNCHES[kernel] += 1
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
