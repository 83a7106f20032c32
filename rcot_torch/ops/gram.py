"""Transpose-free MDTA attention core: Gram and apply kernels.

Counterpart of rcot_tpu/ops/pallas_gram.py (forward only). MDTA's
attention matrix is channel by channel and both the Gram matrix and the L2
norms are plain sums over pixels, so they are computed on the packed NHWC
qkv = [q | k | v] without any head transpose:

  mdta_gram_fwd:  G = q^T k, nq = sum q^2, nk = sum k^2 per (b, head)
  _glue:          attn = softmax(G / (max(|q|, eps) max(|k|, eps)) * temp)
                  on (B, heads, ch, ch), plain PyTorch ops
  attn_apply_fwd: out[..., head h] = v_h @ attn[h]^T

Each kernel wrapper launches its CUDA kernel (csrc/gram_fwd.cu) for a
CUDA tensor and runs its plain twin for a CPU tensor; nothing else.
"""

from __future__ import annotations

from typing import Tuple

import torch

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


# ---------------------------------------------------------------- kernels

def mdta_gram_fwd(qkv: torch.Tensor, num_heads: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """qkv (B,H,W,3C) -> G (B,heads,ch,ch), nq and nk (B,heads,ch), fp32."""
    if not qkv.is_cuda:
        return mdta_gram_plain(qkv, num_heads)
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    ch = c // num_heads
    build.check_arg("qkv", qkv, (b, h, w, 3 * num_heads * ch), qkv.device)
    if ch > 128:
        raise ValueError(f"head width {ch} > 128 is not supported")
    gram = torch.empty(b, num_heads, ch, ch, device=qkv.device)
    nq = torch.empty(b, num_heads, ch, device=qkv.device)
    nk = torch.empty(b, num_heads, ch, device=qkv.device)
    with torch.cuda.device(qkv.device):
        build.call("rcot_mdta_gram", qkv.data_ptr(), gram.data_ptr(),
                   nq.data_ptr(), nk.data_ptr(), b, h * w, num_heads, ch,
                   torch.cuda.current_stream().cuda_stream)
    build.LAUNCHES["mdta_gram_fwd"] += 1
    return gram, nq, nk


def attn_apply_fwd(qkv: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """qkv (B,H,W,3C), attn (B,heads,ch,ch) -> (B,H,W,C)."""
    if not qkv.is_cuda:
        return attn_apply_plain(qkv, attn)
    b, h, w, _ = qkv.shape
    heads, ch = attn.shape[1], attn.shape[2]
    build.check_arg("qkv", qkv, (b, h, w, 3 * heads * ch), qkv.device)
    build.check_arg("attn", attn, (b, heads, ch, ch), qkv.device)
    if ch > 128:
        raise ValueError(f"head width {ch} > 128 is not supported")
    out = torch.empty(b, h, w, heads * ch, device=qkv.device)
    with torch.cuda.device(qkv.device):
        build.call("rcot_attn_apply", qkv.data_ptr(), attn.data_ptr(),
                   out.data_ptr(), b, h * w, heads, ch,
                   torch.cuda.current_stream().cuda_stream)
    build.LAUNCHES["attn_apply_fwd"] += 1
    return out


# ------------------------------------------------------------ module-level

def _glue(gram: torch.Tensor, nq: torch.Tensor, nk: torch.Tensor,
          temperature: torch.Tensor) -> torch.Tensor:
    """Normalise, scale by temperature (heads, 1, 1) and softmax."""
    rq = nq.sqrt().clamp_min(L2_EPS)
    rk = nk.sqrt().clamp_min(L2_EPS)
    ghat = gram / (rq[..., :, None] * rk[..., None, :])
    return (ghat * temperature.float()[None]).softmax(dim=-1)


def mdta_core_gram(temperature: torch.Tensor, qkv: torch.Tensor,
                   num_heads: int) -> torch.Tensor:
    """The whole MDTA core on NHWC qkv (B,H,W,3C) -> (B,H,W,C)."""
    gram, nq, nk = mdta_gram_fwd(qkv, num_heads)
    return attn_apply_fwd(qkv, _glue(gram, nq, nk, temperature))
