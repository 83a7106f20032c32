"""RCOT transport map: the two-pass residual-conditioned Restormer (T_net).

Counterpart of rcot_tpu/models/restormer.py; reference Net_Restormer.py:215-434.
Modules carry the reference's state_dict names (norm1.body.weight,
attn.qkv, attn.qkv_dwconv, attn.project_out, ffn.project_in/dwconv/
project_out, <resampler>.body.0, patch_embed.proj, ...), so a reference
state_dict loads with load_state_dict(strict=True). Activations are
(B, H, W, C).

Forward, as in the JAX package:
- pass 1: embed -> encoder -> latent -> conditioning blocks -> decoder ->
  output conv + input;
- res = input - out1; the residual branch re-uses patch_embed and the
  shared down3_4 but has its own level blocks and downsamples;
- latent2 = latent + 0.8 * reslatent (the pass-1 latent is computed once);
- pass 2 re-runs the same decoder on latent2;
- returns (out2, out1, res) and writes no files.

A bias-free block (the default config) runs the kernels that three
attributes of the TNet name (ops/dispatch.py; each settable after
construction and propagated to every block; none is a ModelConfig field,
so that Config.hash() stays the JAX package's). `composition`:

  full: block_head -> core -> block_tail (serving's default)
  head: block_head -> core -> x + proj(a) -> x + gdfn(LN2(x))
  tail: LN1 -> qkv -> core -> block_tail (training's)
  off:  LN1 -> qkv -> core -> x + proj(a) -> x + gdfn(LN2(x))

`attention_core` picks the core: "gram" (mdta_core_gram, the default) or
"mdta" (the transposes around the fused attend kernel). `depthwise` picks
qkv and gdfn: "fused" (conv1x1_dw_fused, gdfn_fused, the default) or
"dwconv" (1x1 products around the standalone depthwise kernel); it changes
nothing in "full". (ops/block.py, ops/fused.py, ops/gram.py, ops/mdta.py,
ops/dwconv.py.) With bias=True every composition takes the plain ops, as
the JAX package does.

A bf16 input runs the same forward in bf16, as apply_tnet on a bf16 input
(rcot_tpu/models/restormer.py): every weight is used in the activation's
dtype (ops/conv.py; the block kernels get their weights in x's dtype and
their LN weights in fp32, rcot_tpu/models/restormer.py:77-89), LayerNorms
compute in fp32 and round, the residual adds stay bf16; gradients reach
the fp32 parameters through those casts. A bias-free block runs bf16 only
with the Gram core and the fused tier: a forward in "full" or "tail", one
that autograd may differentiate (grad enabled: bf16 training) in "tail"
alone (ops/dispatch.py check_bf16).
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.attention import mdta, mdta_core, mdta_qkv
from ..ops.block import block_head, block_tail
from ..ops.conv import conv1x1, conv2d
from ..ops.dispatch import (COMPOSITIONS, check_bf16, resolve_attention_core,
                            resolve_depthwise)
from ..ops.gdfn import gdfn, hidden_features
from ..ops.layernorm import layernorm
from ..ops.resample import downsample, upsample
from ..utils.config import ModelConfig
from ..utils.device import resolve_device


class Conv(nn.Module):
    """Parameter holder with nn.Conv2d's names and shapes (weight OIHW,
    optional bias); applied by the functional NHWC ops."""

    def __init__(self, cin: int, cout: int, k: int, *, groups: int = 1,
                 bias: bool = False):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, groups=self.groups)


class _LayerNormBody(nn.Module):
    def __init__(self, dim: int, with_bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim)) if with_bias else None


class LayerNorm(nn.Module):
    """Channel-last LN; state_dict names '<name>.body.weight/bias'."""

    def __init__(self, dim: int, with_bias: bool):
        super().__init__()
        self.body = _LayerNormBody(dim, with_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.body.weight, self.body.bias)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, bias: bool):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.empty(num_heads, 1, 1))
        self.qkv = Conv(dim, dim * 3, 1, bias=bias)
        self.qkv_dwconv = Conv(dim * 3, dim * 3, 3, groups=dim * 3, bias=bias)
        self.project_out = Conv(dim, dim, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mdta(x, self.temperature, self.qkv.weight,
                    self.qkv_dwconv.weight, self.project_out.weight,
                    self.num_heads, self.qkv.bias, self.qkv_dwconv.bias,
                    self.project_out.bias)


class FeedForward(nn.Module):
    def __init__(self, dim: int, ffn_factor: float, bias: bool,
                 hidden_multiple: int = 1):
        super().__init__()
        hid = hidden_features(dim, ffn_factor, hidden_multiple)
        self.project_in = Conv(dim, hid * 2, 1, bias=bias)
        self.dwconv = Conv(hid * 2, hid * 2, 3, groups=hid * 2, bias=bias)
        self.project_out = Conv(hid, dim, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gdfn(x, self.project_in.weight, self.dwconv.weight,
                    self.project_out.weight, self.project_in.bias,
                    self.dwconv.bias, self.project_out.bias)


def _composition(mode: str) -> str:
    if mode not in COMPOSITIONS:
        raise ValueError(f"unknown composition {mode!r}; one of {COMPOSITIONS}")
    return mode


class _Choice:
    """A kernel choice of the bias-free blocks (ops/dispatch.py), validated
    when set; set on a TNet, it is set on every block of it too."""

    def __init__(self, check):
        self.check = check

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, owner=None):
        return self if obj is None else obj.__dict__["_" + self.name]

    def __set__(self, obj, value):
        obj.__dict__["_" + self.name] = self.check(value)
        for m in obj.modules():
            if m is not obj and isinstance(m, TransformerBlock):
                setattr(m, self.name, value)


def _mat(conv: Conv, dtype: torch.dtype) -> torch.Tensor:
    """(O, I, 1, 1) 1x1 weight as an (O, I) view, in dtype (a view where it
    is the weight's)."""
    return conv.weight.view(conv.weight.shape[0], -1).to(dtype)


def _taps(conv: Conv, dtype: torch.dtype) -> torch.Tensor:
    """(C, 1, 3, 3) depthwise weight as a (C, 3, 3) view, in dtype."""
    return conv.weight.view(-1, 3, 3).to(dtype)


def _ln(norm: LayerNorm):
    """A LayerNorm's weight and bias (or None) in fp32, as the block kernels
    take them."""
    b = norm.body.bias
    return norm.body.weight.float(), None if b is None else b.float()


class TransformerBlock(nn.Module):
    composition = _Choice(_composition)
    attention_core = _Choice(resolve_attention_core)
    depthwise = _Choice(resolve_depthwise)

    def __init__(self, dim: int, num_heads: int, ffn_factor: float, *,
                 bias: bool, ln_bias: bool, ffn_multiple: int = 1):
        super().__init__()
        self.norm1 = LayerNorm(dim, ln_bias)
        self.attn = Attention(dim, num_heads, bias)
        self.norm2 = LayerNorm(dim, ln_bias)
        self.ffn = FeedForward(dim, ffn_factor, bias, ffn_multiple)
        self.composition = "full"
        self.attention_core = "gram"
        self.depthwise = "fused"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        at, f = self.attn, self.ffn
        if at.qkv.bias is not None:
            x = x + at(self.norm1(x))
            return x + f(self.norm2(x))
        if x.dtype == torch.bfloat16:
            check_bf16(self.composition, self.attention_core, self.depthwise,
                       "backward" if torch.is_grad_enabled() else "forward")
        dt = x.dtype
        if self.composition in ("tail", "off"):
            # the weights in x's dtype, as rcot_tpu/ops/attention.py:102-103
            qkv = mdta_qkv(self.norm1(x), _mat(at.qkv, dt), _taps(at.qkv_dwconv, dt),
                           depthwise=self.depthwise)
        else:
            qkv = block_head(x, *_ln(self.norm1), _mat(at.qkv, dt), _taps(at.qkv_dwconv, dt))
        a = mdta_core(at.temperature, qkv, at.num_heads, self.attention_core)
        if self.composition in ("full", "tail"):
            return block_tail(x, a, _mat(at.project_out, dt), *_ln(self.norm2),
                              _mat(f.project_in, dt), _taps(f.dwconv, dt),
                              _mat(f.project_out, dt))
        x = x + conv1x1(a, _mat(at.project_out, dt))
        return x + gdfn(self.norm2(x), f.project_in.weight, f.dwconv.weight,
                        f.project_out.weight, depthwise=self.depthwise)


class _Resample(nn.Module):
    """Downsample (C -> C/2 conv, unshuffle) or upsample (C -> 2C conv,
    shuffle); state_dict names '<name>.body.0.weight'."""

    def __init__(self, n_feat: int, down: bool):
        super().__init__()
        self.down = down
        cout = n_feat // 2 if down else n_feat * 2
        self.body = nn.ModuleList([Conv(n_feat, cout, 3)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = downsample if self.down else upsample
        return fn(self.body[0].weight, x)


class _PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, bias: bool):
        super().__init__()
        self.proj = Conv(cin, dim, 3, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class TNet(nn.Module):
    """The RCOT T_net. `seed` fills every parameter from a numpy generator
    keyed by its name (init_weights_); load a checkpoint over it to serve
    trained weights. `composition`, `attention_core` and `depthwise` pick
    the bias-free blocks' kernels (module docstring)."""

    composition = _Choice(_composition)
    attention_core = _Choice(resolve_attention_core)
    depthwise = _Choice(resolve_depthwise)

    def __init__(self, cfg: ModelConfig = ModelConfig(), *,
                 device="cuda", seed: Optional[int] = 0,
                 composition: str = "full", attention_core: str = "gram",
                 depthwise: str = "fused"):
        super().__init__()
        self.cfg = cfg
        d1, d2, d3, d4 = cfg.dims
        h = cfg.heads
        nb = cfg.num_blocks
        bias = cfg.bias
        ln_bias = cfg.layernorm_type == "WithBias"
        ffn = cfg.ffn_expansion_factor
        mult = cfg.ffn_hidden_multiple

        def block(dim, heads):
            return TransformerBlock(dim, heads, ffn, bias=bias,
                                    ln_bias=ln_bias, ffn_multiple=mult)

        def stack(n, dim, heads):
            return nn.ModuleList([block(dim, heads) for _ in range(n)])

        def conv1(cin, cout):
            return Conv(cin, cout, 1, bias=bias)

        self.patch_embed = _PatchEmbed(cfg.inp_channels, d1, bias)
        self.encoder_level1 = stack(nb[0], d1, h[0])
        self.resencoder_level1 = stack(nb[0], d1, h[0])
        self.down1_2 = _Resample(d1, True)
        self.resdown1_2 = _Resample(d1, True)
        self.encoder_level2 = stack(nb[1], d2, h[1])
        self.resencoder_level2 = stack(nb[1], d2, h[1])
        self.down2_3 = _Resample(d2, True)
        self.resdown2_3 = _Resample(d2, True)
        self.encoder_level3 = stack(nb[2], d3, h[2])
        self.resencoder_level3 = stack(nb[2], d3, h[2])
        self.down3_4 = _Resample(d3, True)  # shared by the residual branch
        self.latent = stack(nb[3], d4, h[3])
        self.reslatent = stack(nb[3], d4, h[3])
        self.up4_3 = _Resample(d3, False)
        self.reduce_chan_level3 = conv1(d3 + d3 // 2, d3)
        self.noise_level3 = block(d4, h[2])
        self.reduce_noise_level3 = conv1(d4, d3)
        self.decoder_level3 = stack(nb[2], d3, h[2])
        self.up3_2 = _Resample(d3, False)
        self.reduce_chan_level2 = conv1(d3, d2)
        self.noise_level2 = block(d2 * 2, h[2])
        self.reduce_noise_level2 = conv1(d2 * 2, d2 * 2)
        self.decoder_level2 = stack(nb[1], d2, h[1])
        self.up2_1 = _Resample(d2, False)
        self.noise_level1 = block(d2, h[2])
        self.reduce_noise_level1 = conv1(d2, d2)
        self.decoder_level1 = stack(nb[0], d2, h[0])
        self.refinement = stack(cfg.num_refinement_blocks, d2, h[0])
        self.output = Conv(d2, cfg.out_channels, 3, bias=bias)
        if cfg.parity_params:
            # defined but never called by the reference's forward; they pin
            # the parameter count at 46,853,150
            self.res_patch_embed = _PatchEmbed(cfg.inp_channels, d1, bias)
            self.chnl_reduce1 = conv1(64, 64)
            self.chnl_reduce2 = conv1(128, 128)
            self.chnl_reduce3 = conv1(320, 256)
            self.reduce_noise_channel_1 = conv1(d1 + 64, d1)
            self.reduce_noise_channel_2 = conv1(d2 + 128, d2)
            self.reduce_noise_channel_3 = conv1(d3 + 256, d3)
            self.resdown3_4 = _Resample(d3, True)
            self.resnoise_level3 = block(d4, h[2])
            self.resreduce_noise_level3 = conv1(d4, d3)
        self.composition = composition
        self.attention_core = attention_core
        self.depthwise = depthwise
        self.to(resolve_device(device))
        if seed is not None:
            self.init_weights_(seed)

    @torch.no_grad()
    def init_weights_(self, seed: int = 0, std: float = 0.02) -> "TNet":
        """LayerNorm weights 1 and biases 0, temperatures 1, every other
        parameter N(0, std^2) from numpy.default_rng(crc32(name) ^ seed)."""
        for name, p in self.named_parameters():
            if ".body.weight" in name and p.dim() == 1:
                val = np.ones(p.shape, np.float32)
            elif name.endswith("temperature"):
                val = np.ones(p.shape, np.float32)
            elif ".body.bias" in name and p.dim() == 1:
                val = np.zeros(p.shape, np.float32)
            else:
                rng = np.random.default_rng(zlib.crc32(name.encode()) ^ seed)
                val = (rng.standard_normal(p.shape) * std).astype(np.float32)
            p.copy_(torch.from_numpy(val))
        return self

    def _stack(self, blocks: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
        for blk in blocks:
            x = blk(x)
        return x

    def _encode(self, x: torch.Tensor, res_branch: bool):
        pre = "res" if res_branch else ""
        g = lambda n: getattr(self, pre + n)  # noqa: E731
        e1 = self._stack(g("encoder_level1"), self.patch_embed(x))
        e2 = self._stack(g("encoder_level2"), g("down1_2")(e1))
        e3 = self._stack(g("encoder_level3"), g("down2_3")(e2))
        e4 = self.down3_4(e3)
        latent = self._stack(self.reslatent if res_branch else self.latent, e4)
        return e1, e2, e3, latent

    def _decode(self, latent, e1, e2, e3, inp):
        latent = self.noise_level3(latent)
        latent = self.reduce_noise_level3(latent)
        d3 = self.up4_3(latent)
        d3 = self.reduce_chan_level3(torch.cat([d3, e3], dim=-1))
        d3 = self._stack(self.decoder_level3, d3)
        d3 = self.noise_level2(d3)
        d3 = self.reduce_noise_level2(d3)
        d2 = self.up3_2(d3)
        d2 = self.reduce_chan_level2(torch.cat([d2, e2], dim=-1))
        d2 = self._stack(self.decoder_level2, d2)
        d2 = self.noise_level1(d2)
        d2 = self.reduce_noise_level1(d2)
        d1 = torch.cat([self.up2_1(d2), e1], dim=-1)
        d1 = self._stack(self.decoder_level1, d1)
        d1 = self._stack(self.refinement, d1)
        return self.output(d1) + inp

    def forward(self, inp: torch.Tensor, *, single_pass: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """inp (B, H, W, C) with H, W % 8 == 0 -> (out2, out1, res)."""
        e1, e2, e3, latent = self._encode(inp, res_branch=False)
        out1 = self._decode(latent, e1, e2, e3, inp)
        res = inp - out1
        if single_pass or not self.cfg.decoder:
            return out1, out1, res
        _, _, _, reslatent = self._encode(res, res_branch=True)
        # the scale in the activations' dtype, as JAX takes a Python float
        # (0.8 is 0.80078125 in bf16)
        scale = torch.tensor(self.cfg.latent_cond_scale, dtype=reslatent.dtype)
        latent2 = latent + scale * reslatent
        out2 = self._decode(latent2, e1, e2, e3, inp)
        return out2, out1, res


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
