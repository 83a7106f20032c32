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

A bias-free block (the default config) runs the fused kernels in one of
the four compositions of ops/dispatch.py, the `composition` attribute of
the TNet (settable after construction; not a ModelConfig field, so that
Config.hash() stays the JAX package's):

  full: block_head -> mdta_core_gram -> block_tail (serving's default)
  head: block_head -> mdta_core_gram -> x + proj(a) -> x + gdfn_fused(LN2(x))
  tail: LN1 -> conv1x1_dw_fused -> mdta_core_gram -> block_tail (training's)
  off:  LN1 -> conv1x1_dw_fused -> mdta_core_gram -> x + proj(a)
        -> x + gdfn_fused(LN2(x))

(ops/block.py, ops/fused.py, ops/gram.py). With bias=True every
composition takes the plain ops, as the JAX package does.
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.attention import mdta, mdta_qkv
from ..ops.block import block_head, block_tail
from ..ops.conv import conv1x1, conv2d
from ..ops.dispatch import COMPOSITIONS
from ..ops.gdfn import gdfn, hidden_features
from ..ops.gram import mdta_core_gram
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


def _mat(conv: Conv) -> torch.Tensor:
    """(O, I, 1, 1) 1x1 weight as an (O, I) view."""
    return conv.weight.view(conv.weight.shape[0], -1)


def _taps(conv: Conv) -> torch.Tensor:
    """(C, 1, 3, 3) depthwise weight as a (C, 3, 3) view."""
    return conv.weight.view(-1, 3, 3)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_factor: float, *,
                 bias: bool, ln_bias: bool, ffn_multiple: int = 1):
        super().__init__()
        self.norm1 = LayerNorm(dim, ln_bias)
        self.attn = Attention(dim, num_heads, bias)
        self.norm2 = LayerNorm(dim, ln_bias)
        self.ffn = FeedForward(dim, ffn_factor, bias, ffn_multiple)
        self.composition = "full"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        at, f = self.attn, self.ffn
        if at.qkv.bias is not None:
            x = x + at(self.norm1(x))
            return x + f(self.norm2(x))
        if self.composition in ("tail", "off"):
            qkv = mdta_qkv(self.norm1(x), at.qkv.weight, at.qkv_dwconv.weight)
        else:
            qkv = block_head(x, self.norm1.body.weight, self.norm1.body.bias,
                             _mat(at.qkv), _taps(at.qkv_dwconv))
        a = mdta_core_gram(at.temperature, qkv, at.num_heads)
        if self.composition in ("full", "tail"):
            return block_tail(x, a, _mat(at.project_out), self.norm2.body.weight,
                              self.norm2.body.bias, _mat(f.project_in),
                              _taps(f.dwconv), _mat(f.project_out))
        x = x + conv1x1(a, _mat(at.project_out))
        return x + f(self.norm2(x))


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
    trained weights. `composition` picks the bias-free blocks' kernels
    (module docstring)."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), *,
                 device="cuda", seed: Optional[int] = 0,
                 composition: str = "full"):
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
        self.to(resolve_device(device))
        if seed is not None:
            self.init_weights_(seed)

    @property
    def composition(self) -> str:
        return self._composition

    @composition.setter
    def composition(self, mode: str) -> None:
        if mode not in COMPOSITIONS:
            raise ValueError(f"unknown composition {mode!r}; one of {COMPOSITIONS}")
        self._composition = mode
        for m in self.modules():
            if isinstance(m, TransformerBlock):
                m.composition = mode

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
        latent2 = latent + self.cfg.latent_cond_scale * reslatent
        out2 = self._decode(latent2, e1, e2, e3, inp)
        return out2, out1, res


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
