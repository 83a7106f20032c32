"""Full-resolution inference: pad to mod 8, shape buckets, batched restore
by bucket, and feathered overlap tiling.

Counterpart of rcot_tpu/models/inference.py (no mesh, no mprnet, no SR
mode yet). Images are (H, W, C) float32 numpy arrays in [0, 1]; the model
sees (B, H, W, C) tensors on the restorer's device, in the restorer's dtype
(fp32, or bf16 as make_restorer(dtype=jnp.bfloat16) serves: the input cast
to bf16, the output back to fp32).
"""

from __future__ import annotations

import copy
from typing import Callable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.dispatch import (resolve_attention_core, resolve_composition,
                            resolve_depthwise)
from ..utils.config import ModelConfig
from ..utils.device import resolve_device
from .restormer import Attention, Conv, TNet, _LayerNormBody

DTYPES = (torch.float32, torch.bfloat16)


def _pad_nhwc(x: torch.Tensor, ph: int, pw: int, mode: str) -> torch.Tensor:
    y = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode=mode)
    return y.permute(0, 2, 3, 1)


def _reflect_pad_hw(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Reflect-pad the bottom/right of (B,H,W,C) by (ph, pw), in chunks so
    pads larger than the image stay legal for reflect; a size-1 axis cannot
    reflect and edge-replicates instead."""
    while ph or pw:
        h, w = x.shape[1:3]
        dh, dw = min(ph, h - 1), min(pw, w - 1)
        if (ph and not dh) or (pw and not dw):  # that axis is size 1
            eh, ew = (ph if not dh else 0), (pw if not dw else 0)
            x = _pad_nhwc(x, eh, ew, "replicate")
            ph -= eh
            pw -= ew
            continue
        x = _pad_nhwc(x, dh, dw, "reflect")
        ph -= dh
        pw -= dw
    return x.contiguous()


def pad_to_multiple(x: torch.Tensor, base: int = 8
                    ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Reflect-pad (B, H, W, C) so H, W % base == 0. Returns (padded, (H, W))."""
    _, h, w, _ = x.shape
    ph, pw = (-h) % base, (-w) % base
    if ph or pw:
        x = _reflect_pad_hw(x, ph, pw)
    return x, (h, w)


def crop_back(y: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H', W', C) -> its top-left (B, H, W, C): pad_to_multiple undone."""
    h, w = hw
    return y[:, :h, :w, :]


def bucket_size(n: int, base: int = 8, buckets: Tuple[int, ...] = ()) -> int:
    """Round n up to the next bucket (or next multiple of base past the last)."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + base - 1) // base) * base


class Restorer:
    """Whole-image, batched-by-bucket and tiled restoration around
    model_fn: (B,H,W,C) tensor with H, W % 8 == 0 -> same shape."""

    def __init__(self, model_fn: Callable[[torch.Tensor], torch.Tensor], *,
                 device="cuda", pad_base: int = 8,
                 buckets: Tuple[int, ...] = (128, 256, 384, 512, 768, 1024),
                 tile: int = 0, tile_overlap: int = 32):
        self.model_fn = model_fn
        self.device = resolve_device(device)
        self.pad_base = pad_base
        self.buckets = buckets
        self.tile = tile
        self.tile_overlap = tile_overlap

    @torch.inference_mode()
    def _fwd(self, x: torch.Tensor) -> torch.Tensor:
        return self.model_fn(x)

    def _to_dev(self, img: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(img, np.float32)
                                ).to(self.device)[None]

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """img: (H, W, C) float32 in [0,1] -> restored (H, W, C)."""
        x = self._to_dev(img)
        if self.tile and max(img.shape[:2]) > self.tile:
            return self._tiled(x)
        return self._whole(x)[0].cpu().numpy()

    def restore_batch(self, imgs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """One forward per bucket group of images; order is preserved.
        With a tile set, images larger than it go through the tiled path
        one by one."""
        groups: dict = {}
        out: List[Optional[np.ndarray]] = [None] * len(imgs)
        for i, im in enumerate(imgs):
            h, w = im.shape[:2]
            if self.tile and max(h, w) > self.tile:
                out[i] = self(im)
                continue
            key = (bucket_size(h, self.pad_base, self.buckets),
                   bucket_size(w, self.pad_base, self.buckets))
            groups.setdefault(key, []).append(i)
        for (bh, bw), idxs in groups.items():
            batch = torch.cat([
                _reflect_pad_hw(self._to_dev(imgs[i]), bh - imgs[i].shape[0],
                                bw - imgs[i].shape[1]) for i in idxs])
            ys = self._fwd(batch).cpu().numpy()
            for k, i in enumerate(idxs):
                h, w = imgs[i].shape[:2]
                out[i] = ys[k, :h, :w, :]
        return out  # type: ignore[return-value]

    def _whole(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        bh = bucket_size(h, self.pad_base, self.buckets)
        bw = bucket_size(w, self.pad_base, self.buckets)
        padded = _reflect_pad_hw(x, bh - h, bw - w) if (bh > h or bw > w) else x
        return self._fwd(padded)[:, :h, :w, :]

    def _tiled(self, x: torch.Tensor) -> np.ndarray:
        """Overlap tiles, all in one batched forward, blended with a
        separable tent that ramps across the overlap and is renormalised by
        the summed weight."""
        tile, ov = self.tile, self.tile_overlap
        _, h, w, c = x.shape
        t = min(tile, h, w)
        t -= t % self.pad_base
        if t < self.pad_base:
            return self._whole(x)[0].cpu().numpy()
        ov = min(ov, t - self.pad_base)
        stride = t - ov
        hs = list(range(0, max(h - t, 0) + 1, stride))
        ws = list(range(0, max(w - t, 0) + 1, stride))
        if hs[-1] != h - t:
            hs.append(h - t)
        if ws[-1] != w - t:
            ws.append(w - t)
        tiles = torch.stack([x[0, i:i + t, j:j + t, :] for i in hs for j in ws])
        outs = self._fwd(tiles).cpu().numpy()

        ramp = np.ones(t, np.float32)
        if ov > 0:
            edge = np.linspace(1.0 / (ov + 1), 1.0, ov, dtype=np.float32)
            ramp[:ov] = edge
            ramp[-ov:] = edge[::-1]
        prof = np.outer(ramp, ramp)[:, :, None]
        acc = np.zeros((h, w, c), np.float32)
        weight = np.zeros((h, w, 1), np.float32)
        k = 0
        for i in hs:
            for j in ws:
                acc[i:i + t, j:j + t, :] += outs[k] * prof
                weight[i:i + t, j:j + t, :] += prof
                k += 1
        return acc / weight


def cast_copy(tnet: TNet, dtype: torch.dtype, depthwise: str = "fused") -> TNet:
    """A copy of tnet whose weights are in dtype, but for the LayerNorms'
    and the temperatures, which stay fp32: the values the JAX package's
    forward uses on a bf16 input, cast once here instead of at every use
    (rcot_tpu/ops/conv.py:45, rcot_tpu/models/restormer.py:77-89). For the
    "dwconv" tier the depthwise weights stay fp32 too: that tier takes its
    taps uncast (rcot_tpu/ops/attention.py:112-114, gdfn.py:66-67), the
    block kernels cast them at use (restormer.py _taps, _dw_taps)."""
    net = copy.deepcopy(tnet)
    keep = {id(p) for m in net.modules() if isinstance(m, _LayerNormBody)
            for p in m.parameters()}
    keep |= {id(m.temperature) for m in net.modules() if isinstance(m, Attention)}
    if depthwise == "dwconv":
        keep |= {id(m.weight) for m in net.modules() if isinstance(m, Conv) and m.groups > 1}
    with torch.no_grad():
        for p in net.parameters():
            if id(p) not in keep:
                p.data = p.data.to(dtype)
    return net


def make_restorer(model: Union[torch.nn.Module, Mapping[str, object]],
                  model_cfg: ModelConfig = ModelConfig(), *, tile: int = 0,
                  tile_overlap: int = 32, device="cuda", composition: str = "full",
                  attention_core: str = "gram", depthwise: str = "fused",
                  dtype: torch.dtype = torch.float32) -> Restorer:
    """Restorer around the two-pass T_net's out2. `model` is a TNet or a
    state_dict (numpy arrays or tensors) to load into a new one. Its
    forwards run in the composition, attention core and depthwise tier
    given (ops/dispatch.py; by default serving's "full" with the Gram core,
    as the JAX inference scope resolves RCOT_INFER_BLOCK and its kernel
    switches), and leave a shared TNet's own three as they found them, so a
    trainer can validate its training net. With dtype=torch.bfloat16 the
    input is cast to bf16 and the output back to fp32
    (rcot_tpu/models/inference.py:264-269), on a bf16 copy of the weights
    made here, once (cast_copy; a later change to a shared TNet's weights
    does not reach it); bf16 serves in every composition, attention core and
    depthwise tier."""
    choice = dict(composition=resolve_composition(composition, training=False),
                  attention_core=resolve_attention_core(attention_core),
                  depthwise=resolve_depthwise(depthwise))
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype}: one of {DTYPES}")
    dev = resolve_device(device)
    if model_cfg.backbone != "restormer":
        raise ValueError(f"backbone {model_cfg.backbone!r} is not ported yet")
    if isinstance(model, torch.nn.Module):
        tnet = model.to(dev)
    else:
        tnet = TNet(model_cfg, device=dev, seed=None)
        tnet.load_state_dict({k: torch.as_tensor(v) for k, v in model.items()},
                             strict=True)
    tnet.eval()
    if dtype != torch.float32:
        tnet = cast_copy(tnet, dtype, choice["depthwise"])

    def fn(x: torch.Tensor) -> torch.Tensor:
        before = {k: getattr(tnet, k) for k in choice}
        for k, v in choice.items():
            setattr(tnet, k, v)
        try:
            return tnet(x.to(dtype))[0].float()
        finally:
            for k, v in before.items():
                setattr(tnet, k, v)

    return Restorer(fn, device=dev, tile=tile, tile_overlap=tile_overlap)
