"""Carry weights across from the JAX package, without JAX.

- `tnet_state_dict_from_jax(params, cfg)`: the JAX `init_tnet` pytree (as
  numpy arrays) -> this package's T_net state_dict, the exact inverse of
  rcot_tpu/compat/torch_port.py port_tnet_state_dict (HWIO -> OIHW).
- `fnet_state_dict_from_jax(params, critic_cfg)`: the JAX `init_fnet`
  pytree -> the F_net state_dict, the exact inverse of
  port_fnet_state_dict (HWIO -> OIHW convs, (in, out) -> (out, in)
  linears, and the flatten head's fc rows from (H, W, C) back to torch's
  (C, H, W) order).
- `tnet_jax_from_state_dict(sd, cfg)` / `fnet_jax_from_state_dict(sd,
  critic_cfg)`: the inverses, from any dict keyed by the port's parameter
  names (the parameters, or an optimizer's per-parameter state) to the JAX
  pytree's '/'-joined paths, as torch tensors in the JAX layouts (views
  where the layout is the same).
- `load_jax_npz(path)`: read a JAX-package checkpoint (.npz of '/'-joined
  tree paths plus a JSON blob under '__rcot_meta__'): a raw T-params npz
  (metadata carries "backbone") or a trainer checkpoint, whose T_net lives
  under the 't_params/' prefix of the saved TrainState.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Tuple

import numpy as np

from ..utils.config import CriticConfig, ModelConfig, model_config_from_dict

META_KEY = "__rcot_meta__"
SEP = "/"
TRAIN_STATE_PREFIX = "t_params"


def _conv(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = np.transpose(np.asarray(p["w"]), (3, 2, 0, 1))
    if "b" in p:
        sd[prefix + ".bias"] = np.asarray(p["b"])


def _ln(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".body.weight"] = np.asarray(p["w"])
    if "b" in p:
        sd[prefix + ".body.bias"] = np.asarray(p["b"])


def _block(sd: Dict, prefix: str, p: Mapping) -> None:
    _ln(sd, prefix + ".norm1", p["norm1"])
    at = p["attn"]
    sd[prefix + ".attn.temperature"] = np.asarray(at["temperature"])
    _conv(sd, prefix + ".attn.qkv", at["qkv"])
    _conv(sd, prefix + ".attn.qkv_dwconv", at["qkv_dw"])
    _conv(sd, prefix + ".attn.project_out", at["proj"])
    _ln(sd, prefix + ".norm2", p["norm2"])
    f = p["ffn"]
    _conv(sd, prefix + ".ffn.project_in", f["proj_in"])
    _conv(sd, prefix + ".ffn.dwconv", f["dw"])
    _conv(sd, prefix + ".ffn.project_out", f["proj_out"])


def _stack(sd: Dict, prefix: str, ps) -> None:
    for i, p in enumerate(ps):
        _block(sd, f"{prefix}.{i}", p)


def _resample(sd: Dict, prefix: str, p: Mapping) -> None:
    _conv(sd, prefix + ".body.0", p["conv"])


_STACKS = ("encoder_level1", "resencoder_level1", "encoder_level2",
           "resencoder_level2", "encoder_level3", "resencoder_level3",
           "latent", "reslatent", "decoder_level3", "decoder_level2",
           "decoder_level1", "refinement")
_RESAMPLES = ("down1_2", "resdown1_2", "down2_3", "resdown2_3", "down3_4",
              "up4_3", "up3_2", "up2_1")
_CONVS = ("reduce_chan_level3", "reduce_noise_level3", "reduce_chan_level2",
          "reduce_noise_level2", "reduce_noise_level1", "output")
_BLOCKS = ("noise_level3", "noise_level2", "noise_level1")
_UNUSED_CONVS = ("chnl_reduce1", "chnl_reduce2", "chnl_reduce3",
                 "reduce_noise_channel_1", "reduce_noise_channel_2",
                 "reduce_noise_channel_3", "resreduce_noise_level3")


def tnet_state_dict_from_jax(params: Mapping, cfg: ModelConfig
                             ) -> Dict[str, np.ndarray]:
    """JAX init_tnet pytree -> reference-named state_dict of numpy arrays
    (torch.from_numpy-able; load with TNet.load_state_dict(strict=True))."""
    sd: Dict[str, np.ndarray] = {}
    _conv(sd, "patch_embed.proj", params["patch_embed"])
    for name in _STACKS:
        _stack(sd, name, params[name])
    for name in _RESAMPLES:
        _resample(sd, name, params[name])
    for name in _CONVS:
        _conv(sd, name, params[name])
    for name in _BLOCKS:
        _block(sd, name, params[name])
    if cfg.parity_params:
        u = params["unused"]
        _conv(sd, "res_patch_embed.proj", u["res_patch_embed"])
        for name in _UNUSED_CONVS:
            _conv(sd, name, u[name])
        _resample(sd, "resdown3_4", u["resdown3_4"])
        _block(sd, "resnoise_level3", u["resnoise_level3"])
    return sd


def fnet_state_dict_from_jax(params: Mapping, cfg: CriticConfig
                             ) -> Dict[str, np.ndarray]:
    """JAX init_fnet pytree -> reference-named state_dict of numpy arrays
    (load with FNet.load_state_dict(strict=True))."""
    sd: Dict[str, np.ndarray] = {}
    # conv i sits at index 2i of the reference's nn.Sequential 'features'
    # (LeakyReLUs at the odd indices)
    for i, p in enumerate(params["convs"]):
        _conv(sd, f"features.{2 * i}", p)
    w = np.asarray(params["fc"]["w"])  # (in, out); in in (H, W, C) order
    if cfg.head == "flatten":
        side = cfg.patch_size // 32
        n_in, n_out = w.shape
        w = np.transpose(w.reshape(side, side, 512, n_out), (2, 0, 1, 3))
        w = w.reshape(n_in, n_out)
    for name, weight in (("fc", w), ("fc1", params["fc1"]["w"]),
                         ("fc2", params["fc2"]["w"])):
        sd[name + ".weight"] = np.ascontiguousarray(np.asarray(weight).T)
        sd[name + ".bias"] = np.asarray(params[name]["b"])
    return sd


def _conv_to_jax(flat: Dict, path: str, sd: Mapping, prefix: str) -> None:
    flat[path + "/w"] = sd[prefix + ".weight"].permute(2, 3, 1, 0)
    if prefix + ".bias" in sd:
        flat[path + "/b"] = sd[prefix + ".bias"]


def _ln_to_jax(flat: Dict, path: str, sd: Mapping, prefix: str) -> None:
    flat[path + "/w"] = sd[prefix + ".body.weight"]
    if prefix + ".body.bias" in sd:
        flat[path + "/b"] = sd[prefix + ".body.bias"]


def _block_to_jax(flat: Dict, path: str, sd: Mapping, prefix: str) -> None:
    _ln_to_jax(flat, path + "/norm1", sd, prefix + ".norm1")
    flat[path + "/attn/temperature"] = sd[prefix + ".attn.temperature"]
    for jname, name in (("qkv", "qkv"), ("qkv_dw", "qkv_dwconv"), ("proj", "project_out")):
        _conv_to_jax(flat, f"{path}/attn/{jname}", sd, f"{prefix}.attn.{name}")
    _ln_to_jax(flat, path + "/norm2", sd, prefix + ".norm2")
    for jname, name in (("proj_in", "project_in"), ("dw", "dwconv"),
                        ("proj_out", "project_out")):
        _conv_to_jax(flat, f"{path}/ffn/{jname}", sd, f"{prefix}.ffn.{name}")


def tnet_jax_from_state_dict(sd: Mapping, cfg: ModelConfig) -> Dict:
    """Inverse of tnet_state_dict_from_jax: port names -> '/'-joined JAX
    paths of init_tnet's pytree, torch tensors in JAX layouts."""
    flat: Dict = {}
    _conv_to_jax(flat, "patch_embed", sd, "patch_embed.proj")
    for name in _STACKS:
        i = 0
        while f"{name}.{i}.norm1.body.weight" in sd:
            _block_to_jax(flat, f"{name}/{i}", sd, f"{name}.{i}")
            i += 1
    for name in _RESAMPLES:
        _conv_to_jax(flat, name + "/conv", sd, name + ".body.0")
    for name in _CONVS:
        _conv_to_jax(flat, name, sd, name)
    for name in _BLOCKS:
        _block_to_jax(flat, name, sd, name)
    if cfg.parity_params:
        _conv_to_jax(flat, "unused/res_patch_embed", sd, "res_patch_embed.proj")
        for name in _UNUSED_CONVS:
            _conv_to_jax(flat, "unused/" + name, sd, name)
        _conv_to_jax(flat, "unused/resdown3_4/conv", sd, "resdown3_4.body.0")
        _block_to_jax(flat, "unused/resnoise_level3", sd, "resnoise_level3")
    return flat


def fnet_jax_from_state_dict(sd: Mapping, cfg: CriticConfig) -> Dict:
    """Inverse of fnet_state_dict_from_jax: port names -> '/'-joined JAX
    paths of init_fnet's pytree, torch tensors in JAX layouts."""
    flat: Dict = {}
    i = 0
    while f"features.{2 * i}.weight" in sd:
        _conv_to_jax(flat, f"convs/{i}", sd, f"features.{2 * i}")
        i += 1
    w = sd["fc.weight"].t()  # (in, out); in in torch's (C, H, W) order
    if cfg.head == "flatten":
        side = cfg.patch_size // 32
        n_in, n_out = w.shape
        w = w.reshape(512, side, side, n_out).permute(1, 2, 0, 3).reshape(n_in, n_out)
    flat["fc/w"] = w
    flat["fc1/w"] = sd["fc1.weight"].t()
    flat["fc2/w"] = sd["fc2.weight"].t()
    for name in ("fc", "fc1", "fc2"):
        flat[name + "/b"] = sd[name + ".bias"]
    return flat


def unflatten(flat: Mapping[str, np.ndarray]):
    """'/'-joined paths -> nested dicts; a dict whose keys are 0..n-1
    becomes a list (the JAX pytree's block stacks)."""
    root: Dict = {}
    for key, val in flat.items():
        node = root
        parts = key.split(SEP)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        out = {k: fix(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return fix(root)


def load_jax_npz(path: str, cfg: ModelConfig = ModelConfig()
                 ) -> Tuple[Dict[str, np.ndarray], ModelConfig]:
    """JAX-package .npz checkpoint -> (T_net state_dict, ModelConfig).

    A trainer checkpoint's own `config.model` metadata wins over `cfg`."""
    if os.path.islink(path):
        path = os.path.join(os.path.dirname(path), os.readlink(path))
    with np.load(path) as z:
        meta = (json.loads(bytes(z[META_KEY].tobytes()).decode())
                if META_KEY in z else {})
        flat = {k: z[k] for k in z.files if k != META_KEY}
    backbone = meta.get("backbone")
    if backbone is None:
        model_meta = meta.get("config", {}).get("model")
        if model_meta:
            cfg = model_config_from_dict(model_meta)
        backbone = cfg.backbone
        lead = TRAIN_STATE_PREFIX + SEP
        flat = {k[len(lead):]: v for k, v in flat.items() if k.startswith(lead)}
        if not flat:
            raise ValueError(f"{path}: no '{TRAIN_STATE_PREFIX}/' entries; "
                             "not a T_net checkpoint")
    if backbone != "restormer":
        raise ValueError(f"{path}: backbone {backbone!r} is not ported yet")
    return tnet_state_dict_from_jax(unflatten(flat), cfg), cfg

