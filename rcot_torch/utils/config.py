"""Model, critic, training and evaluation configuration (field names of
the JAX package's `rcot_tpu/utils/config.py`, so that checkpoint metadata
written there parses here). The training sections hold only the fields the
minimax iteration and its learning-rate schedule read."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """RCOT two-pass Restormer transport map (reference: Net_Restormer.py:215-434)."""

    backbone: str = "restormer"
    mprnet_n_feat: int = 80
    mprnet_scale_feats: int = 48
    inp_channels: int = 3
    out_channels: int = 3
    dim: int = 48
    num_blocks: Tuple[int, int, int, int] = (4, 6, 6, 8)
    num_refinement_blocks: int = 4
    heads: Tuple[int, int, int, int] = (1, 2, 4, 8)
    ffn_expansion_factor: float = 2.66
    # GDFN hidden size rounded up to this multiple (1 = int(dim * 2.66)).
    ffn_hidden_multiple: int = 1
    bias: bool = False
    layernorm_type: str = "WithBias"  # or "BiasFree"
    # decoder=True runs the residual-conditioned second pass.
    decoder: bool = True
    latent_cond_scale: float = 0.8  # latent += scale * reslatent
    # Instantiate the reference's defined-but-unused modules, pinning the
    # parameter count at 46,853,150.
    parity_params: bool = True

    @property
    def dims(self) -> Tuple[int, int, int, int]:
        d = self.dim
        return (d, d * 2, d * 4, d * 8)


@dataclass(frozen=True)
class CriticConfig:
    """OT potential / WGAN critic (reference: Net_Restormer.py:436-522)."""

    patch_size: int = 128
    in_channels: int = 3
    # "flatten" is the reference's patch-size-bound head (num_fea =
    # patch_size**2 / 2); "pooled" averages to 512 features first.
    head: str = "flatten"
    # fc mid width; None = num_fea // 4 (Net_Restormer.py:494)
    fc_mid: Optional[int] = None


@dataclass(frozen=True)
class TrainConfig:
    """Minimax training recipe (reference: trainer.py:22-58,119-126,228-243)."""

    batch_size: int = 3
    lr: float = 1e-4  # critic lr; the transport map takes lr / 2
    lr_step: int = 20  # step decay: lr * 0.1**(epoch // lr_step)
    optimizer: str = "RMSprop"  # or "Adam"
    Sigma: float = 1e4  # paired L1 weight
    sigma: float = 1.0  # OT transport-cost weight
    gp_weight: float = 10.0  # gradient-penalty weight
    # "reference" keeps the reference's operator-precedence quirk in the
    # Fourier cost (half the mean power); "clean" takes the RMS
    loss_math: str = "reference"


@dataclass(frozen=True)
class EvalConfig:
    """Inference / evaluation defaults of the test CLI (cli/test.py)."""

    save: str = "./results/OUT/"
    savetar: str = "./results/TAR/"
    saveres: str = "./results/RES/"
    tile: int = 0
    tile_overlap: int = 32
    batch_size: int = 1
    noise_sigma: float = 0.0


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    critic: CriticConfig = field(default_factory=CriticConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def _from_dict(cls, d: Mapping[str, Any]):
    """cls from checkpoint metadata (JSON lists become tuples; unknown keys
    are ignored)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items() if k in names})


def model_config_from_dict(d: Mapping[str, Any]) -> ModelConfig:
    return _from_dict(ModelConfig, d)


def critic_config_from_dict(d: Mapping[str, Any]) -> CriticConfig:
    return _from_dict(CriticConfig, d)


def train_config_from_dict(d: Mapping[str, Any]) -> TrainConfig:
    return _from_dict(TrainConfig, d)


def config_from_dict(d: Mapping[str, Any]) -> Config:
    """Config from a JAX-package `Config.to_dict()`; sections the port does
    not hold (data, eval) are ignored."""
    return Config(model=model_config_from_dict(d.get("model", {})),
                  critic=critic_config_from_dict(d.get("critic", {})),
                  train=train_config_from_dict(d.get("train", {})))
