"""Model, critic, data, training and evaluation configuration, and the
named presets.

A copy of the JAX package's rcot_tpu/utils/config.py:100-273: the same
fields with the same defaults and the same presets, so that checkpoint
metadata written by either package parses in the other and Config.hash()
(which checkpoints carry, and resume checks) is the same number in both.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

# Degradation ids (reference: util/dataset_utils.py:40).
DE_DICT: Dict[str, int] = {
    "denoise_15": 0, "denoise_25": 1, "denoise_50": 2, "derain": 3,
    "dehaze": 4, "deblur": 5, "lowlight": 6, "single": 7,
}


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
class DataConfig:
    """Dataset and degradation pipeline (reference: util/dataset_utils.py:27-281)."""

    de_type: Tuple[str, ...] = ("denoise_15", "denoise_25", "denoise_50", "derain", "dehaze")
    data_file_dir: str = "data_dir/"
    denoise_dir: str = "data/Train/Denoise/"
    derain_dir: str = "data/Train/Derain/"
    dehaze_dir: str = "data/Train/Dehaze/"
    deblur_dir: str = "data/Train/Deblur/"
    lowlight_dir: str = "data/Train/Lowlight/"
    single_dir: str = "data/Train/Single/"
    patch_size: int = 128
    crop_base: int = 16  # images centre-cropped to multiples of this
    # oversampling factors (reference: util/dataset_utils.py:89-161)
    oversample: Dict[str, int] = field(
        default_factory=lambda: {
            "denoise": 5, "derain": 360, "deblur": 5, "lowlight": 20, "single": 5,
        }
    )
    num_workers: int = 8
    prefetch: int = 2  # batches moved to the device ahead of use


@dataclass(frozen=True)
class TrainConfig:
    """Minimax training recipe (reference: trainer.py:22-58,119-126,228-243)."""

    batch_size: int = 3
    num_epochs: int = 51
    lr: float = 1e-4  # critic lr; the transport map takes lr / 2
    lr_step: int = 20  # step decay: lr * 0.1**(epoch // lr_step)
    optimizer: str = "RMSprop"  # or "Adam"
    pairnum: int = 0  # iterations < pairnum // batch_size get the paired L1 term
    Sigma: float = 1e4  # paired L1 weight
    sigma: float = 1.0  # OT transport-cost weight
    gp_weight: float = 10.0  # gradient-penalty weight
    seed: int = 0
    # "reference" keeps the reference's operator-precedence quirk in the
    # Fourier cost (half the mean power); "clean" takes the RMS
    loss_math: str = "reference"
    dtype: str = "float32"  # activation dtype: float32 | bfloat16
    log_every: int = 10
    eval_every: int = 1  # epochs
    ckpt_every: int = 1  # epochs
    ckpt_every_steps: int = 0  # mid-epoch checkpoints (0 = off)
    ckpt_dir: str = "checkpoint/"
    ckpt_keep: int = 3
    run_name: str = "Deraining"
    fail_at_step: int = -1  # fault injection for recovery tests (-1 = off)
    data_axis: str = "data"  # mesh axis name for data parallelism
    sample_every: int = 0  # sample grids every N epochs (0 = off)
    sample_dir: str = "checksample/"


@dataclass(frozen=True)
class EvalConfig:
    """Inference and evaluation (reference: tester.py:13-31)."""

    degset: str = "./data/test/derain/Rain100L/input/"
    tarset: str = "./data/test/derain/Rain100L/target/"
    save: str = "./results/OUT/"
    savetar: str = "./results/TAR/"
    saveres: str = "./results/RES/"
    pad_to: int = 8  # full-size images are reflect-padded to this multiple
    tile: int = 0  # 0 = whole image; else overlap-tiled inference
    tile_overlap: int = 32
    batch_size: int = 1
    noise_sigma: float = 0.0  # synthetic noise on the target


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    critic: CriticConfig = field(default_factory=CriticConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, default=str)

    # fields that only say where artifacts go: they stay out of hash()
    _IO_SINK_FIELDS = (("train", "ckpt_dir"), ("train", "sample_dir"),
                       ("eval", "save"), ("eval", "savetar"),
                       ("eval", "saveres"))

    def hash(self) -> str:
        """Hash of everything that changes what is trained, not where its
        artifacts are written; checkpoints carry it and resume checks it."""
        d = self.to_dict()
        for section, name in self._IO_SINK_FIELDS:
            d[section].pop(name, None)
        return hashlib.sha256(
            json.dumps(d, sort_keys=True, default=str).encode()
        ).hexdigest()[:16]

    def hash_legacy(self) -> str:
        """The older hash of every field, IO sinks included, which older
        checkpoints carry; resume accepts it too."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)


def _recipe(de_type: Tuple[str, ...], run_name: str, **train_overrides) -> Config:
    train = TrainConfig(
        batch_size=3, num_epochs=51, pairnum=10_000_000, Sigma=1e4, sigma=1.0,
        run_name=run_name, **train_overrides,
    )
    return Config(
        data=DataConfig(de_type=de_type, patch_size=128),
        critic=CriticConfig(patch_size=128),
        train=train,
    )


# Named presets, the four README recipes and their siblings
# (reference: README.md:99-115).
PRESETS: Dict[str, Config] = {
    "derain": _recipe(("derain",), "Deraining"),
    "dehaze": _recipe(("dehaze",), "Dehazing"),
    "denoise_50": _recipe(("denoise_50",), "Denoising"),
    "single": _recipe(("single",), "single"),
    "all_in_one": _recipe(
        ("denoise_15", "denoise_25", "denoise_50", "derain", "dehaze"), "AllInOne"
    ),
    "sr_x4": _recipe(("single",), "SRx4"),
    "deblur": _recipe(("deblur",), "Deblurring"),
    "lowlight": _recipe(("lowlight",), "Lowlight"),
}

# The "turbo" model: GDFN hiddens rounded up to 128 and no parity modules
# (not parameter-parity with the reference).
TURBO_MODEL = ModelConfig(ffn_hidden_multiple=128, parity_params=False)
PRESETS["derain_turbo"] = dataclasses.replace(
    _recipe(("derain",), "Deraining_turbo"), model=TURBO_MODEL)
PRESETS["all_in_one_turbo"] = dataclasses.replace(
    PRESETS["all_in_one"], model=TURBO_MODEL,
    train=dataclasses.replace(PRESETS["all_in_one"].train,
                              run_name="AllInOne_turbo"))


def get_preset(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]


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
    """Config from a `Config.to_dict()` of either package; a missing section
    takes its defaults."""
    return Config(model=model_config_from_dict(d.get("model", {})),
                  critic=critic_config_from_dict(d.get("critic", {})),
                  data=_from_dict(DataConfig, d.get("data", {})),
                  train=train_config_from_dict(d.get("train", {})),
                  eval=_from_dict(EvalConfig, d.get("eval", {})))
