"""Model and evaluation configuration (field names of the JAX package's
`rcot_tpu/utils/config.py`, so that checkpoint metadata written there
parses here)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, Tuple


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
class EvalConfig:
    """Inference / evaluation defaults of the test CLI (cli/test.py)."""

    save: str = "./results/OUT/"
    savetar: str = "./results/TAR/"
    saveres: str = "./results/RES/"
    tile: int = 0
    tile_overlap: int = 32
    batch_size: int = 1
    noise_sigma: float = 0.0


def model_config_from_dict(d: Mapping[str, Any]) -> ModelConfig:
    """ModelConfig from checkpoint metadata (JSON lists become tuples;
    unknown keys are ignored)."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in d.items() if k in names})
