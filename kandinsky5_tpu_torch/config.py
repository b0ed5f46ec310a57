"""Typed configuration for the PyTorch port.

Counterpart of ``kandinsky5_tpu/config.py``: the same dataclasses and the
same YAML loader, copied so that the port never imports the JAX package
(whose ``__init__`` imports jax). The eight released YAMLs have their own
copy in ``kandinsky5_tpu_torch/configs/`` (:data:`CONFIG_DIR`); a test
holds each copy's content equal to the JAX package's file's.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import yaml

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs")


@dataclass(frozen=True)
class DiTParams:
    """Architecture of the 2B DiffusionTransformer3D.

    Mirrors the constructor arguments of the reference DiT
    (kandinsky/models/dit.py:82-127); defaults are the released 2B config
    (kandinsky/utils.py:143-156).
    """

    in_visual_dim: int = 16
    out_visual_dim: int = 16
    in_text_dim: int = 3584
    in_text_dim2: int = 768
    time_dim: int = 512
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    model_dim: int = 1792
    ff_dim: int = 7168
    num_text_blocks: int = 2
    num_visual_blocks: int = 32
    axes_dims: Tuple[int, int, int] = (16, 24, 24)
    visual_cond: bool = True

    @property
    def head_dim(self) -> int:
        return sum(self.axes_dims)

    @property
    def num_heads(self) -> int:
        return self.model_dim // self.head_dim

    @property
    def visual_embed_dim(self) -> int:
        """Input channels of the visual patch embedding.

        16 latent + 16 condition + 1 mask = 33 when visual_cond is set
        (kandinsky/models/dit.py:105).
        """
        d = self.in_visual_dim
        return 2 * d + 1 if self.visual_cond else d

    @property
    def patch_dim(self) -> int:
        return math.prod(self.patch_size) * self.visual_embed_dim


@dataclass(frozen=True)
class AttentionConfig:
    """Attention backend selection (configs/*.yaml ``model.attention``)."""

    type: str = "flash"  # "flash" (dense) or "nabla" (block-sparse)
    causal: bool = False
    local: bool = False
    glob: bool = False
    window: int = 3
    # NABLA parameters (10s configs only; configs/config_10s_sft.yaml)
    P: float = 0.9
    wT: int = 11
    wH: int = 3
    wW: int = 3
    add_sta: bool = True
    method: str = "topcdf"
    # Extensions of the JAX package, not in the released YAMLs: a mask
    # shared across layers, query banks, a density cap and threshold
    # bisection. The JAX package defaults them to its TPU-tuned mode
    # (q_rows=8, max_density=0.75, "bisect"); the port defaults to the
    # faithful mode the reference computes (and the JAX package computes
    # on the CPU) and runs nothing else: the pipeline raises on any other
    # value.
    shared_mask: bool = False
    q_rows: int = 1
    max_density: Optional[float] = None
    threshold_method: str = "sort"


@dataclass(frozen=True)
class VAEConfig:
    checkpoint_path: str = "./weights/vae/"
    name: str = "hunyuan"


@dataclass(frozen=True)
class TextEncoderConfig:
    checkpoint_path: str = ""
    emb_size: int = 3584
    max_length: int = 256


@dataclass(frozen=True)
class TextEmbedderConfig:
    qwen: TextEncoderConfig = field(
        default_factory=lambda: TextEncoderConfig(emb_size=3584, max_length=256)
    )
    clip: TextEncoderConfig = field(
        default_factory=lambda: TextEncoderConfig(emb_size=768, max_length=77)
    )


@dataclass(frozen=True)
class MagCacheConfig:
    """Calibrated per-config magnitude ratios (configs/*_sft.yaml magcache:)."""

    mag_ratios: Tuple[float, ...] = ()
    threshold: float = 0.12
    K: int = 2
    retention_ratio: float = 0.2


@dataclass(frozen=True)
class ModelConfig:
    checkpoint_path: str = ""
    vae: VAEConfig = field(default_factory=VAEConfig)
    text_embedder: TextEmbedderConfig = field(default_factory=TextEmbedderConfig)
    dit_params: DiTParams = field(default_factory=DiTParams)
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    num_steps: int = 50
    guidance_weight: float = 5.0


@dataclass(frozen=True)
class MetricsConfig:
    scale_factor: Tuple[float, float, float] = (1.0, 2.0, 2.0)
    resolution: int = 512
    # present in 10s YAMLs but never read by the reference runtime
    # (SURVEY.md §2.17); kept for round-trip fidelity.
    scheduler_scale: Optional[float] = None


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    resolution: int = 512
    magcache: Optional[MagCacheConfig] = None


def _build(cls, data: Any):
    """Recursively construct a dataclass from a nested dict, ignoring
    unknown keys (forward compatibility with reference YAML quirks)."""
    if data is None:
        return None
    if not dataclasses.is_dataclass(cls):
        if cls in (Tuple[int, int, int], Tuple[float, float, float], Tuple[float, ...]):
            return tuple(data)
        return data
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in dict(data).items():
        f = fields.get(key)
        if f is None:
            continue
        ftype = f.type
        origin = getattr(ftype, "__origin__", None)
        if isinstance(ftype, str):
            ftype = _TYPE_NAMES.get(ftype, ftype)
            origin = getattr(ftype, "__origin__", None)
        if dataclasses.is_dataclass(ftype):
            kwargs[key] = _build(ftype, value)
        elif origin is tuple and isinstance(value, (list, tuple)):
            kwargs[key] = tuple(value)
        elif isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


_TYPE_NAMES = {
    "DiTParams": DiTParams,
    "AttentionConfig": AttentionConfig,
    "VAEConfig": VAEConfig,
    "TextEncoderConfig": TextEncoderConfig,
    "TextEmbedderConfig": TextEmbedderConfig,
    "MagCacheConfig": MagCacheConfig,
    "ModelConfig": ModelConfig,
    "MetricsConfig": MetricsConfig,
    "Optional[MagCacheConfig]": MagCacheConfig,
    "Optional[float]": float,
    "Tuple[int, int, int]": tuple,
    "Tuple[float, float, float]": tuple,
    "Tuple[float, ...]": tuple,
}


def load_config(path: str) -> Config:
    """Load one of the eight reference-format YAML configs
    (e.g. configs/config_5s_sft.yaml) into a typed :class:`Config`."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    return config_from_dict(raw)


def config_from_dict(raw: dict) -> Config:
    cfg = _build(Config, raw)
    # "resolution" lives under metrics in the YAML files but at top level in
    # the reference's default conf (kandinsky/utils.py:196); accept both.
    if raw.get("metrics", {}).get("resolution") is not None:
        cfg = dataclasses.replace(cfg, resolution=raw["metrics"]["resolution"])
    return cfg
