"""Configuration schema of the port.

Own copies of the JAX package's dataclasses (``GeneratorConfig``,
``NormConfig``, ``CondConfig``, ``DiscriminatorConfig``, ``ModelConfig``,
``TrainConfig``, ``LogConfig``) with the same defaults, holding the fields
that conversion and the train step read. Reference-style multi-document YAML
loads through :func:`load_config`; unknown keys are ignored, as in the JAX
package, so the reference's stage configs load unchanged.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass
class NormConfig:
    encoder: str | None = None
    decoder: str | None = None
    bottleneck: str | None = None


@dataclass
class CondConfig:
    encoder: str | None = None
    decoder: str | None = "target"
    bottleneck: str | None = "target"


@dataclass
class GeneratorConfig:
    decoder_ratios: list[int] = field(default_factory=lambda: [10, 8, 2, 2])
    decoder_channels: list[int] = field(default_factory=lambda: [256, 128, 64, 32, 16])
    num_bottleneck_layers: int = 0
    content_dim: int = 128
    conditional_dim: int = 128
    num_res_blocks: int = 3
    encoder_model: str = "conv"  # 'conv' | 'wavlm'
    num_enc_layers: int = 16
    mrf_kernel_sizes: list[int] = field(default_factory=lambda: [3, 7, 11])
    mrf_dilations: list[int] = field(default_factory=lambda: [1, 3, 5])
    norm_layer: NormConfig = field(default_factory=NormConfig)
    weight_norm: NormConfig = field(
        default_factory=lambda: NormConfig("weight_norm", "weight_norm", "weight_norm")
    )
    conditioning: CondConfig = field(default_factory=CondConfig)

    @property
    def total_ratio(self) -> int:
        r = 1
        for x in self.decoder_ratios:
            r *= x
        return r


@dataclass
class DiscriminatorConfig:
    num_disc: int = 3
    num_layers: int = 4
    num_channels_base: int = 16
    num_channel_mult: int = 4
    downsampling_factor: int = 4


@dataclass
class ModelConfig:
    sample_rate: int = 16000
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    discriminator: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)


@dataclass
class TrainConfig:
    """The fields of the JAX package's ``TrainConfig`` that the train step
    and the optimizers read, with its defaults (the stage-2 losses)."""

    no_conv: bool = False
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    D_step_interval: int = 1
    G_step_interval: int = 1
    adam_beta: list[float] = field(default_factory=lambda: [0.8, 0.99])
    lambda_rec: float = 10.0
    lambda_idt: float = 1.0
    lambda_feat: float = 2.0
    lambda_spec: float = 5.0
    lambda_wave: float = 0.0
    lambda_latcls: float = 0.0
    lambda_cont_emb: float = 10.0
    lambda_corrupted: float = 1.0
    lambda_converted: float = 0.0
    lambda_f0: float = 1000.0
    grad_max_norm_D: float | None = None
    grad_max_norm_G: float | None = None
    max_segment: int = 8960
    freeze_subnets: list[str] | None = field(default_factory=list)
    jitter_amp: int = 0
    compute_dtype: str = "float32"
    mel_fft_sizes: list[int] = field(default_factory=lambda: [2048])


@dataclass
class LogConfig:
    val_lat_cls: bool = False


@dataclass
class Config:
    train: TrainConfig = field(default_factory=TrainConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    log: LogConfig = field(default_factory=LogConfig)


def _coerce(value: Any, target_type: Any):
    """Best-effort coercion of YAML scalars onto the declared field type."""
    if value is None:
        return None
    args = [a for a in typing.get_args(target_type) if a is not type(None)]
    if typing.get_origin(target_type) in (list, tuple):
        return list(value)
    if args and typing.get_origin(target_type) is not None:  # X | None
        for t in args:
            try:
                return _coerce(value, t)
            except (TypeError, ValueError):
                continue
        return value
    if target_type in (bool, int, float, str):
        return target_type(value)
    return value


def _merge_into(dc: Any, src: dict) -> Any:
    hints = typing.get_type_hints(type(dc))
    for key, value in src.items():
        if key not in hints:
            continue
        current = getattr(dc, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _merge_into(current, value)
        else:
            setattr(dc, key, _coerce(value, hints[key]))
    return dc


def load_config(path: str | Path | None = None, overrides: dict | None = None) -> Config:
    """A validated Config from a reference-style (multi-document) YAML file.

    PyYAML is imported here and only here: the card's machine may lack it,
    and nothing else in the port needs it.
    """
    cfg = Config()
    if path is not None:
        import yaml

        merged: dict = {}
        with open(path) as f:
            for doc in yaml.safe_load_all(f):
                if doc:
                    merged.update(doc)
        _merge_into(cfg, merged)
    if overrides:
        _merge_into(cfg, overrides)
    validate(cfg)
    return cfg


def validate(cfg: Config) -> None:
    g = cfg.model.generator
    if len(g.decoder_channels) != len(g.decoder_ratios) + 1:
        raise ValueError(
            "decoder_channels must have len(decoder_ratios)+1 entries, got "
            f"{len(g.decoder_channels)} vs {len(g.decoder_ratios)} ratios")
    if cfg.train.max_segment % g.total_ratio:
        raise ValueError(
            f"train.max_segment={cfg.train.max_segment} must be a multiple of "
            f"the total decoder ratio {g.total_ratio}")
    if g.encoder_model not in ("conv", "wavlm"):
        raise ValueError(f"unknown encoder_model {g.encoder_model!r}")
