"""Configuration schema of the port.

Own copies of the JAX package's dataclasses (``GeneratorConfig``,
``NormConfig``, ``CondConfig``, ``DiscriminatorConfig``, ``ModelConfig``,
``TrainConfig``, ``TestConfig``, ``LogConfig``) with the same defaults,
holding the fields that conversion, the train step and the training
loop read. Reference-style multi-document YAML loads through
:func:`load_config`; unknown keys (the JAX package's TPU options such as
``remat``, ``fused_cond`` or ``parallel``) are ignored, as in the JAX package,
so the reference's stage configs and the JAX package's run directories load
unchanged.

The card's machine has no PyYAML, so the port writes its config as JSON text
(:meth:`Config.save`; JSON is YAML, so the JAX package's ``load_config`` reads
it), reads JSON without ``yaml`` and imports ``yaml`` only for a file that is
not JSON, and parses ``--override`` values as JSON (:func:`parse_overrides`).
"""

from __future__ import annotations

import dataclasses
import json
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
    """The fields of the JAX package's ``TrainConfig`` that the train step,
    the optimizers and the training loop read, with its defaults (the
    stage-2 losses)."""

    no_conv: bool = False
    num_workers: int = 8
    batch_size: int = 16
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    D_step_interval: int = 1
    G_step_interval: int = 1
    adam_beta: list[float] = field(default_factory=lambda: [0.8, 0.99])
    num_epoch: int = 40
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
    normalization_db: float | None = -30.0
    jitter_amp: int = 0
    seed: int = 1234
    compute_dtype: str = "float32"
    mel_fft_sizes: list[int] = field(default_factory=lambda: [2048])


@dataclass
class TestConfig:
    num_tests: int = 10
    max_segment: int = 71680


@dataclass
class LogConfig:
    log_interval: int = 1000
    gen_interval: int = 5
    gen_num: int = 5
    save_interval: int = 5
    val_interval: int = 1
    val_lat_cls: bool = False


@dataclass
class Config:
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    log: LogConfig = field(default_factory=LogConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str | Path) -> None:
        """The config as JSON text (valid YAML, so the JAX package's
        ``load_config`` reads it too)."""
        Path(path).write_text(json.dumps(self.to_dict(), indent=2) + "\n")


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
    if target_type is bool and isinstance(value, str):
        low = value.lower()
        if low in ("true", "yes", "on"):
            return True
        if low in ("false", "no", "off"):
            return False
        raise ValueError(f"not a boolean: {value!r}")
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


def _read_documents(path: str | Path) -> dict:
    """The top-level keys of every document of a config file, merged (later
    documents win). A JSON file is read without PyYAML; anything else is
    multi-document YAML, and PyYAML is imported here and only here (the
    card's machine may lack it, and nothing else in the port needs it)."""
    text = Path(path).read_text()
    try:
        doc = json.loads(text)
    except ValueError:
        import yaml

        merged: dict = {}
        for doc in yaml.safe_load_all(text):
            if doc:
                merged.update(doc)
        return merged
    return doc if isinstance(doc, dict) else {}


def parse_override_value(text: str):
    """An ``--override`` value: JSON (numbers, true/false, null, lists,
    quoted strings), else the raw string."""
    try:
        return json.loads(text)
    except ValueError:
        return text


def parse_overrides(pairs: list[str]) -> dict:
    """``["train.batch_size=4", ...]`` -> nested dict of parsed values."""
    out: dict = {}
    for pair in pairs:
        key, sep, value = pair.partition("=")
        if not sep or not key:
            raise ValueError(f"override {pair!r} is not of the form section.key=value")
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = parse_override_value(value)
    return out


def load_config(path: str | Path | None = None, overrides: dict | None = None) -> Config:
    """A validated Config from a reference-style (multi-document) YAML file
    or a JSON file (the port's own ``config.yaml``), then ``overrides``."""
    cfg = Config()
    if path is not None:
        _merge_into(cfg, _read_documents(path))
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
