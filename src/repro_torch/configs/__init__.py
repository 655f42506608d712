"""Architecture registry: ``--arch <id>`` resolves through ARCHS.

The port's own copy of ``repro.configs``: the same dataclasses, the
same architecture modules and numbers, so ``get_config(a)`` equals the
reference's field for field for every ``a``."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.configs import (
    deepseek_v3_671b,
    fft_bench,
    gemma2_9b,
    hymba_1p5b,
    mixtral_8x22b,
    nemotron4_15b,
    phi3_medium_14b,
    phi3_vision_4p2b,
    qwen2_5_32b,
    whisper_medium,
    xlstm_1p3b,
)
from repro_torch.configs.base import (
    SHAPES,
    SMOKE_SHAPES,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    ServeConfig,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
    shape_for,
)

_MODULES = {
    "phi-3-vision-4.2b": phi3_vision_4p2b,
    "mixtral-8x22b": mixtral_8x22b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "qwen2.5-32b": qwen2_5_32b,
    "gemma2-9b": gemma2_9b,
    "nemotron-4-15b": nemotron4_15b,
    "phi3-medium-14b": phi3_medium_14b,
    "xlstm-1.3b": xlstm_1p3b,
    "hymba-1.5b": hymba_1p5b,
    "whisper-medium": whisper_medium,
}

ARCHS: Dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
REDUCED: Dict[str, Callable[[], ModelConfig]] = {k: m.reduced for k, m in _MODULES.items()}


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return REDUCED[arch]() if reduced else ARCHS[arch]


def apply_overrides(cfg: ModelConfig, overrides: Dict[str, str]) -> ModelConfig:
    """CLI --override key=value support (ints/floats/bools auto-coerced)."""
    kw = {}
    for k, v in overrides.items():
        field = {f.name: f for f in dataclasses.fields(cfg)}.get(k)
        if field is None:
            raise KeyError(f"no config field {k!r}")
        t = field.type
        if v in ("true", "True", "false", "False"):
            kw[k] = v.lower() == "true"
        else:
            try:
                kw[k] = int(v)
            except ValueError:
                try:
                    kw[k] = float(v)
                except ValueError:
                    kw[k] = v
    return dataclasses.replace(cfg, **kw)


__all__ = [
    "ARCHS", "REDUCED", "SHAPES", "SMOKE_SHAPES", "MLAConfig", "MoEConfig",
    "ModelConfig", "ServeConfig", "ShapeConfig", "SSMConfig", "TrainConfig",
    "apply_overrides", "fft_bench", "get_config", "shape_for",
]
