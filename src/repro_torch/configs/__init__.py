"""Architecture/config registry.

``get_model_config("gemma3-4b")`` returns the exact assigned config;
``get_model_config("gemma3-4b", smoke=True)`` returns the reduced
same-family smoke variant. ``ARCHS`` lists all assigned architectures.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    SHAPES,
    AttentionConfig,
    DataplaneConfig,
    MeshConfig,
    ModelConfig,
    MoEConfig,
    RunConfig,
    ServeConfig,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
    apply_overrides,
    reduced,
)

_ARCH_MODULES = {
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
}

ARCHS = tuple(_ARCH_MODULES)

# long_500k applicability: run for sub-quadratic archs only
# (ModelConfig.is_subquadratic).
LONG_CONTEXT_ARCHS = ("gemma3-4b", "gemma3-1b", "hymba-1.5b", "xlstm-350m")


def get_model_config(name: str, *, smoke: bool = False) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    cfg = importlib.import_module(_ARCH_MODULES[name]).CONFIG
    return reduced(cfg) if smoke else cfg


def cells(include_skipped: bool = False):
    """Yield every (arch, shape) dry-run cell; skips long_500k for pure
    full-attention archs unless ``include_skipped``."""
    for arch in ARCHS:
        for shape in SHAPES.values():
            if (shape.name == "long_500k" and arch not in LONG_CONTEXT_ARCHS
                    and not include_skipped):
                continue
            yield arch, shape


__all__ = [
    "ARCHS",
    "LONG_CONTEXT_ARCHS",
    "SHAPES",
    "AttentionConfig",
    "DataplaneConfig",
    "MeshConfig",
    "ModelConfig",
    "MoEConfig",
    "RunConfig",
    "ServeConfig",
    "ShapeConfig",
    "SSMConfig",
    "TrainConfig",
    "apply_overrides",
    "cells",
    "get_model_config",
    "reduced",
]
