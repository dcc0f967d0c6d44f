"""Architecture registry: ``get_config(arch_id)`` / ``reduced_config(arch_id)``.

The port keeps its own copy of the JAX package's configuration data, so
the same arch ids resolve to the same ``ModelConfig`` in both packages.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401 (re-exports)
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SHAPES,
    SMOKE_SHAPE,
    ShapeConfig,
    SSMConfig,
    reduce_config,
)

_MODULES = {
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube3_4b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "phi-3-vision-4.2b": "repro_torch.configs.phi3_vision_4b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).get_config()


def reduced_config(arch_id: str) -> ModelConfig:
    return reduce_config(get_config(arch_id))


def cells(include_skipped: bool = False):
    """Yield every (arch_id, shape_name) dry-run cell in assignment order."""
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape_name in SHAPES:
            if not include_skipped and shape_name in cfg.skip_shapes:
                continue
            yield arch_id, shape_name
