"""Architecture registry: name -> (full config, smoke config).

All ten of the JAX package's configs (``src/repro/configs/``), each equal
to its counterpart field by field.
"""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_7b, deepseek_v2_236b, gemma3_1b, moonshot_v1_16b_a3b,
    qwen2_5_14b, qwen2_vl_2b, qwen3_8b, whisper_tiny, xlstm_350m, zamba2_7b,
)
from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ModelConfig, ShapeConfig, active_param_count, param_count,
)

_MODULES = {
    "zamba2-7b": zamba2_7b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "whisper-tiny": whisper_tiny,
    "xlstm-350m": xlstm_350m,
    "qwen2.5-14b": qwen2_5_14b,
    "deepseek-7b": deepseek_7b,
    "gemma3-1b": gemma3_1b,
    "qwen3-8b": qwen3_8b,
    "qwen2-vl-2b": qwen2_vl_2b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {', '.join(ARCH_NAMES)}"
        )
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG
