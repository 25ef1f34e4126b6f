"""Architecture registry: name -> (full config, smoke config).

Five of the JAX package's ten configs are ported (``src/repro/configs/``):
the dense GQA models and the MoE / MLA ones.  zamba2-7b, xlstm-350m,
whisper-tiny, gemma3-1b and qwen2-vl-2b wait for their block kinds.
"""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_7b, deepseek_v2_236b, moonshot_v1_16b_a3b, qwen2_5_14b, qwen3_8b,
)
from repro_torch.configs.base import ModelConfig, param_count  # noqa: F401

_MODULES = {
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "qwen2.5-14b": qwen2_5_14b,
    "deepseek-7b": deepseek_7b,
    "qwen3-8b": qwen3_8b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {', '.join(ARCH_NAMES)}"
        )
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG
