"""Architecture registry: name -> (full config, smoke config).

Only ``qwen3-8b`` is ported so far; the JAX package's other nine configs
(``src/repro/configs/``) are still to copy.
"""
from __future__ import annotations

from repro_torch.configs import qwen3_8b
from repro_torch.configs.base import ModelConfig, param_count  # noqa: F401

_MODULES = {
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
