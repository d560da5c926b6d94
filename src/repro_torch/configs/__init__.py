"""Assigned architecture registry. ``get(arch_id)`` -> ModelConfig."""
from __future__ import annotations

from repro_torch.config import ModelConfig

from . import (
    llava_next_34b,
    smollm_135m,
    llama3_2_3b,
    nemotron_4_340b,
    gemma_7b,
    llama4_scout_17b_a16e,
    granite_moe_1b_a400m,
    mamba2_370m,
    recurrentgemma_9b,
    seamless_m4t_medium,
)

_MODULES = {
    "llava-next-34b": llava_next_34b,
    "smollm-135m": smollm_135m,
    "llama3.2-3b": llama3_2_3b,
    "nemotron-4-340b": nemotron_4_340b,
    "gemma-7b": gemma_7b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "mamba2-370m": mamba2_370m,
    "recurrentgemma-9b": recurrentgemma_9b,
    "seamless-m4t-medium": seamless_m4t_medium,
}

ARCH_IDS = tuple(_MODULES)


def get(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _MODULES[arch_id].CONFIG


def smoke(arch_id: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _MODULES[arch_id].SMOKE
