"""Assigned architecture registry. ``get(arch_id)`` -> ModelConfig."""
from __future__ import annotations

import dataclasses

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


def with_layers(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """``cfg`` at full width cut to ``n_layers`` layers (0: as it is), the
    drivers' ``--layers``. An enc-dec model's depth is its
    ``n_enc_layers`` and ``n_dec_layers``: replacing ``n_layers`` would cut
    no block and change only the planner's arithmetic, so it is refused."""
    if not n_layers:
        return cfg
    if cfg.family == "encdec":
        raise ValueError(
            f"--layers {n_layers}: {cfg.arch} is an encoder-decoder "
            f"({cfg.n_enc_layers} + {cfg.n_dec_layers} layers); --layers "
            "would cut no block of it, so it runs whole")
    return dataclasses.replace(cfg, n_layers=n_layers)
