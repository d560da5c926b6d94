"""arch -> ModelBundle: the uniform interface over model families.

Only the ``dense`` family is ported; every other family raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.core import partition as pt
from repro_torch.models import transformer

FAMILY_MODULES = {"dense": transformer}

NOT_PORTED = {
    "vlm": "ROADMAP.md Queue 1, other families (vlm through transformer.py)",
    "moe": "ROADMAP.md Queue 1, MoE (models/moe.py)",
    "ssm": "ROADMAP.md Queue 1, other families (models/mamba2.py)",
    "hybrid": "ROADMAP.md Queue 1, other families (models/rglru.py)",
    "encdec": "ROADMAP.md Queue 1, other families (models/encdec.py)",
}


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    defs: Any  # nested dict of ParamDef
    loss: Callable  # (params, batch) -> scalar loss (differentiable)
    prefill: Callable  # (params, batch) -> (logits, cache)
    decode_step: Callable  # (params, cache, batch) -> (logits, cache)
    cache_defs: Callable  # (batch, cache_len) -> nested dict of ParamDef
    input_specs: Callable  # (ShapeConfig) -> dict of TensorSpec

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        return pt.init_tree(self.defs, generator, device)


def build(cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig()) -> ModelBundle:
    if cfg.family not in FAMILY_MODULES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.arch}) is not ported yet: "
            f"{NOT_PORTED.get(cfg.family, 'ROADMAP.md Queue 1')}")
    if cfg.score_dtype != "float32":
        # the port's attention scores are f32 in every path (the kernels and
        # their plain versions); the reference's chunked attention honours
        # this field (repro/models/common.py:149) and the port does not yet
        raise ValueError(
            f"score_dtype {cfg.score_dtype!r} ({cfg.arch}): the port computes "
            f"attention scores in float32 only (ROADMAP.md Queue 1 item 9b)")
    mod = FAMILY_MODULES[cfg.family]
    fns = mod.make_fns(cfg, parallel)
    return ModelBundle(
        cfg=cfg,
        defs=mod.param_defs(cfg),
        loss=fns["loss"],
        prefill=fns["prefill"],
        decode_step=fns["decode_step"],
        cache_defs=fns["cache_defs"],
        input_specs=fns["input_specs"],
    )
