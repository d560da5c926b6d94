"""arch -> ModelBundle: the uniform interface over model families.

Every family of the reference is ported: ``dense`` and ``vlm``
(``transformer.py``), ``moe``, ``ssm`` (mamba2), ``hybrid``
(recurrentgemma) and ``encdec`` (seamless-m4t).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.core import partition as pt
from repro_torch.models import encdec, mamba2, moe, rglru, transformer

FAMILY_MODULES = {
    "dense": transformer,
    "vlm": transformer,
    "moe": moe,
    "ssm": mamba2,
    "hybrid": rglru,
    "encdec": encdec,
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
    # (params, batch) -> (scalar, aux metrics dict); families without step
    # metrics (everything but moe) leave it None
    loss_stats: Optional[Callable] = None

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        return pt.init_tree(self.defs, generator, device)

    def n_params(self) -> int:
        return sum(math.prod(d.shape) for d in pt.tree_leaves(self.defs))

    def n_params_active(self) -> int:
        """MoE: an ``experts``-axis leaf counts top_k / E of its elements
        (integer division, as the reference), for 6 * N_active * D."""
        if self.cfg.family != "moe" or not self.cfg.n_experts:
            return self.n_params()
        total = 0
        for d in pt.tree_leaves(self.defs):
            n = math.prod(d.shape)
            if "experts" in d.axes:
                n = n * self.cfg.top_k // self.cfg.n_experts
            total += n
        return total


def param_defs(cfg: ModelConfig):
    """The family's param defs (every leaf's whole shape and axes)."""
    return FAMILY_MODULES[cfg.family].param_defs(cfg)


def build(cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig(), mp=None) -> ModelBundle:
    """The family's bundle; with ``mp`` (a ``core/zero.ModelAxis``) a model
    rank's part of it (``models/common.py``), for every family."""
    if cfg.score_dtype != "float32":
        # the port's attention scores are f32 in every path (the kernels and
        # their plain versions); the reference's chunked attention honours
        # this field (repro/models/common.py:149) and the port does not yet
        raise ValueError(
            f"score_dtype {cfg.score_dtype!r} ({cfg.arch}): the port computes "
            f"attention scores in float32 only (ROADMAP.md Queue 1 item 9b)")
    mod = FAMILY_MODULES[cfg.family]
    fns = mod.make_fns(cfg, parallel, mp)
    return ModelBundle(
        cfg=cfg,
        defs=param_defs(cfg),
        loss=fns["loss"],
        prefill=fns["prefill"],
        decode_step=fns["decode_step"],
        cache_defs=fns["cache_defs"],
        input_specs=fns["input_specs"],
        loss_stats=fns.get("loss_stats"),
    )
