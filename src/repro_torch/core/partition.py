"""Parameter definitions and initialization (``repro/core/partition.py:33-67``).

A ``ParamDef`` carries shape, dtype, logical axis names and the init rule;
``init_tree`` materializes a nested dict of defs as tensors on one device.
The distributions are the JAX package's (normal * 0.02, zeros, ones,
fan-in scaled, RG-LRU forget-gate), drawn from an explicit
``torch.Generator``: the bits differ from ``jax.random``, so parity tests
load the JAX package's weights through ``repro_torch.bridge`` instead.
The sharding rules wait for the multi-device slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Shape + dtype + logical axis names (one per dim) + init scale."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: str = "bfloat16"
    init: str = "normal"  # normal | zeros | ones | lru_lambda
    init_scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamDef shape {self.shape} vs axes {self.axes}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def initialize(d: ParamDef, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    dtype = d.torch_dtype
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "lru_lambda":
        # RG-LRU forget-gate params: a = exp(-8*softplus(L)*r) spans
        # (0.9, 0.999) per the Griffin paper
        u = torch.empty(d.shape, dtype=torch.float32, device=device).uniform_(
            0.9, 0.999, generator=generator)
        lam = torch.log(torch.expm1(-torch.log(u) / 8.0))  # inverse softplus
        return lam.to(dtype)
    fan_in = d.shape[0] if len(d.shape) > 1 else d.shape[-1]
    scale = d.init_scale if d.init == "normal" else 1.0 / math.sqrt(fan_in)
    x = torch.randn(d.shape, dtype=torch.float32, device=device,
                    generator=generator)
    return (x * scale).to(dtype)


def init_tree(defs, generator: torch.Generator, device) -> dict:
    """Nested dict of ``ParamDef`` -> nested dict of tensors on ``device``
    (leaves drawn in sorted-key order, as ``jax.tree`` flattens dicts)."""
    device = torch.device(device)
    if isinstance(defs, ParamDef):
        return initialize(defs, generator, device)
    return {k: init_tree(defs[k], generator, device) for k in sorted(defs)}


def tree_map(fn, tree):
    """Apply ``fn`` to every non-dict leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
