"""ZeroInfinityEngine for one device: RunConfig -> model bundle + state.

The counterpart of ``repro/core/engine.py`` for the serving slice: it
builds the family's bundle and initializes its parameters on the engine's
device. Sharded train steps, host-kind parameter tiers and the GSPMD
lowering wait for the training and multi-device slices.
"""
from __future__ import annotations

import torch

from repro_torch.config import RunConfig
from repro_torch.models import registry


class ZeroInfinityEngine:
    def __init__(self, run: RunConfig, device="cuda"):
        self.run = run
        self.device = torch.device(device)
        self.bundle = registry.build(run.model, run.parallel)

    def init_state(self, generator: torch.Generator) -> dict:
        """``{"params": ...}`` drawn from ``generator`` (which must live on
        the engine's device) with the reference's distributions."""
        return {"params": self.bundle.init(generator, self.device)}
