"""Paper Eqs. 1-11: memory requirements, arithmetic intensity, efficiency.

A copy of ``repro/core/model_math.py`` for the PyTorch port, which imports
nothing from the JAX package (the arithmetic is pure Python, so the copy is
exact: ``tests/test_torch_plan.py`` evaluates every public function in both
packages on a grid and holds the results equal). It is used by the
planner (``plan.py``), which places state classes on tiers by these byte
counts and predicts each offloaded class's efficiency, and by the
scheduler's window (``core/schedule.py``).

All sizes are bytes unless noted. ``params`` means a parameter *count*.
Mixed precision per the paper: 2-byte params/grads (fp16 on V100, bf16 on
the H100), fp32 Adam state (momentum+variance+master params+master grads)
-> 20 bytes per parameter total for model states (paper Eq. 2 uses
20*params).
"""
from __future__ import annotations

import dataclasses
import math

# ---------------------------------------------------------------------------
# Paper Sec. 3 — memory requirements for a GPT-like transformer
# ---------------------------------------------------------------------------

BYTES_PER_PARAM_MODEL_STATES = 20  # 2 (fp16 p) + 2 (fp16 g) + 16 (fp32 m,v,p32,g32)
BYTES_PER_PARAM_FP16 = 2
BYTES_PER_PARAM_OPT = 16  # fp32 momentum + variance + master param + master grad


def transformer_params(nl: int, hd: int) -> int:
    """Paper Eq. 1: total params ~= 12 * nl * hd^2 (4 linears per block)."""
    return 12 * nl * hd * hd


def model_states_bytes(nl: int, hd: int) -> int:
    """Paper Eq. 2: 240 * nl * hd^2 bytes for params+grads+optimizer states."""
    return BYTES_PER_PARAM_MODEL_STATES * transformer_params(nl, hd)


def activation_checkpoint_bytes(nl: int, hd: int, bsz: int, seq: int, ci: int = 1) -> int:
    """Paper Eq. 3: 2 * bsz * seq * hd * nl / ci bytes (fp16 checkpoints)."""
    return 2 * bsz * seq * hd * nl // ci


def total_activation_bytes(nl: int, hd: int, bsz: int, seq: int, attn_heads: int) -> int:
    """Full (un-checkpointed) activation footprint: AWM (Eq. 5) summed over nl."""
    return nl * activation_working_memory_bytes(hd, bsz, seq, attn_heads, ci=1)


def model_state_working_memory_bytes(hd: int) -> int:
    """Paper Eq. 4 (MSWM): largest operator = hd x 4hd linear, params+grads fp16."""
    return 4 * hd * 4 * hd


def activation_working_memory_bytes(
    hd: int, bsz: int, seq: int, attn_heads: int, ci: int = 1
) -> int:
    """Paper Eq. 5 (AWM): bsz * seq * ci * (16*hd + 2*attn_heads*seq)."""
    return bsz * seq * ci * (16 * hd + 2 * attn_heads * seq)


# ---------------------------------------------------------------------------
# Paper Sec. 4 — AIT and efficiency
# ---------------------------------------------------------------------------


def computation_per_iter(nl: int, hd: int, bsz: int, seq: int) -> float:
    """Paper Eq. 8: 2*4*12 * bsz * seq * nl * hd^2 FLOPs.

    fwd (2x) + bwd (2x fwd) + recompute (1x fwd) = 4x fwd multiplier; the
    leading 2 is multiply+add.
    """
    return 2.0 * 4.0 * bsz * seq * transformer_params(nl, hd)


def ait_params_grads(bsz: int, seq: int) -> float:
    """Paper Eq. 9: AIT w.r.t. fp16 params+grads = seq * bsz (FLOPs/byte)."""
    return float(seq * bsz)


def ait_optimizer_states(bsz: int, seq: int) -> float:
    """Paper Eq. 10: AIT w.r.t. optimizer states = seq * bsz / 4."""
    return seq * bsz / 4.0


def ait_activation_checkpoints(hd: int, ci: int = 1) -> float:
    """Paper Eq. 11: AIT w.r.t. activation checkpoints = 24 * hd * ci."""
    return 24.0 * hd * ci


def efficiency(ait: float, bw: float, peak_tp: float) -> float:
    """Paper Eq. 6: efficiency = ait*bw / (ait*bw + peak_tp).

    ``bw`` in bytes/s, ``peak_tp`` in FLOPs/s. Models zero overlap (worst
    case); overlap moves real efficiency toward 1 for the overlapped fraction.
    """
    return ait * bw / (ait * bw + peak_tp)


def required_bandwidth(ait: float, peak_tp: float, target_eff: float) -> float:
    """Invert Eq. 6: bandwidth needed for a target efficiency."""
    if not 0.0 < target_eff < 1.0:
        raise ValueError("target_eff must be in (0, 1)")
    return target_eff * peak_tp / (ait * (1.0 - target_eff))


# ---------------------------------------------------------------------------
# ZeRO stage / offload-tier memory accounting (paper Table 2 / Fig. 6a)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Per-device memory/bandwidth of one tier level (paper Fig. 2b)."""

    n_devices: int
    device_mem: float  # bytes of fast memory per accelerator (HBM)
    host_mem_per_node: float  # bytes of host DRAM per node
    nvme_per_node: float  # bytes of NVMe per node
    devices_per_node: int = 16

    @property
    def n_nodes(self) -> int:
        return max(1, self.n_devices // self.devices_per_node)

    @property
    def aggregate_device_mem(self) -> float:
        return self.n_devices * self.device_mem

    @property
    def aggregate_host_mem(self) -> float:
        return self.n_nodes * self.host_mem_per_node

    @property
    def aggregate_nvme(self) -> float:
        return self.n_nodes * self.nvme_per_node


DGX2_NODE = ClusterSpec(
    n_devices=16,
    device_mem=32e9,
    host_mem_per_node=1.5e12,
    nvme_per_node=28e12,
)

TPU_V5E_POD = ClusterSpec(
    n_devices=256,
    device_mem=16e9,
    host_mem_per_node=512e9,   # per-host DRAM on a v5e host (4 hosts of 64 chips -> normalized)
    nvme_per_node=10e12,
    devices_per_node=64,
)


@dataclasses.dataclass(frozen=True)
class PlacementPolicy:
    """Where each model-state component lives + whether it is partitioned.

    Reproduces paper Table 2 rows. Tiers: "device", "host", "nvme".
    """

    name: str
    param_tier: str = "device"
    opt_tier: str = "device"
    params_partitioned: bool = True
    opt_partitioned: bool = True


POLICIES = {
    "dp": PlacementPolicy("dp", params_partitioned=False, opt_partitioned=False),
    "zero1": PlacementPolicy("zero1", params_partitioned=False, opt_partitioned=True),
    "zero2": PlacementPolicy("zero2", params_partitioned=False, opt_partitioned=True),
    "zero_offload": PlacementPolicy(
        "zero_offload", opt_tier="host", params_partitioned=False, opt_partitioned=True
    ),
    "zero3": PlacementPolicy("zero3"),
    "zero_inf_cpu": PlacementPolicy("zero_inf_cpu", param_tier="host", opt_tier="host"),
    "zero_inf_nvme": PlacementPolicy("zero_inf_nvme", param_tier="nvme", opt_tier="nvme"),
}


def max_trainable_params(policy: PlacementPolicy, cluster: ClusterSpec,
                         working_mem_fraction: float = 0.7) -> float:
    """Largest parameter count whose model states fit under ``policy``.

    Device memory reserves (1 - working_mem_fraction) for working memory /
    activations, matching the paper's observed Fig. 6a ordering.
    """
    usable_dev = cluster.aggregate_device_mem * working_mem_fraction
    grads_bytes_pp = BYTES_PER_PARAM_FP16  # grads co-located with opt tier in ZeRO-Offload+
    param_bytes_pp = BYTES_PER_PARAM_FP16
    opt_bytes_pp = BYTES_PER_PARAM_OPT

    tiers = {"device": usable_dev, "host": cluster.aggregate_host_mem,
             "nvme": cluster.aggregate_nvme}

    # Unpartitioned states are replicated on every device -> capacity divided
    # by n_devices (paper: "limited to what a single GPU can host").
    def capacity(tier: str, partitioned: bool) -> float:
        total = tiers[tier]
        return total if partitioned else total / cluster.n_devices

    # Parameters + grads.
    param_cap = capacity(policy.param_tier, policy.params_partitioned) / (
        param_bytes_pp + grads_bytes_pp
    )
    opt_cap = capacity(policy.opt_tier, policy.opt_partitioned) / opt_bytes_pp
    return min(param_cap, opt_cap)


# ---------------------------------------------------------------------------
# Generic (per-arch) parameter counting for roofline MODEL_FLOPS
# ---------------------------------------------------------------------------


def model_flops(n_params_active: float, tokens: float) -> float:
    """6 * N * D: fwd 2ND + bwd 4ND (no recompute) — the 'useful' FLOPs."""
    return 6.0 * n_params_active * tokens


def decode_model_flops(n_params_active: float, new_tokens: float) -> float:
    """Decode fwd only: 2 * N per generated token."""
    return 2.0 * n_params_active * new_tokens


def hbm_roundup(x: float, quantum: int = 128) -> int:
    return int(math.ceil(x / quantum) * quantum)
