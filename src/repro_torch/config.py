"""Configuration system: model / parallelism / offload / train configs.

A copy of ``repro/config.py`` for the PyTorch port, which imports nothing
from the JAX package. Everything is a frozen dataclass so configs are
hashable. ``repro_torch.configs`` registers one ``ModelConfig`` per
assigned architecture; ``SHAPES`` defines the assigned input-shape set.
Planner references (``repro.plan``) name the planner, ``repro_torch/plan.py``
in the port.
"""
from __future__ import annotations

import dataclasses
import warnings as _warnings
from typing import Optional, Tuple


def _require_choice(cls: str, field: str, value, allowed: tuple) -> None:
    """Config validation that survives ``python -O`` (asserts don't) and
    gives the planner a catchable, self-describing error for infeasible
    overrides: the offending field and the allowed values."""
    if value not in allowed:
        raise ValueError(
            f"{cls}.{field}={value!r}: must be one of {allowed}")


def _require_min(cls: str, field: str, value, minimum) -> None:
    if value < minimum:
        raise ValueError(
            f"{cls}.{field}={value!r}: must be >= {minimum}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    mlp_kind: str = "swiglu"  # swiglu | geglu | relu2 | gelu
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    conv_width: int = 4
    # --- hybrid (recurrentgemma) ---
    window: int = 0  # local attention window; 0 = global
    lru_width: int = 0
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    # --- enc-dec ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # --- vlm ---
    vision_len: int = 0  # number of precomputed patch-embedding positions
    # numerics
    dtype: str = "bfloat16"
    score_dtype: str = "float32"  # attention score/softmax tensor dtype
    moe_combine_dtype: str = "float32"  # MoE combine scatter-add dtype
    attn_chunk: int = 256  # chunked-attention q/kv block size (perf knob)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? (SSM / windowed hybrids)."""
        return self.family in ("ssm", "hybrid")

    def padded_vocab(self, multiple: int = 2048) -> int:
        """Pad vocab so TP shards are even and MXU-aligned (Megatron-style)."""
        v = self.vocab_size
        return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How the model is laid out on the mesh. Paper technologies are knobs."""

    zero_stage: int = 3  # 0=DP, 1=opt, 2=opt+grads, 3=opt+grads+params
    zero_scope: str = "global"  # "global" (paper) | "pod" (hierarchical, beyond-paper)
    partition_mode: str = "allgather"  # "allgather" (bandwidth-centric) | "broadcast" (baseline)
    attn_strategy: str = "auto"  # auto | tp | cp (context parallel)
    pure_dp: bool = False  # paper-faithful: NO tensor slicing — batch over ALL
    # mesh axes, ZeRO-3 partitions params across all of them (paper Sec. 8.4)
    moe_zero_stage: int = 3  # ZeRO stage for EXPERT weights only: top-k MoE
    # cuts per-gathered-byte AIT by k/E, so stage-3 expert gathers can become
    # the collective bottleneck; stage<=2 keeps experts EP-sharded + dp-
    # replicated (opt states still partitioned) — see EXPERIMENTS.md §Perf
    tiling_factor: int = 1  # memory-centric tiling for big linears
    prefetch: int = 1  # overlap-centric: layers of parameter prefetch (0=off)
    remat: str = "full"  # full | dots | none — activation checkpoint policy
    grad_accum: int = 1
    grad_compression: str = "none"  # none | int8 (cross-pod, error feedback)
    engine: str = "pjit"  # pjit (GSPMD-native) | zero3 (explicit shard_map)

    def __post_init__(self):
        c = "ParallelConfig"
        _require_choice(c, "zero_stage", self.zero_stage, (0, 1, 2, 3))
        _require_choice(c, "zero_scope", self.zero_scope, ("global", "pod"))
        _require_choice(c, "partition_mode", self.partition_mode,
                        ("allgather", "broadcast"))
        _require_choice(c, "attn_strategy", self.attn_strategy,
                        ("auto", "tp", "cp"))
        _require_choice(c, "remat", self.remat, ("full", "dots", "none"))
        _require_choice(c, "grad_compression", self.grad_compression,
                        ("none", "int8"))
        _require_choice(c, "engine", self.engine, ("pjit", "zero3"))
        _require_min(c, "grad_accum", self.grad_accum, 1)
        if self.grad_compression != "none" and self.engine != "zero3":
            raise ValueError(
                "ParallelConfig.grad_compression='int8' requires "
                "engine='zero3': the GSPMD engine's gradient reduction is "
                "placed by XLA and has no compressed collective path")


@dataclasses.dataclass(frozen=True)
class OffloadConfig:
    """Infinity offload engine placement (paper Table 2 tiers).

    Each model-state class gets its own tier, independently:
      * ``param_tier``  — bf16 compute params. ``host`` places them in the
        backend's pinned-host memory kind (streamed to HBM ahead of the
        per-layer all-gather); ``nvme`` round-trips each rank's flat shard
        through the ``NvmeStore`` with a layer read-ahead window.
      * ``grad_tier``   — reduce-scattered fp32 gradients. ``host``/``nvme``
        drain them out of device memory right after the backward, overlapped
        with the streamed optimizer pipeline that consumes them.
      * ``opt_tier``    — fp32 master/m/v. ``host`` keeps them in pinned host
        memory; ``nvme`` streams them chunk-by-chunk (read ‖ update ‖ write).
    """

    param_tier: str = "device"  # device | host | nvme
    grad_tier: str = "device"  # device | host | nvme
    opt_tier: str = "device"  # device | host | nvme
    act_tier: str = "device"  # device | host    (activation checkpoints)
    param_quant: str = "none"  # none | q8 | q4 — block-quantized wire format
    # for slow-tier param rows (core/qformat.py); shrinks slow-tier traffic
    # and the pinned staging budget by the compression ratio
    nvme_dir: str = "/tmp/repro_nvme"
    pinned_buffer_mb: int = 64  # shared pinned buffer-pool budget (all stores)
    overlap: bool = True  # async prefetch/writeback threads
    param_read_ahead: int = 2  # slow-tier param reads in flight beyond the window
    prefetch_layers: int = 0  # layered-epoch window; 0 = bandwidth-aware auto
    # (schedule.default_prefetch_layers from the paper's Sec. 3-4 model)
    nvme_workers: int = 2  # worker threads per slow-tier store
    expert_hot_mb: int = 0  # MoE hot-expert cache budget (MiB) for the
    # layered epoch's popularity cache; 0 = auto (the 2*top_k hottest expert
    # rows — schedule.resolve_expert_hot_bytes)

    def __post_init__(self):
        c = "OffloadConfig"
        tiers = ("device", "host", "nvme")
        _require_choice(c, "param_tier", self.param_tier, tiers)
        _require_choice(c, "grad_tier", self.grad_tier, tiers)
        _require_choice(c, "opt_tier", self.opt_tier, tiers)
        _require_choice(c, "act_tier", self.act_tier, ("device", "host"))
        _require_choice(c, "param_quant", self.param_quant, ("none", "q8", "q4"))
        _require_min(c, "param_read_ahead", self.param_read_ahead, 1)
        _require_min(c, "prefetch_layers", self.prefetch_layers, 0)
        _require_min(c, "nvme_workers", self.nvme_workers, 1)
        _require_min(c, "pinned_buffer_mb", self.pinned_buffer_mb, 1)
        _require_min(c, "expert_hot_mb", self.expert_hot_mb, 0)

    @property
    def opt_offgraph(self) -> bool:
        """Whether the optimizer update runs outside the jitted step.

        True when optimizer states live on NVMe (they never enter the graph)
        or when gradients drain to a slow tier (the update must consume them
        host-side after the drain). The jitted step is then grads-only.
        Engine-dependent promotion (the explicit engine's layered epoch also
        forces the update off-graph) lives in ``RunConfig.opt_offgraph``.
        """
        return self.opt_tier == "nvme" or self.grad_tier != "device"


def make_parallel(engine: str = "pjit", **kw) -> ParallelConfig:
    """Engine-aware ParallelConfig: the explicit zero3 engine is pure-dp
    (paper headline: no model parallelism), the GSPMD engine composes
    TP/CP/EP. Single entry point for launchers/benchmarks/tests."""
    if engine == "zero3":
        kw.setdefault("pure_dp", True)
    return ParallelConfig(engine=engine, **kw)


def make_offload(tier: Optional[str] = None, *, opt_tier: Optional[str] = None,
                 param_tier: str = "device", grad_tier: str = "device",
                 **kw) -> OffloadConfig:
    """Tier selection with identical meaning for both engines.

    .. deprecated::
        The positional ``tier`` means the *optimizer* tier — a recurring
        confusion. Pass ``opt_tier=`` explicitly, or better: derive the
        whole placement from hardware with ``repro.plan.plan_run(...)`` and
        lower via ``InfinityPlan.to_run_config()``.
    """
    if tier is not None:
        if opt_tier is not None:
            raise ValueError(
                "make_offload: pass either the deprecated positional `tier` "
                "or `opt_tier=`, not both")
        _warnings.warn(
            "make_offload(tier): the positional `tier` means the OPTIMIZER "
            "tier; use opt_tier= (or derive the placement with "
            "repro.plan.plan_run)", DeprecationWarning, stacklevel=2)
        opt_tier = tier
    return OffloadConfig(opt_tier=opt_tier or "device", param_tier=param_tier,
                         grad_tier=grad_tier, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 10
    steps: int = 100
    seed: int = 0
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 2


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def __post_init__(self):
        _require_choice("ShapeConfig", "kind", self.kind,
                        ("train", "prefill", "decode"))


# The assigned input-shape set (identical for all 10 LM-family archs).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Top-level bundle handed to the engine / launcher."""

    model: ModelConfig
    parallel: ParallelConfig = ParallelConfig()
    offload: OffloadConfig = OffloadConfig()
    train: TrainConfig = TrainConfig()

    @property
    def opt_offgraph(self) -> bool:
        """Engine-aware off-graph resolution: slow-tier optimizer states or
        gradient drains always force it; NVMe-resident *params* force it
        only on the explicit engine, whose layered epoch never assembles the
        flat shards an in-graph update would need. The GSPMD engine still
        assembles params for its jitted step, so its in-graph Adam (and the
        optimizer state it checkpoints) stays viable there.
        """
        return self.offload.opt_offgraph or (
            self.offload.param_tier == "nvme" and self.parallel.engine == "zero3")

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
