"""Declarative memory planner: hardware in, `InfinityPlan` out — the
PyTorch port of ``repro/plan.py``.

ZeRO-Infinity's headline ease-of-use claim (paper Sec. 1, Sec. 9) is that the
offload engine decides data movement *automatically* from the Sec. 3 memory
model and the Sec. 4 bandwidth model — the user describes the hardware, not
the placement. This module is that inversion for the repro: instead of
hand-tuning ~10 interacting knobs (`--engine`, three `--offload-*` tiers,
`--prefetch-layers`, `--read-ahead`, `--nvme-workers`, `--pinned-buffer-mb`,
`remat`, `grad_accum`), callers give a ``HardwareSpec`` (detectable from the
live backend) and get back an explainable, frozen ``InfinityPlan``:

  * one tier per model-state class (param / grad / opt / act), chosen by the
    Table-2 offload ladder against the Eq. 1–5 byte arithmetic;
  * the engine, prefetch window (Sec. 3–4 bandwidth model via
    ``schedule.default_prefetch_layers``), read-ahead, pinned-pool budget,
    remat policy, and grad-accum factor;
  * per-decision rationale strings carrying the Eq.-level arithmetic, plus
    predicted per-class efficiency (Eqs. 6+9/10/11) and predicted
    ``peak_resident_param_bytes`` that the executor cross-checks against its
    measured counters;
  * JSON round-trip (``to_json`` / ``from_json``) for benchmark artifacts
    and CI gates.

``InfinityPlan.to_run_config()`` *lowers* the plan to today's ``RunConfig``,
making ``OffloadConfig`` / ``ParallelConfig`` the lowered IR rather than the
user API. Manual knobs survive as per-field ``overrides`` on the derived
plan; an override that contradicts the feasibility math is applied anyway
but recorded loudly in ``plan.warnings``.

For the same explicit ``HardwareSpec`` the port's plan is the reference's
byte for byte (``to_json``; ``tests/test_torch_plan.py`` holds it across
the reference's scenario grid). What differs: ``HardwareSpec.detect``
probes ``torch.cuda`` (or the host with ``device="cpu"``), and the byte
arithmetic walks the port's ``ParamDef`` trees of every family (the
fixed-state families' ``cache_defs`` size their serving state, encdec's
its decoder's and cross-attention caches).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import tempfile
from typing import Dict, Optional, Tuple, Union

from repro_torch.config import (ModelConfig, OffloadConfig, RunConfig, SHAPES,
                                ShapeConfig, TrainConfig, make_parallel)
from repro_torch.core import model_math, qformat, schedule

# Paper Fig. 2b nominal per-device rates, used when a bandwidth is not
# overridden (none of them are detectable from the backend). NVMe/peak come
# from core/schedule.py — one calibration point, not two that can drift.
PAPER_NVME_BW = schedule.PAPER_NVME_BYTES_PER_S
PAPER_HOST_BW = 3.0e9  # host-DRAM (PCIe share) bytes/s per device
PAPER_ICI_BW = 70e9  # device<->device interconnect bytes/s
PAPER_PEAK_FLOPS = schedule.PAPER_PEAK_FLOPS  # V100 fp16 in the paper

# Byte costs per parameter as this repro implements them (annotated against
# paper Eq. 2, whose 20 bytes/param assume fp16 grads + an fp32 grad copy).
PARAM_BYTES_PP = model_math.BYTES_PER_PARAM_FP16  # bf16 compute copy
GRAD_BYTES_PP = 4  # reduce-scattered fp32 gradients (paper: fp16 -> 2)
OPT_BYTES_PP = 12  # fp32 master + m + v (paper Eq. 2: 16 incl. fp32 grad)

# The Table-2 offload ladder: the order in which state classes are demoted
# off the device tier (ZeRO-Offload moves the optimizer first, ZeRO-Infinity
# params last). Activation checkpoints are handled separately (device|host).
OFFLOAD_ORDER = ("opt", "grad", "param")

_TIERS = ("device", "host", "nvme")

DEFAULT_NVME_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_nvme")


def _fmt_bytes(n: float) -> str:
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if abs(n) >= div:
            return f"{n / div:.2f} {unit}"
    return f"{n:.0f} B"


# ---------------------------------------------------------------------------
# HardwareSpec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """The cluster as the planner sees it (paper Fig. 2b, one row per tier).

    Capacities are absolute bytes; bandwidths are bytes/s *per device* (the
    paper's per-GPU share of each link at node scale). ``detect()`` fills
    capacities from the live backend and leaves bandwidths at the paper's
    nominal rates; every field takes an explicit override.
    """

    n_devices: int = 1
    device_mem: float = 16e9  # HBM bytes per device
    host_mem: float = 64e9  # host DRAM bytes (aggregate)
    nvme_capacity: float = 0.0  # NVMe bytes (aggregate); 0 = no NVMe tier
    device_bw: float = 1e12  # HBM bytes/s per device
    host_bw: float = PAPER_HOST_BW
    nvme_bw: float = PAPER_NVME_BW
    interconnect_bw: float = PAPER_ICI_BW
    peak_flops: float = PAPER_PEAK_FLOPS
    devices_per_node: int = 1
    working_mem_fraction: float = 0.7  # device share usable for model states
    source: str = "explicit"  # explicit | detected

    def __post_init__(self):
        if self.n_devices < 1:
            raise ValueError(
                f"HardwareSpec.n_devices={self.n_devices}: must be >= 1")
        for f in ("device_mem", "host_mem", "nvme_capacity", "device_bw",
                  "host_bw", "nvme_bw", "interconnect_bw", "peak_flops"):
            v = getattr(self, f)
            if v < 0:
                raise ValueError(f"HardwareSpec.{f}={v}: must be >= 0")
        if not 0.0 < self.working_mem_fraction <= 1.0:
            raise ValueError(
                f"HardwareSpec.working_mem_fraction={self.working_mem_fraction}:"
                " must be in (0, 1]")

    # -- capacities -----------------------------------------------------

    @property
    def aggregate_device_mem(self) -> float:
        return self.n_devices * self.device_mem

    @property
    def usable_device_mem(self) -> float:
        """Device bytes available to model states (the rest is reserved for
        working memory — MSWM/AWM, paper Eqs. 4–5 — matching
        ``model_math.max_trainable_params``)."""
        return self.aggregate_device_mem * self.working_mem_fraction

    def tier_capacity(self, tier: str) -> float:
        if tier == "device":
            return self.usable_device_mem
        if tier == "host":
            return self.host_mem
        if tier == "nvme":
            return self.nvme_capacity
        raise ValueError(f"unknown tier {tier!r}; allowed: {_TIERS}")

    def tier_bandwidth(self, tier: str) -> float:
        """Per-device bytes/s to reach ``tier`` from compute."""
        if tier == "device":
            return self.device_bw
        if tier == "host":
            return self.host_bw
        if tier == "nvme":
            return self.nvme_bw
        raise ValueError(f"unknown tier {tier!r}; allowed: {_TIERS}")

    # -- elastic membership ---------------------------------------------

    def with_membership(self, n_alive: int) -> "HardwareSpec":
        """The cluster after an elastic membership change: ``n_alive``
        devices survive. Per-device rates (HBM, bandwidths, peak FLOPs) are
        unchanged — the survivors' hardware didn't get slower — but the
        aggregate capacities pooled across nodes (host DRAM, NVMe) scale
        with the alive fraction: losing half the nodes loses half the
        slow-tier pool, which is exactly what makes a re-plan against the
        shrunken spec demote state down the tier ladder
        (``runtime/elastic.py``)."""
        if n_alive == self.n_devices:
            return self
        if n_alive < 1:
            raise ValueError(
                f"with_membership({n_alive}): needs >= 1 surviving device")
        frac = n_alive / self.n_devices
        return dataclasses.replace(
            self, n_devices=n_alive,
            host_mem=self.host_mem * frac,
            nvme_capacity=self.nvme_capacity * frac,
            devices_per_node=max(1, min(self.devices_per_node, n_alive)))

    # -- detection ------------------------------------------------------

    @classmethod
    def detect(cls, nvme_dir: str = DEFAULT_NVME_DIR, device: str = "cuda",
               **overrides) -> "HardwareSpec":
        """Probe the live machine; any field is overridable by keyword.

        ``device="cuda"``: ``n_devices`` is ``torch.cuda.device_count()``
        and ``device_mem`` the first card's total memory
        (``torch.cuda.mem_get_info``). The total, not the free bytes: the
        reference takes its allocator's limit, a property of the card and
        not of what the probing process happens to hold, and
        ``working_mem_fraction`` already reserves the working memory. No
        card raises: a CUDA plan is never made for the host. With
        ``device="cpu"`` the "device" memory *is* host DRAM, so
        ``device_mem`` is the host's share, as the reference's on a CPU
        backend. Host DRAM comes from sysconf, NVMe from ``disk_usage`` of
        ``nvme_dir``'s filesystem. Bandwidths and peak FLOPs stay at the
        paper's nominal per-device rates unless overridden, as in the
        reference.
        """
        import torch

        try:
            host_mem = float(os.sysconf("SC_PAGE_SIZE")
                             * os.sysconf("SC_PHYS_PAGES"))
        except (ValueError, OSError, AttributeError):
            host_mem = 64e9
        if torch.device(device).type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "HardwareSpec.detect(device='cuda'): CUDA is not "
                    "available here; pass device='cpu' to plan for the host")
            n = torch.cuda.device_count()
            device_mem = float(torch.cuda.mem_get_info(0)[1])
        elif torch.device(device).type == "cpu":
            n = 1
            device_mem = host_mem / n  # the CPU: HBM == host DRAM share
        else:
            raise ValueError(f"HardwareSpec.detect: device {device!r}; "
                             "want cuda or cpu")
        probe = nvme_dir
        while probe and not os.path.isdir(probe):
            parent = os.path.dirname(probe)
            if parent == probe:
                break
            probe = parent
        try:
            nvme_capacity = float(shutil.disk_usage(probe or "/").free)
        except OSError:
            nvme_capacity = 0.0
        kw = dict(n_devices=n, device_mem=device_mem,
                  host_mem=host_mem, nvme_capacity=nvme_capacity,
                  devices_per_node=n, source="detected")
        kw.update(overrides)
        return cls(**kw)


# ---------------------------------------------------------------------------
# Sec. 3 byte arithmetic per state class
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StateBytes:
    """Global bytes per model-state class for one (model, shape) pair, plus
    the layer-granular quantities the scheduler window math needs."""

    n_params: int
    param: int  # bf16 compute copy (Eq. 2 term: 2 * N)
    grad: int  # fp32 reduce-scattered grads (4 * N in this repro)
    opt: int  # fp32 master+m+v (12 * N in this repro)
    act_ckpt: int  # Eq. 3 activation checkpoints at grad_accum=1
    act_full: int  # Eq. 5 summed over layers (remat="none" footprint)
    n_layers: int
    layer_params: int  # parameter count of one scheduled layer (padded);
    # for MoE this is the DENSE row only (ln1+attn+ln2) — expert rows are
    # separate schedule units sized by ``expert_row_params``
    leaf_bytes: Tuple[int, ...]  # per-leaf bytes, sorted descending
    expert_row_params: int = 0  # params of ONE expert row (padded); 0 = dense
    n_experts: int = 0
    top_k: int = 0

    @property
    def states_total(self) -> int:
        return self.param + self.grad + self.opt

    def act_bytes(self, remat: str, grad_accum: int = 1) -> int:
        """Activation footprint under a remat policy and accumulation factor
        (Eq. 3 checkpoints scale with the microbatch)."""
        base = self.act_ckpt if remat != "none" else self.act_full
        return base // max(grad_accum, 1)


def _param_defs(model: ModelConfig):
    from repro_torch.core import partition as pt
    from repro_torch.models import registry

    defs = registry.FAMILY_MODULES[model.family].param_defs(model)
    return defs, pt.tree_leaves(defs)


def state_bytes(model: ModelConfig, shape: ShapeConfig,
                n_devices: int = 1) -> StateBytes:
    """Sec. 3 memory model evaluated on the *actual* parameter defs (not the
    Eq. 1 12·nl·hd² approximation — the registry knows every leaf)."""
    from repro_torch.core import partition as pt

    defs, leaves = _param_defs(model)
    sizes = [math.prod(l.shape) for l in leaves]
    n_params = int(sum(sizes))
    leaf_bytes = tuple(sorted(
        (int(s) * l.torch_dtype.itemsize for s, l in zip(sizes, leaves)),
        reverse=True))

    # layer-granular view (the explicit engine's flat rows). For MoE the
    # scheduled layer row is the DENSE part only — each expert's weights are
    # their own schedule unit, sized separately below
    n_layers = model.n_layers or (model.n_enc_layers + model.n_dec_layers) or 1
    layer_params = max(1, n_params // n_layers)
    expert_row_params, n_experts, top_k = 0, 0, 0
    if isinstance(defs, dict) and "blocks" in defs:
        blk_defs = defs["blocks"]
        if model.family == "moe":
            blk_defs = {k: v for k, v in blk_defs.items() if k != "moe"}
        per_layer = sum(math.prod(l.shape[1:]) if len(l.shape) > 1 else 1
                        for l in pt.tree_leaves(blk_defs))
        layer_params = per_layer + ((-per_layer) % max(n_devices, 1))
    if model.family == "moe":
        from repro_torch.models import moe as moe_mod

        per_e = sum(math.prod(d.shape)
                    for d in moe_mod.expert_row_defs(model).values())
        expert_row_params = per_e + ((-per_e) % max(n_devices, 1))
        n_experts, top_k = model.n_experts, model.top_k

    hd, nl = model.d_model, n_layers
    bsz, seq = shape.global_batch, shape.seq_len
    heads = max(model.n_heads, 1)
    train = shape.kind == "train"
    if train:
        act_ckpt = model_math.activation_checkpoint_bytes(nl, hd, bsz, seq)
        act_full = model_math.total_activation_bytes(nl, hd, bsz, seq, heads)
    else:
        act_ckpt = act_full = 0
    return StateBytes(
        n_params=n_params,
        param=PARAM_BYTES_PP * n_params,
        # gradients and optimizer states exist only while training: a
        # prefill/decode plan must not demote tiers for state it never holds
        grad=GRAD_BYTES_PP * n_params if train else 0,
        opt=OPT_BYTES_PP * n_params if train else 0,
        act_ckpt=act_ckpt,
        act_full=act_full,
        n_layers=n_layers,
        layer_params=layer_params,
        leaf_bytes=leaf_bytes,
        expert_row_params=expert_row_params,
        n_experts=n_experts,
        top_k=top_k,
    )


# ---------------------------------------------------------------------------
# InfinityPlan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Decision:
    """One planned field with the Eq.-level arithmetic that justified it."""

    field: str
    value: str
    why: str


@dataclasses.dataclass(frozen=True)
class InfinityPlan:
    """The frozen, explainable planning artifact.

    Tier/engine/window/budget fields are what ``to_run_config`` lowers;
    ``rationale`` carries one ``Decision`` per field; ``predicted`` holds the
    quantities the executor cross-checks at runtime
    (``peak_resident_param_bytes``, per-class step bytes, Eq. 6 efficiency).
    """

    model: ModelConfig
    shape: ShapeConfig
    hardware: HardwareSpec
    param_tier: str
    grad_tier: str
    opt_tier: str
    act_tier: str
    engine: str
    prefetch_layers: int
    read_ahead: int
    nvme_workers: int
    pinned_buffer_mb: int
    remat: str
    grad_accum: int
    # serving (prefill/decode shapes): the KV-cache tier plan. ``kv_slots``
    # is the number of device-resident decode slots (0 = not a serving
    # plan); overflow sequences park on ``kv_tier`` as ``kv_block_tokens``-
    # sized blocks fetched ``kv_prefetch_blocks`` ahead (core/kvcache.py).
    kv_tier: str = "device"
    kv_slots: int = 0
    kv_block_tokens: int = 0
    kv_prefetch_blocks: int = 2
    # block-quantized wire format for slow-tier param rows (core/qformat.py):
    # "none" | "q8" | "q4". Shrinks predicted wire traffic and the pinned
    # budget by the compression ratio and deepens the prefetch window.
    param_quant: str = "none"
    # MoE expert paging: device-byte budget for the hot-expert cache (LRU +
    # popularity, core/schedule.py). 0 = the runtime default of two waves
    # (2 * top_k expert rows); only meaningful on the zero3 layered epoch.
    expert_hot_mb: int = 0
    objective: str = "throughput"
    feasible: bool = True
    predicted: Tuple[Tuple[str, float], ...] = ()
    rationale: Tuple[Decision, ...] = ()
    warnings: Tuple[str, ...] = ()

    # -- views ----------------------------------------------------------

    @property
    def predictions(self) -> Dict[str, float]:
        return dict(self.predicted)

    @property
    def tiers(self) -> Dict[str, str]:
        return {"param": self.param_tier, "grad": self.grad_tier,
                "opt": self.opt_tier, "act": self.act_tier}

    def why(self, field: str) -> str:
        """The final rationale recorded for ``field`` (a field demoted and
        later escalated keeps every step in ``rationale``; the last entry
        is the decision that stood)."""
        out = ""
        for d in self.rationale:
            if d.field == field:
                out = d.why
        return out

    def summary(self) -> str:
        t = self.tiers
        kv = (f"kv={self.kv_tier}x{self.kv_slots}"
              f"/b{self.kv_block_tokens} " if self.kv_slots else "")
        quant = (f"quant={self.param_quant} "
                 if self.param_quant != "none" else "")
        return (f"plan[{self.model.arch}/{self.shape.name}] "
                f"engine={self.engine} tiers(param/grad/opt/act)="
                f"{t['param']}/{t['grad']}/{t['opt']}/{t['act']} "
                f"window={self.prefetch_layers} read_ahead={self.read_ahead} "
                f"remat={self.remat} grad_accum={self.grad_accum} "
                f"pinned={self.pinned_buffer_mb}MiB " + quant + kv +
                f"eff~{self.predictions.get('efficiency', 1.0):.3f} "
                f"feasible={self.feasible}")

    def explain(self) -> str:
        lines = [self.summary(), ""]
        for d in self.rationale:
            lines.append(f"  {d.field:16s} = {d.value:10s} {d.why}")
        if self.predicted:
            lines.append("")
            lines.append("  predicted:")
            for k, v in self.predicted:
                lines.append(f"    {k:32s} {v:.6g}")
        for w in self.warnings:
            lines.append(f"  !! {w}")
        return "\n".join(lines)

    # -- lowering to the legacy config IR -------------------------------

    def to_run_config(self, train: Optional[TrainConfig] = None,
                      *, nvme_dir: str = DEFAULT_NVME_DIR,
                      overlap: bool = True) -> RunConfig:
        """Lower to ``RunConfig`` — ``OffloadConfig``/``ParallelConfig`` are
        the IR this plan compiles to, not a second user API."""
        parallel = make_parallel(self.engine, remat=self.remat,
                                 grad_accum=self.grad_accum)
        offload = OffloadConfig(
            param_tier=self.param_tier, grad_tier=self.grad_tier,
            opt_tier=self.opt_tier, act_tier=self.act_tier,
            nvme_dir=nvme_dir, pinned_buffer_mb=self.pinned_buffer_mb,
            overlap=overlap, param_read_ahead=self.read_ahead,
            prefetch_layers=self.prefetch_layers,
            nvme_workers=self.nvme_workers,
            param_quant=self.param_quant,
            expert_hot_mb=self.expert_hot_mb)
        return RunConfig(model=self.model, parallel=parallel,
                         offload=offload, train=train or TrainConfig())

    # -- JSON round-trip -------------------------------------------------

    def to_json(self, indent: Optional[int] = 1) -> str:
        d = dataclasses.asdict(self)
        d["plan_version"] = 1
        return json.dumps(d, indent=indent, default=float)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_json(cls, s: str) -> "InfinityPlan":
        d = json.loads(s)
        d.pop("plan_version", None)
        model = dict(d.pop("model"))
        model["block_pattern"] = tuple(model.get("block_pattern") or ())
        d["model"] = ModelConfig(**model)
        d["shape"] = ShapeConfig(**d.pop("shape"))
        d["hardware"] = HardwareSpec(**d.pop("hardware"))
        d["predicted"] = tuple((k, float(v)) for k, v in d.pop("predicted"))
        d["rationale"] = tuple(Decision(**r) if isinstance(r, dict)
                               else Decision(*r) for r in d.pop("rationale"))
        d["warnings"] = tuple(d.pop("warnings"))
        return cls(**d)

    @classmethod
    def load(cls, path: str) -> "InfinityPlan":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

# Plan fields a caller may override (the legacy CLI knobs, field-by-field).
OVERRIDABLE = ("param_tier", "grad_tier", "opt_tier", "act_tier", "engine",
               "prefetch_layers", "read_ahead", "nvme_workers",
               "pinned_buffer_mb", "remat", "grad_accum",
               "kv_tier", "kv_slots", "kv_block_tokens", "param_quant",
               "expert_hot_mb")


def _resolve_model(model: Union[str, ModelConfig]) -> ModelConfig:
    if isinstance(model, str):
        from repro_torch import configs

        return configs.get(model)
    return model


def _resolve_shape(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    if isinstance(shape, str):
        if shape not in SHAPES:
            raise ValueError(f"unknown shape {shape!r}; known: {list(SHAPES)}")
        return SHAPES[shape]
    return shape


def plan_run(model: Union[str, ModelConfig], shape: Union[str, ShapeConfig],
             hardware: Optional[HardwareSpec] = None, *,
             objective: str = "throughput",
             overrides: Optional[Dict[str, object]] = None) -> InfinityPlan:
    """Derive an ``InfinityPlan`` from the Sec. 3–4 model.

    ``objective``:
      * ``"throughput"`` (default) — keep every state class on the fastest
        tier with capacity (the Table-2 ladder demotes opt -> grad -> param
        -> act only on overflow).
      * ``"min_device_mem"`` — demote every class to the slowest tier with
        capacity (maximum device headroom; what a colocated-serving or
        max-model-size run wants).

    ``overrides`` maps plan fields (``OVERRIDABLE``) to forced values —
    the legacy CLI knobs, one field each. Overrides are applied *after*
    derivation; any override that contradicts the feasibility arithmetic is
    still honored but recorded loudly in ``plan.warnings``.
    """
    model = _resolve_model(model)
    shape = _resolve_shape(shape)
    hw = hardware if hardware is not None else HardwareSpec.detect()
    if objective not in ("throughput", "min_device_mem"):
        raise ValueError(f"objective={objective!r}: must be one of "
                         "('throughput', 'min_device_mem')")
    overrides = dict(overrides or {})
    for k in overrides:
        if k not in OVERRIDABLE:
            raise ValueError(
                f"unknown plan override {k!r}; overridable: {OVERRIDABLE}")

    sb = state_bytes(model, shape, hw.n_devices)
    decisions: list[Decision] = []
    warnings: list[str] = []
    class_bytes = {"opt": sb.opt, "grad": sb.grad, "param": sb.param}
    eq_note = {
        "param": f"bf16 copy, 2*N = {_fmt_bytes(sb.param)} (Eq. 2 term)",
        "grad": f"fp32 reduce-scattered, 4*N = {_fmt_bytes(sb.grad)} "
                "(paper Eq. 2 uses fp16 grads)",
        "opt": f"fp32 master+m+v, 12*N = {_fmt_bytes(sb.opt)} "
               "(Eq. 2's 16B/param incl. an fp32 grad copy)",
    }

    # ---- tier placement: the Table-2 ladder ---------------------------
    tiers = {c: "device" for c in OFFLOAD_ORDER}
    act_tier = "device"
    dev_budget = hw.usable_device_mem
    host_budget = hw.host_mem
    nvme_budget = hw.nvme_capacity

    def load(tier: str, act_b: int) -> float:
        t = sum(b for c, b in class_bytes.items() if tiers[c] == tier)
        if act_tier == tier:
            t += act_b
        return t

    act_b = sb.act_bytes("full")
    if objective == "min_device_mem":
        slowest = "nvme" if nvme_budget > 0 else "host"
        for c in OFFLOAD_ORDER:
            tiers[c] = slowest
        act_tier = "host"
        decisions.append(Decision(
            "objective", objective,
            f"min_device_mem: all states demoted to the slowest tier with "
            f"capacity ({slowest}); device keeps only working memory"))
    else:
        # demote states (opt -> grad -> param) while the device overflows
        for c in OFFLOAD_ORDER:
            if load("device", act_b) <= dev_budget:
                break
            tiers[c] = "host"
            warn_free = (f"{c} states ({_fmt_bytes(class_bytes[c])}) demoted "
                         f"device->host: device-resident states "
                         f"{_fmt_bytes(load('device', act_b) + class_bytes[c])}"
                         f" > usable HBM {_fmt_bytes(dev_budget)} "
                         f"(= {hw.working_mem_fraction:.0%} of "
                         f"{hw.n_devices} x {_fmt_bytes(hw.device_mem)})")
            decisions.append(Decision(f"{c}_tier", "host", warn_free))
        if load("device", act_b) > dev_budget:
            act_tier = "host"
            decisions.append(Decision(
                "act_tier", "host",
                f"checkpoints (Eq. 3: 2*bsz*seq*hd*nl = {_fmt_bytes(act_b)}) "
                f"exceed remaining HBM; offloaded (paper Sec. 5.1.3)"))
    # demote host -> nvme while the host overflows
    for c in OFFLOAD_ORDER:
        if load("host", act_b) <= host_budget:
            break
        if tiers[c] != "host":
            continue
        tiers[c] = "nvme"
        decisions.append(Decision(
            f"{c}_tier", "nvme",
            f"{c} states ({_fmt_bytes(class_bytes[c])}) demoted host->nvme: "
            f"host-resident {_fmt_bytes(load('host', act_b) + class_bytes[c])}"
            f" > host DRAM {_fmt_bytes(host_budget)}"))

    # ---- device-transit escalation (the structural limit) -------------
    # Host-homed params still assemble fully on device inside the step
    # (the in-graph streaming moves the whole 2N through HBM), and an
    # in-graph host optimizer streams its 12N likewise. Only the layered
    # epoch (dense, train, NVMe rows) truly bounds device residency, so
    # when the transit alone overflows HBM the genuine ZeRO-Infinity move
    # is the row stream — or the plan is honestly infeasible.
    row_bytes = PARAM_BYTES_PP * sb.layer_params
    layered_ok = (model.family in ("dense", "moe") and shape.kind == "train"
                  and nvme_budget > 0)
    if (tiers["opt"] == "host" and tiers["grad"] == "device"
            and load("device", act_b) + sb.opt > dev_budget
            and nvme_budget > 0):
        tiers["opt"] = "nvme"
        decisions.append(Decision(
            "opt_tier", "nvme",
            f"in-graph host streaming would transit the full optimizer "
            f"({_fmt_bytes(sb.opt)}) through HBM each step; the NVMe "
            f"read||update||write pipeline keeps the update off-graph"))
    if (tiers["param"] == "host" and layered_ok
            and load("device", act_b) + sb.param > dev_budget):
        tiers["param"] = "nvme"
        decisions.append(Decision(
            "param_tier", "nvme",
            f"host-homed params still assemble fully on device "
            f"({_fmt_bytes(sb.param)} transit > usable HBM "
            f"{_fmt_bytes(dev_budget)}); escalated to the NVMe row stream — "
            f"the only placement with O(window) device residency"))

    def transit_reserve() -> float:
        """HBM bytes the step transits beyond the homed loads: host-homed
        (or GSPMD-assembled NVMe) params assemble fully; the layered epoch
        needs only its window (floored at two rows here — the feasibility
        pass uses the actual window); an in-graph host optimizer streams
        its full state."""
        t = 0.0
        if tiers["param"] != "device":
            t += (2 * row_bytes if tiers["param"] == "nvme" and layered_ok
                  else sb.param)
        if tiers["opt"] == "host" and tiers["grad"] == "device":
            t += sb.opt
        return t

    # ---- grad accumulation: shrink the microbatch until act fits ------
    # only divisors of the global batch are lowerable: the engine reshapes
    # the batch to (accum, batch // accum, ...) — a non-divisor would crash
    # the first planned step
    grad_accum = 1
    act_budget = (dev_budget - load("device", 0) - transit_reserve()
                  if act_tier == "device" else host_budget - load("host", 0))
    if shape.kind == "train":
        divisors = [d for d in range(1, shape.global_batch + 1)
                    if shape.global_batch % d == 0]
        grad_accum = next(
            (d for d in divisors if sb.act_bytes("full", d) <= act_budget),
            divisors[-1])
    if grad_accum > 1:
        decisions.append(Decision(
            "grad_accum", str(grad_accum),
            f"Eq. 3 scales with the microbatch: bsz/{grad_accum} brings "
            f"checkpoints to "
            f"{_fmt_bytes(sb.act_bytes('full', grad_accum))} <= the {act_tier}"
            f" tier's remaining {_fmt_bytes(max(act_budget, 0))}"))
    act_b = sb.act_bytes("full", grad_accum)

    # ---- remat: drop recompute if FULL activations fit (Eq. 5) --------
    remat = "full"
    if shape.kind != "train":
        remat = "none"
    else:
        full_b = sb.act_bytes("none", grad_accum)
        budget = (dev_budget - load("device", 0) - transit_reserve()
                  if act_tier == "device" else host_budget - load("host", 0))
        if full_b <= budget:
            remat = "none"
            decisions.append(Decision(
                "remat", "none",
                f"un-checkpointed activations (Eq. 5 over {sb.n_layers} "
                f"layers = {_fmt_bytes(full_b)}) fit the {act_tier} tier; "
                f"skipping recompute saves the 4/3x FLOP multiplier (Eq. 8)"))
        else:
            decisions.append(Decision(
                "remat", "full",
                f"full activations (Eq. 5: {_fmt_bytes(full_b)}) exceed the "
                f"{act_tier} tier's {_fmt_bytes(max(budget, 0))}; "
                f"checkpointing (Eq. 3: {_fmt_bytes(act_b)}) required"))

    # ---- engine -------------------------------------------------------
    engine = "pjit"
    if (tiers["param"] == "nvme" and model.family in ("dense", "moe")
            and shape.kind == "train"):
        engine = "zero3"
        decisions.append(Decision(
            "engine", "zero3",
            "NVMe-resident params need the explicit engine's layered epoch "
            "(O(window) device residency; the GSPMD step assembles every "
            "leaf on device — a structural limit)"
            + ("; MoE expert rows page as independent schedule units — only "
               "the router-selected top-k stream in per wave"
               if model.family == "moe" else "")))
    else:
        decisions.append(Decision(
            "engine", "pjit",
            "GSPMD-native engine (composes TP/CP/EP; all in-graph tiers)"
            if tiers["param"] != "nvme" else
            "GSPMD fallback: the layered epoch is dense/moe-family "
            "train-only"))

    # ---- scheduler window / read-ahead / workers / pinned pool --------
    batch_tokens = (shape.global_batch * shape.seq_len) // max(grad_accum, 1)
    prefetch_layers = 0
    read_ahead = 2
    if tiers["param"] == "nvme":
        bw = hw.tier_bandwidth("nvme")
        prefetch_layers = schedule.default_prefetch_layers(
            sb.n_layers, sb.layer_params, batch_tokens,
            slow_bw=max(bw, 1.0), peak_flops=hw.peak_flops)
        note = (f"Sec. 3-4 model: hide one row fetch "
                f"({_fmt_bytes(row_bytes)} @ {bw / 1e9:.1f} GB/s) behind "
                f"layer compute (Eq. 8 share at {batch_tokens} tokens, "
                f"{hw.peak_flops / 1e12:.0f} TFLOPs peak)")
        if engine == "zero3":
            # capacity clamp: window rows are the layered epoch's device
            # transit — never budget more rows than the HBM remainder holds
            cap_rows = int((dev_budget - load("device", act_b))
                           // max(row_bytes, 1))
            if 1 <= cap_rows < prefetch_layers:
                prefetch_layers = cap_rows
                note += (f"; capacity-clamped to {cap_rows} rows "
                         f"({_fmt_bytes(cap_rows * row_bytes)} of the HBM "
                         f"remainder)")
        read_ahead = max(1, min(4, -(-prefetch_layers // 2)))
        decisions.append(Decision(
            "prefetch_layers", str(prefetch_layers), note))
        decisions.append(Decision(
            "read_ahead", str(read_ahead),
            "ceil(window/2) reads in flight beyond the window, clamped to "
            "[1, 4] (pinned-pool backpressured)"))
    any_slow = any(t != "device" for t in tiers.values())
    nvme_workers = 2
    if any(t == "nvme" for t in tiers.values()):
        nvme_workers = int(min(8, max(2, math.ceil(
            hw.tier_bandwidth("nvme") / 0.8e9))))
        decisions.append(Decision(
            "nvme_workers", str(nvme_workers),
            f"bandwidth-centric link parallelism (Sec. 6.1): "
            f"~0.8 GB/s per reader thread to saturate "
            f"{hw.tier_bandwidth('nvme') / 1e9:.1f} GB/s"))
    pinned_buffer_mb = 64
    if any_slow:
        window = prefetch_layers or max(2, read_ahead)
        staged = 4 * (window + read_ahead) * max(row_bytes, 1)
        pinned_buffer_mb = int(min(max(64, -(-staged // (1 << 20))),
                                   max(64, hw.host_mem // (4 << 20))))
        decisions.append(Decision(
            "pinned_buffer_mb", str(pinned_buffer_mb),
            f"fixed pinned supply (Sec. 6.2): ~4x (window {window} + "
            f"read-ahead {read_ahead}) rows of {_fmt_bytes(row_bytes)}, "
            f"clamped to 1/4 of host DRAM"))

    # ---- serving: KV tier / decode slots / block size (Sec. 3 arithmetic
    # on the family's actual cache_defs leaves, mirroring state_bytes) ----
    kv_tier, kv_slots, kv_block_tokens, kv_prefetch = "device", 0, 0, 2
    if shape.kind in ("prefill", "decode"):
        from repro_torch.core import kvcache

        per_seq = kvcache.sequence_kv_bytes(model, shape.seq_len)
        kv_headroom = max(0.0, dev_budget - load("device", act_b))
        fit = int(kv_headroom // max(per_seq, 1))
        bsz = shape.global_batch
        kv_block_tokens = kvcache.default_block_tokens(shape.seq_len)
        if fit >= bsz:
            kv_slots = bsz
            decisions.append(Decision(
                "kv_tier", "device",
                f"KV cache ({bsz} seqs x {_fmt_bytes(per_seq)} at "
                f"{shape.seq_len} ctx = {_fmt_bytes(bsz * per_seq)}) fits "
                f"the HBM remainder ({_fmt_bytes(kv_headroom)})"))
        else:
            kv_slots = max(1, fit)
            parked = (bsz - kv_slots) * per_seq
            host_room = host_budget - load("host", act_b)
            kv_tier = ("host" if parked <= host_room or nvme_budget <= 0
                       else "nvme")
            if parked > host_room and nvme_budget <= 0:
                warnings.append(
                    f"KV overflow {_fmt_bytes(parked)} exceeds the host "
                    f"remainder {_fmt_bytes(max(host_room, 0))} and no NVMe "
                    "is configured")
            decisions.append(Decision(
                "kv_tier", kv_tier,
                f"only {kv_slots}/{bsz} sequences fit the HBM remainder "
                f"({_fmt_bytes(kv_headroom)} at {_fmt_bytes(per_seq)} per "
                f"seq, {shape.seq_len} ctx); {_fmt_bytes(parked)} of "
                f"waiting KV parks on {kv_tier}"))
            decisions.append(Decision(
                "kv_slots", str(kv_slots),
                f"floor(HBM remainder / per-seq KV) = "
                f"floor({_fmt_bytes(kv_headroom)} / {_fmt_bytes(per_seq)})"))
        # read-ahead depth: decode-step compute (~4*N FLOPs/token across the
        # slots) must hide one block fetch from the KV tier's link
        block_bytes = per_seq * kv_block_tokens / max(shape.seq_len, 1)
        kv_bw = hw.tier_bandwidth("host" if kv_tier == "device" else kv_tier)
        kv_prefetch = schedule.default_kv_prefetch_blocks(
            block_bytes, 4.0 * kv_slots * sb.n_params,
            slow_bw=max(kv_bw, 1.0), peak_flops=hw.peak_flops)
        decisions.append(Decision(
            "kv_block_tokens", str(kv_block_tokens),
            f"~ctx/8 rounded to a power of two in [16, 1024]; read-ahead "
            f"{kv_prefetch} blocks hides one {_fmt_bytes(block_bytes)} "
            f"fetch behind decode compute"))

    fields: Dict[str, object] = {
        "param_tier": tiers["param"], "grad_tier": tiers["grad"],
        "opt_tier": tiers["opt"], "act_tier": act_tier, "engine": engine,
        "prefetch_layers": prefetch_layers, "read_ahead": read_ahead,
        "nvme_workers": nvme_workers, "pinned_buffer_mb": pinned_buffer_mb,
        "remat": remat, "grad_accum": grad_accum,
        "kv_tier": kv_tier, "kv_slots": kv_slots,
        "kv_block_tokens": kv_block_tokens, "param_quant": "none",
        "expert_hot_mb": 0,
    }
    if engine == "zero3" and model.family == "moe" and sb.n_experts:
        er_bytes = PARAM_BYTES_PP * sb.expert_row_params
        wave = max(1, sb.top_k)
        hot_b = schedule.resolve_expert_hot_bytes(0, sb.top_k, er_bytes)
        decisions.append(Decision(
            "expert_hot_mb", "0",
            f"hot-expert cache at the runtime default of two waves "
            f"(2 x top_k={sb.top_k} rows of {_fmt_bytes(er_bytes)} = "
            f"{_fmt_bytes(hot_b)}); expert residency = "
            f"{wave} wave rows x window + cache, never all "
            f"{sb.n_experts} experts x {sb.n_layers} layers "
            f"({_fmt_bytes(sb.n_layers * sb.n_experts * er_bytes)}) — "
            f"raise --expert-hot-mb to pin more popular experts"))
    if tiers["param"] == "nvme":
        decisions.append(Decision(
            "param_quant", "none",
            "lossless bf16 rows on the wire by default; q8/q4 "
            "(core/qformat.py) cut slow-tier traffic "
            f"{qformat.compression_ratio('q8'):.2f}x/"
            f"{qformat.compression_ratio('q4'):.2f}x at bounded per-block "
            "error — opt in via --param-quant"))
    for c in OFFLOAD_ORDER:
        if tiers[c] == "device":
            decisions.append(Decision(
                f"{c}_tier", "device",
                f"{eq_note[c]} fits HBM ({_fmt_bytes(dev_budget)} usable)"))
    if act_tier == "device" and shape.kind == "train":
        decisions.append(Decision(
            "act_tier", "device",
            f"activations ({_fmt_bytes(act_b)}, remat={remat}) fit HBM"))

    # ---- apply overrides (loud diff on contradiction) -----------------
    for k, v in overrides.items():
        derived = fields[k]
        if v == derived:
            continue
        fields[k] = v
        why = next((d.why for d in decisions if d.field == k), "")
        warnings.append(
            f"override {k}={v!r} replaces derived {derived!r}"
            + (f" (derivation: {why})" if why else ""))
    if fields["param_tier"] == "nvme":
        if not int(fields["prefetch_layers"]):
            # a plan never lowers window=0: the runtime's auto-resolution
            # uses the paper-nominal rates, not this plan's HardwareSpec,
            # and the two derivations would diverge — resolve it here
            w = prefetch_layers or schedule.default_prefetch_layers(
                sb.n_layers, sb.layer_params, batch_tokens,
                slow_bw=max(hw.tier_bandwidth("nvme"), 1.0),
                peak_flops=hw.peak_flops)
            fields["prefetch_layers"] = w
            warnings.append(
                f"prefetch_layers=0 (auto) resolved to {w} at plan time so "
                "the lowered config and the prediction use the same window")
        if tiers["param"] != "nvme":
            # params reached NVMe only via override: bring the dependent
            # knobs through the same derivations the direct path uses,
            # unless the caller pinned them too
            w = int(fields["prefetch_layers"])
            if "read_ahead" not in overrides:
                fields["read_ahead"] = max(1, min(4, -(-w // 2)))
            if "nvme_workers" not in overrides:
                fields["nvme_workers"] = int(min(8, max(2, math.ceil(
                    hw.tier_bandwidth("nvme") / 0.8e9))))
            if "pinned_buffer_mb" not in overrides:
                staged = 4 * (w + int(fields["read_ahead"])) * max(row_bytes, 1)
                fields["pinned_buffer_mb"] = int(min(
                    max(64, -(-staged // (1 << 20))),
                    max(64, hw.host_mem // (4 << 20))))
            warnings.append(
                "override param_tier='nvme': re-derived read_ahead/"
                "nvme_workers/pinned_buffer_mb for the NVMe stream")
    pq = str(fields["param_quant"])
    if pq != "none":
        if pq not in qformat.FORMATS:
            raise ValueError(
                f"param_quant={pq!r}: must be one of "
                f"{('none',) + tuple(qformat.FORMATS)}")
        ratio = qformat.compression_ratio(pq)
        if fields["param_tier"] != "nvme":
            warnings.append(
                f"param_quant={pq!r} has no effect with param_tier="
                f"{fields['param_tier']!r}: only slow-tier param rows cross "
                "a store wire (device/host-tier params move in-graph)")
        else:
            if "prefetch_layers" not in overrides:
                w = schedule.default_prefetch_layers(
                    sb.n_layers, sb.layer_params, batch_tokens,
                    slow_bw=max(hw.tier_bandwidth("nvme"), 1.0),
                    peak_flops=hw.peak_flops, compression_ratio=ratio)
                if fields["engine"] == "zero3":
                    # same capacity clamp as the derived window: resident
                    # rows decode to full bf16 on device regardless of the
                    # wire format
                    cap_rows = int((dev_budget - load("device", act_b))
                                   // max(row_bytes, 1))
                    if 1 <= cap_rows < w:
                        w = cap_rows
                fields["prefetch_layers"] = w
            bits = qformat.WIRE_BYTES_PER_ELEM[pq] * 8.0
            decisions.append(Decision(
                "param_quant", pq,
                f"{pq} block-quantized wire ({bits:.1f} b/elem vs 16 bf16, "
                f"{ratio:.2f}x): one row fetch shrinks to "
                f"{_fmt_bytes(row_bytes / ratio)}, the pinned stage holds "
                f"{ratio:.2f}x more rows, window deepens to "
                f"{fields['prefetch_layers']} — bounded per-block "
                f"quantization error (Sec. 4 arithmetic on wire bytes)"))
    _check_override_feasibility(fields, sb, hw, model, shape, warnings)

    # ---- feasibility --------------------------------------------------
    tiers2 = {"param": fields["param_tier"], "grad": fields["grad_tier"],
              "opt": fields["opt_tier"]}
    act_b = sb.act_bytes(str(fields["remat"]), int(fields["grad_accum"]))
    loads = {t: sum(b for c, b in class_bytes.items() if tiers2[c] == t)
             for t in _TIERS}
    loads[str(fields["act_tier"])] += act_b
    predicted = _predict(fields, sb, hw, model, shape,
                         int(fields["grad_accum"]))
    feasible = True
    for t in _TIERS:
        cap = hw.tier_capacity(t)
        if loads[t] > cap:
            feasible = False
            warnings.append(
                f"INFEASIBLE: {t} tier needs {_fmt_bytes(loads[t])} but has "
                f"{_fmt_bytes(cap)} "
                + ("(no NVMe configured)" if t == "nvme" and cap == 0 else ""))
    # device transit: slow-homed states still pass through HBM inside the
    # step — the layered epoch's window rows, or the FULL assembly on every
    # other path (the GSPMD/host-streaming structural limit)
    layered_final = (fields["param_tier"] == "nvme"
                     and fields["engine"] == "zero3")
    transit = 0.0
    if fields["param_tier"] != "device":
        transit += (predicted["peak_resident_param_bytes"] if layered_final
                    else sb.param)
    offgraph = (fields["opt_tier"] == "nvme"
                or fields["grad_tier"] != "device" or layered_final)
    if fields["opt_tier"] == "host" and not offgraph:
        transit += sb.opt
    if transit and loads["device"] + transit > hw.tier_capacity("device"):
        feasible = False
        warnings.append(
            f"INFEASIBLE: the step transits {_fmt_bytes(transit)} through "
            f"HBM (host/NVMe-homed states assemble on device — the "
            f"GSPMD/host-streaming structural limit) on top of "
            f"{_fmt_bytes(loads['device'])} resident bytes, exceeding usable "
            f"{_fmt_bytes(hw.tier_capacity('device'))}")
    return InfinityPlan(
        model=model, shape=shape, hardware=hw, objective=objective,
        feasible=feasible, kv_prefetch_blocks=kv_prefetch,
        predicted=tuple(sorted(predicted.items())),
        rationale=tuple(decisions), warnings=tuple(warnings),
        **{k: fields[k] for k in OVERRIDABLE})


def _check_override_feasibility(fields, sb: StateBytes, hw: HardwareSpec,
                                model: ModelConfig, shape: ShapeConfig,
                                warnings: list) -> None:
    """Override-specific contradictions beyond raw capacity (which the
    common feasibility pass reports)."""
    if fields["engine"] == "zero3":
        if model.family not in ("dense", "moe"):
            raise ValueError(
                f"engine='zero3' cannot run family={model.family!r} "
                "(dense/moe only); drop the override or use engine='pjit'")
        if model.family == "moe" and fields["param_tier"] != "nvme":
            raise ValueError(
                "engine='zero3' on a MoE family requires param_tier='nvme': "
                "expert rows exist only as paged schedule units (there is no "
                "all-resident explicit MoE path) — drop the override or add "
                "param_tier='nvme'")
        if shape.kind != "train":
            raise ValueError("engine='zero3' supports train shapes only")
        if int(fields["grad_accum"]) > 1:
            warnings.append(
                f"grad_accum={fields['grad_accum']} is lowered but the zero3 "
                "layered epoch runs the full batch per step (accumulation is "
                "a pjit-engine knob) — the activation-fit arithmetic is "
                "optimistic on this engine")
    if fields.get("kv_tier") not in _TIERS:
        raise ValueError(
            f"kv_tier={fields.get('kv_tier')!r}: must be one of {_TIERS}")
    pq = str(fields.get("param_quant", "none"))
    if pq not in ("none",) + tuple(qformat.FORMATS):
        raise ValueError(
            f"param_quant={pq!r}: must be one of "
            f"{('none',) + tuple(qformat.FORMATS)}")
    if int(fields.get("kv_slots", 0) or 0) > shape.global_batch:
        warnings.append(
            f"kv_slots={fields['kv_slots']} exceeds the shape's "
            f"{shape.global_batch} sequences — the extra slots idle")
    if fields["param_tier"] == "nvme":
        if hw.nvme_capacity <= 0:
            warnings.append(
                "override param_tier='nvme' but hardware has no NVMe "
                "capacity — the store will land on whatever backs nvme_dir")
        if fields["engine"] == "pjit":
            warnings.append(
                "param_tier='nvme' on the pjit engine bounds host *staging* "
                "only; the jitted step still assembles every leaf on device "
                "(use engine='zero3' for the O(window) residency bound)")
        w = int(fields["prefetch_layers"])
        if w >= sb.n_layers and sb.n_layers > 1:
            warnings.append(
                f"prefetch_layers={w} >= n_layers={sb.n_layers}: the window "
                "admits full residency — the never-fully-resident bound "
                "degenerates (schedule clamps the plan, not the claim)")


# ---------------------------------------------------------------------------
# CLI plumbing shared by launch/train, launch/dryrun, launch/serve and
# benchmarks/run: `--plan auto` everywhere, with the legacy knobs demoted to
# per-field overrides on the derived plan.
# ---------------------------------------------------------------------------

# legacy flag -> (plan field, argparse dest); a flag the user explicitly
# passed becomes an override on the derived plan
CLI_FLAG_FIELDS = {
    "--engine": "engine",
    "--offload-opt": "opt_tier",
    "--offload": "opt_tier",  # dryrun / benchmarks spelling
    "--offload-param": "param_tier",
    "--offload-grad": "grad_tier",
    "--prefetch-layers": "prefetch_layers",
    "--param-quant": "param_quant",
    "--expert-hot-mb": "expert_hot_mb",
    "--read-ahead": "read_ahead",
    "--nvme-workers": "nvme_workers",
    "--pinned-buffer-mb": "pinned_buffer_mb",
    "--grad-accum": "grad_accum",
    "--remat": "remat",
    # serving knobs (launch/serve)
    "--kv-tier": "kv_tier",
    "--kv-slots": "kv_slots",
    "--kv-block-tokens": "kv_block_tokens",
}

_HW_FLAGS = {
    "hw_device_mem": "device_mem",
    "hw_host_mem": "host_mem",
    "hw_nvme": "nvme_capacity",
    "hw_nvme_bw": "nvme_bw",
    "hw_host_bw": "host_bw",
    "hw_peak_flops": "peak_flops",
    "hw_devices": "n_devices",
}


def add_plan_args(ap) -> None:
    """Install the planner surface on a launcher's argparser."""
    g = ap.add_argument_group("planner (repro_torch.plan)")
    g.add_argument("--plan", default="manual",
                   help="'manual' = legacy flags as-is; 'auto' = derive the "
                        "placement from the (detected) hardware, with "
                        "explicitly-passed legacy flags applied as per-field "
                        "overrides; or a path to a saved plan JSON")
    g.add_argument("--objective", default="throughput",
                   choices=["throughput", "min_device_mem"],
                   help="planning objective for --plan auto")
    g.add_argument("--hw-device-mem", type=float, default=None,
                   help="override detected per-device HBM bytes")
    g.add_argument("--hw-host-mem", type=float, default=None,
                   help="override detected host DRAM bytes")
    g.add_argument("--hw-nvme", type=float, default=None,
                   help="override detected NVMe capacity bytes")
    g.add_argument("--hw-nvme-bw", type=float, default=None,
                   help="per-device NVMe bytes/s (default: paper Fig. 2b)")
    g.add_argument("--hw-host-bw", type=float, default=None,
                   help="per-device host-DRAM bytes/s (default: paper)")
    g.add_argument("--hw-peak-flops", type=float, default=None,
                   help="per-device peak FLOPs/s (default: paper)")
    g.add_argument("--hw-devices", type=int, default=None,
                   help="override detected device count")


def overrides_from_argv(args, argv=None) -> Dict[str, object]:
    """The legacy knobs the user *explicitly* passed, as plan overrides.

    Detection is by presence in ``argv`` (argparse cannot distinguish a
    defaulted value from an explicitly-passed default), so only flags on the
    command line demote to overrides — `--plan auto` alone means the plan
    decides everything. Matching is exact-token: argparse's
    prefix-abbreviated spellings (``--prefetch-l 4``) are NOT recognized as
    overrides — spell planner-override flags out in full.
    """
    import sys

    argv = list(sys.argv[1:]) if argv is None else list(argv)
    present = {a.split("=", 1)[0] for a in argv if a.startswith("--")}
    out: Dict[str, object] = {}
    for flag, field in CLI_FLAG_FIELDS.items():
        if flag not in present:
            continue
        dest = flag.lstrip("-").replace("-", "_")
        if hasattr(args, dest):
            out[field] = getattr(args, dest)
    return out


def hardware_from_args(args, *, nvme_dir: str = DEFAULT_NVME_DIR
                       ) -> HardwareSpec:
    """Detect the live machine on ``args.device`` (default cuda), then
    apply any ``--hw-*`` overrides."""
    over = {}
    for dest, field in _HW_FLAGS.items():
        v = getattr(args, dest, None)
        if v is not None:
            over[field] = int(v) if field == "n_devices" else float(v)
    return HardwareSpec.detect(nvme_dir=nvme_dir,
                               device=getattr(args, "device", "cuda"), **over)


def resolve_plan(args, model: Union[str, ModelConfig],
                 shape: Union[str, ShapeConfig], *,
                 nvme_dir: str = DEFAULT_NVME_DIR, argv=None,
                 quiet: bool = False,
                 hardware: Optional[HardwareSpec] = None
                 ) -> Optional[InfinityPlan]:
    """``--plan`` resolution for every launcher: ``None`` for manual mode,
    otherwise the derived (or loaded) plan with override warnings printed
    loudly — the feasibility diff the ISSUE asks for. Pass ``hardware`` to
    reuse one detection across many plans (dryrun's per-cell loop)."""
    mode = getattr(args, "plan", "manual")
    if mode == "manual":
        return None
    if mode == "auto":
        hw = (hardware if hardware is not None
              else hardware_from_args(args, nvme_dir=nvme_dir))
        plan = plan_run(model, shape, hw,
                        objective=getattr(args, "objective", "throughput"),
                        overrides=overrides_from_argv(args, argv))
    else:
        plan = InfinityPlan.load(mode)
        want = _resolve_model(model)
        if plan.model.arch != want.arch:
            raise ValueError(
                f"--plan {mode}: the saved plan is for arch "
                f"{plan.model.arch!r}, not {want.arch!r} — regenerate with "
                f"--plan auto or pass the matching --arch")
        ignored = overrides_from_argv(args, argv)
        if ignored and not quiet:
            print(f"PLAN WARNING: --plan {mode}: explicitly-passed legacy "
                  f"flags {sorted(ignored)} are NOT applied to a saved plan "
                  "— use --plan auto to treat them as overrides")
    if not quiet:
        print(plan.explain())  # includes one "!! ..." line per warning
        if not plan.feasible:
            print("PLAN WARNING: plan is INFEASIBLE for this hardware "
                  "(see the arithmetic above)")
    return plan


def _predict(fields, sb: StateBytes, hw: HardwareSpec, model: ModelConfig,
             shape: ShapeConfig, grad_accum: int) -> Dict[str, float]:
    """Quantities the executor cross-checks against measured counters."""
    tiers = {"param": fields["param_tier"], "grad": fields["grad_tier"],
             "opt": fields["opt_tier"]}
    out: Dict[str, float] = {}

    # peak resident bytes of scheduler-managed params
    if tiers["param"] == "nvme":
        if fields["engine"] == "zero3":
            window = int(fields["prefetch_layers"]) or \
                schedule.default_prefetch_layers(
                    sb.n_layers, sb.layer_params,
                    (shape.global_batch * shape.seq_len) // max(grad_accum, 1),
                    slow_bw=max(hw.tier_bandwidth("nvme"), 1.0),
                    peak_flops=hw.peak_flops)
            w_eff = min(window, sb.n_layers)
            out["peak_resident_param_bytes"] = float(
                w_eff * PARAM_BYTES_PP * sb.layer_params)
            if model.family == "moe" and sb.n_experts:
                # expert residency bound: one wave (top_k rows) per window
                # slot — prefetched-ahead expert reads only count once
                # materialized — plus the hot-cache budget. The measured
                # counter must stay at or below this (plan_residency_ok).
                er_bytes = PARAM_BYTES_PP * sb.expert_row_params
                wave = max(1, sb.top_k)
                hot_b = schedule.resolve_expert_hot_bytes(
                    int(fields.get("expert_hot_mb", 0) or 0), sb.top_k,
                    er_bytes)
                expert_peak = float(wave * w_eff * er_bytes + hot_b)
                out["expert_peak_resident_bytes"] = expert_peak
                out["expert_total_bytes"] = float(
                    sb.n_layers * sb.n_experts * er_bytes)
                # coarse hit-rate estimate: backward prefetches the exact
                # selected set ahead of use; forward's first wave per layer
                # races the reads it just issued (popularity prediction and
                # the hot cache cover part of it) — assume all E experts get
                # tokens at training batch sizes
                out["expert_hit_rate"] = max(
                    0.0, 1.0 - wave / (2.0 * max(sb.n_experts, 1)))
                out["peak_resident_param_bytes"] += expert_peak
        else:
            window = int(fields["prefetch_layers"]) or max(
                2, int(fields["read_ahead"]))
            out["peak_resident_param_bytes"] = float(
                sum(sb.leaf_bytes[:window]))
    else:
        out["peak_resident_param_bytes"] = float(sb.param)

    # per-step slow-tier traffic (bytes) per class. The explicit engine
    # streams only the flat block rows through its stores — the small
    # replicated states (embed/head/norms and their optimizer moments)
    # stay in-graph — while the GSPMD paths stream every parameter leaf.
    # MoE: the streamed denominator includes every expert row (the write-back
    # and the opt stream touch all of them each step; reads touch only the
    # selected set, so the read prediction is an all-selected upper bound).
    streamed = (sb.n_layers * sb.layer_params
                + sb.n_layers * sb.n_experts * sb.expert_row_params
                if fields["engine"] == "zero3" else sb.n_params)
    if tiers["param"] != "device":
        p_bytes = float(PARAM_BYTES_PP * streamed)
        out["param_step_read_bytes"] = 2.0 * p_bytes  # fwd + bwd loads
        out["param_step_write_bytes"] = p_bytes
        # wire traffic: what actually crosses the slow link — logical /
        # compression ratio under a quantized wire format (1.0 for "none",
        # and the store wire only exists on the nvme param tier)
        ratio = (qformat.compression_ratio(
            str(fields.get("param_quant", "none")))
            if tiers["param"] == "nvme" else 1.0)
        out["param_step_read_wire_bytes"] = 2.0 * p_bytes / ratio
        out["param_step_write_wire_bytes"] = p_bytes / ratio
        out["param_compression_ratio"] = ratio
    if tiers["grad"] != "device":
        out["grad_step_write_bytes"] = float(GRAD_BYTES_PP * streamed)
    if tiers["opt"] != "device":
        o_bytes = float(OPT_BYTES_PP * streamed)
        out["opt_step_read_bytes"] = o_bytes
        out["opt_step_write_bytes"] = o_bytes

    # Eq. 6 efficiency per offloaded class, AIT from Eqs. 9/10/11
    bsz_dev = max(1.0, shape.global_batch / hw.n_devices / max(grad_accum, 1))
    ait = {
        "param": model_math.ait_params_grads(bsz_dev, shape.seq_len),
        "grad": model_math.ait_params_grads(bsz_dev, shape.seq_len),
        "opt": model_math.ait_optimizer_states(bsz_dev, shape.seq_len),
    }
    eff_all = 1.0
    for c, t in tiers.items():
        if t == "device":
            continue
        e = model_math.efficiency(ait[c], hw.tier_bandwidth(t),
                                  hw.peak_flops)
        out[f"{c}_efficiency"] = e
        eff_all = min(eff_all, e)
    if fields["act_tier"] != "device" and shape.kind == "train":
        e = model_math.efficiency(
            model_math.ait_activation_checkpoints(model.d_model, ci=1),
            hw.tier_bandwidth("host"), hw.peak_flops)
        out["act_efficiency"] = e
        eff_all = min(eff_all, e)
    out["efficiency"] = eff_all
    # serving: device-resident KV bytes of the slot cache, and the waiting
    # KV parked on the slow tier — the serve smoke gate's cross-check
    if int(fields.get("kv_slots", 0) or 0) > 0:
        from repro_torch.core import kvcache

        per_seq = float(kvcache.sequence_kv_bytes(model, shape.seq_len))
        slots = int(fields["kv_slots"])
        out["kv_per_seq_bytes"] = per_seq
        out["kv_resident_bytes"] = slots * per_seq
        out["kv_parked_bytes"] = max(0, shape.global_batch - slots) * per_seq
    # the scheduler-managed denominator: block rows on zero3 (matching the
    # executor's total_param_bytes), every leaf on the GSPMD paths
    out["param_total_bytes"] = float(PARAM_BYTES_PP * streamed)
    out["n_params"] = float(sb.n_params)
    return out
