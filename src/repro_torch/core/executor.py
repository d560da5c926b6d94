"""InfinityExecutor: both ZeRO engines through the three tiers on one
device and on each rank of a data-parallel mesh — the subset of
``repro/core/executor.py`` the port runs.

``make_engine`` picks the engine from ``RunConfig.parallel.engine``, and
the executor drives the configured placement of each state class:

  * the GSPMD engine (``--engine pjit``, ``core/engine.py``) with params on
    the device, host or NVMe tier (below), and the explicit engine's
    monolithic step
    (``--engine zero3`` with params on the device or host tier,
    ``core/zero.py``). With the optimizer in-graph (device or host tier,
    gradients on the device) the engine's step is the executor's step.
    With the optimizer off-graph (``run.opt_offgraph``: optimizer states
    on NVMe, or gradients drained to host or NVMe — the ZeRO-Offload
    placement) the engine computes the gradients alone; they drain to the
    grad store when it is a slow tier, and f32 master/m/v stream through
    the opt store with ``ChunkedAdamOffload``'s read(k+1) || update(k) ||
    write(k-1) pipeline, keyed by the reference's names: the GSPMD
    engine's leaves by ``keystr`` (``['blocks']['attn']['wq']``), the
    explicit engine's flat as the rank's ``rank<r>/flat``; the lr is a
    host float from the same ``lr_at`` arithmetic;
  * the explicit engine's layered ZeRO-3 epoch (``--engine zero3
    --offload-param nvme``, below).

The GSPMD leaf scheduler (``--engine pjit --offload-param nvme``): the
param store holds every leaf, under its ``keystr`` name (on a mesh the
rank's shard of it, ``rank<r>/<keystr>``, in the rank's own store), and
the state carries the engine's ``param_specs`` placeholders (the rank's
shard specs) in its place.
Each step (``_instrumented``) loads the leaves through the same
``LayerSchedule`` / ``PrefetchEngine`` the layered epoch uses, one leaf a
unit (window ``prefetch_layers or max(2, read_ahead)``): a leaf goes to
the device through a pinned pool buffer as it lands and its host copy is
evicted at once. The engine's step then runs as on the device tier: the
in-graph update (fused Adam on the device) or the off-graph one. Its new
params go back to the store: from the device behind an event recorded
after the update's kernels, or, off-graph, from the host Adam's f32
masters rounded to the leaves' dtype on the host (never a round trip
through the card; on a mesh too where the param and opt rules cut a leaf
alike, ZeRO stages 0 and 3; at stages 1-2 the rank's masters are rounded
on the device and all-gathered, and each rank writes the whole leaf back
to its store); then the state drops them to placeholders again. Under
``param_quant`` the store encodes on write and decodes on read, as the
reference's; on a mesh each rank's shard is its own frame, quantized in
blocks of 32 from its first element: it decodes to the slice of the
reference's decode of the whole leaf exactly where its runs in the leaf's
flat order start and end on the block grid (``qformat.grid_aligned``),
and its wire bytes are its own blocks, pad block and header included
(``qformat.wire_nbytes``). Each leaf crosses the tier once a step each
way.

Checkpoint views (``checkpoint_state``, ``portable_state``,
``adopt_state``, ``restore_state``) are the reference's: the full state
with the layered epoch's rows materialized from the param store; the
tier-independent leaves (``flat``/``other``/``other_opt``/``step``, or
``params``); and a full state for this executor's tiers around such
leaves, where the streamed moments, the in-graph moments and the int8
residual restart at zero and the stores are reseeded. On a mesh they are
global: ``checkpoint_state`` gathers each leaf over the ranks, one at a
time, and hands it to rank 0 (``engine.gather_state``: the GSPMD
engine's leaves by ``respec(leaf, cls, None)``, the explicit engine's
rows along their split dim, its int8 residual as the reference's (dp, ...)
stack), so rank 0's snapshot is what one rank's checkpoint of the same
state holds; a restore takes global leaves written on any mesh and cuts
the rank's part (``engine.shard_state``; the explicit engine's rows
re-padded for this dp first, ``runtime/elastic.adapt_state_layout``, and
its residual zero at another dp).

The layered epoch: parameters, gradients and optimizer states all live
off the device: each layer's bf16 row in the param store
(``ParamStreamer``), its f32 gradient drained to the grad store, its f32
master/m/v in the opt store (``ChunkedAdamOffload``). One step is two
scheduler-driven passes over the rows (``core/schedule.py``): forward,
each row read ahead inside the prefetch window, copied to the device just
in time and evicted after use; then the head, and the reversed pass that
re-reads each row, recomputes the layer under autograd (``layer_vjp``) and
hands the row's gradient to the grad store. ``finish`` updates the small
device-resident states with the fused-Adam kernel; the rows update on the
host, chunk by chunk, and go straight back to the param store. The full
(L, P) array is never assembled, so ``peak_resident_param_bytes`` is
O(window).

The MoE layered epoch (``_layered_moe_step``): a layer expands into
heterogeneous schedule units. Its dense row (ln1 + attn + ln2) follows the
static layer plan; its expert rows (the rank's slices, ``xrank<r>/c{l * E
+ e}`` in the param store, ``xrank<r>/l{l * E + e}`` in the opt store, as
the reference keys them) page as dynamic units
``("x", layer, expert)`` through a second ``PrefetchEngine`` (class
``expert``) sharing the working-set accounting. The router's counts (one
small host sync per layer) pick the selected set, which streams through
fixed-width waves of ``top_k`` rows; evict-bound rows are offered to the
byte-budgeted hot cache (``HotUnitCache``, refreshed from the new masters
after each write-back), and the predicted-hot rows (``ExpertPopularity``)
prefetch alongside the static plan's horizon. Unrouted experts still take
their Adam step, from known-zero gradients. Peak expert residency is
O(wave + hot budget), never O(L * E); the step reports
``expert_peak_resident_bytes`` / ``_prefetch_hit_rate`` / ``_evictions``,
``expert_total_bytes`` and the routing's ``moe_dropped_token_fraction`` and
(E,) ``moe_expert_load``. Under ``param_quant`` the expert rows arrive
decoded by the store, as the reference's: only dense rows travel as wire
operands. At dp > 1 the routing counts are the global batch's (summed over
the ranks in ``moe_attn``), so every rank pages the same units in the same
order and reports the reference's statistics; the hot cache counts its
budget and each row in the global row's bytes, so every rank keeps and
drops the same units; the expert byte counters are the rank's slices'
(``*_all_ranks``: their sums).

On the card two copies cross the host link asynchronously. A row goes up
through a pinned pool buffer (``PinnedStager``: the buffer is not reused
before its copy's event completes), and a gradient comes down on a store
worker after an event recorded behind the kernels that wrote it.

Quantized tier transport (``offload.param_quant``): the param store is a
``qformat.QuantizedArrayStore``, so rows are encoded on the host as they
are written and cross the tier in wire bytes. Under ``q8`` a row is read
undecoded, its wire body goes to the device as it is, and the layer pieces
run the MLP projections on its int8 quants and fp16 scales through the
quantized-matmul kernel (``core/zero.py``). Under ``q4`` a row is decoded
on the host back to bf16, as the reference does for both formats. The
auto prefetch window deepens by the compression ratio.

Data parallel (``mesh``, a ``launch/mesh.LocalMesh`` of dp > 1 ranks, one
process each): the explicit engine's monolithic step and layered epoch on
the rank's shard of the rows, keyed by the rank as the reference keys each
rank's (``rank<r>/flat``, ``rank<r>/l<i>``, param rows ``rank<r>/c<i>``);
the GSPMD engine's step on the rank's shards of each leaf
(``core/engine.py``), in-graph or with its off-graph optimizer over the
rank's optimizer shards, keyed ``rank<r>/<keystr>``; MoE's expert rows
and q8/q4 rows included. The host Adam and the
gradient drain run on the rank's shard, and the rank's stores live in
``<nvme_dir>/rank<r>/``, so no two processes share a file. The tier
counters count the rank's own bytes (the GSPMD engine's steps add the
rank's state shards, ``*_shard_bytes``); each step also reports their sum
over the ranks, ``<counter>_all_ranks``, what the reference's one process
counts, and an executor built from a plan the plan's per-device
predictions beside them (``plan_*_shard_bytes``, and the slow-tier bytes
a step scaled to the rank's share, ``_plan_share``). A plan for another
number of devices than the ranks (``--data-mesh`` x ``--model-mesh``)
raises. The GSPMD engine's params on NVMe and ``param_quant`` run on a
mesh, each rank its shards in its own store. On a mesh
with a model axis the step is the engine's tensor- or context-parallel
one, in-graph or with the off-graph optimizer over the rank's shards (on
the host or NVMe, keyed ``rank<r>/<keystr>`` as on data-parallel ranks).

A plan made for another number of devices raises (``check_ported``).
Per-step metrics of the off-graph and layered steps are the reference's:
loss, grad_norm, lr, the per-tier byte counters and GB/s (``param_in/out``,
``grad_out``, ``opt_read/write``; ``*_bytes`` logical, ``*_wire_bytes``
what crossed the tier), scheduler residency and ``param_total_bytes``
(wherever params live on NVMe), the tracer's stall
attribution (``trace_*``) when tracing is on, and, for an executor built
from an ``InfinityPlan`` (``plan=``), the plan's predictions beside them
(``plan_*``). The fully in-graph step returns loss, grad_norm and lr.
"""
from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, Optional

import torch

from repro_torch import plan as plan_mod
from repro_torch.config import RunConfig, ShapeConfig
from repro_torch.core import partition as pt
from repro_torch.core import qformat
from repro_torch.core import schedule as sched_mod
from repro_torch.core.engine import ZeroInfinityEngine
from repro_torch.core.offload import (ArrayStore, ChunkedAdamOffload,
                                      HostArrayStore, NvmeStore, ParamStreamer,
                                      PinnedBufferPool, PinnedStager)
from repro_torch.core.zero import ExplicitZero3Engine
from repro_torch.models.transformer import TensorSpec
from repro_torch.optim import adam as adam_mod
from repro_torch.runtime import elastic, trace


def check_ported(run: RunConfig, n_devices: Optional[int] = None, dp: int = 1) -> None:
    """Raise ``ValueError`` for a plan made for ``n_devices`` devices (None:
    no plan) run on another number of ranks, ``dp`` (every rank of the
    mesh, on either axis). Every engine, tier and family the port runs on
    one rank runs on a mesh."""
    if n_devices is not None and n_devices != dp:
        raise ValueError(
            f"a plan for {n_devices} device(s) runs on as many ranks, and this run "
            f"has {dp}: plan for {dp} (--hw-devices {dp}) or launch {n_devices} "
            "ranks (torchrun --standalone --nproc-per-node "
            f"{n_devices} ... --hw-devices {n_devices})")


def make_engine(run: RunConfig, device, mesh=None):
    """``RunConfig.parallel.engine`` -> engine instance ('pjit' | 'zero3')
    on ``mesh``'s rank."""
    if run.parallel.engine == "zero3":
        return ExplicitZero3Engine(run, device, mesh)
    return ZeroInfinityEngine(run, device, mesh)


def keystr(path) -> str:
    """A leaf's name as ``jax.tree_util.keystr`` spells a dict path:
    ``['blocks']['attn']['wq']``."""
    return "".join(f"[{k!r}]" for k in path)


def flatten_with_paths(tree: dict) -> Dict[str, torch.Tensor]:
    """Every leaf of a nested dict by its ``keystr`` name, in tree order."""
    return {keystr(p): pt.tree_get(tree, p) for p in pt.tree_paths(tree)}


class InfinityExecutor:
    """Drives an engine through the configured three-tier placement.

    ``make_train_step()(state, batch)`` returns ``(new_state, metrics)``
    for every ported (engine, tier) combination. On the layered epoch
    ``state`` is the explicit engine's with the ``flat`` rows dropped to a
    ``TensorSpec`` placeholder once the stores are seeded (``reseed``); on
    the GSPMD engine it is ``{"params"}``, plus ``{"opt"}`` while the
    optimizer is in-graph, the params a tree of ``TensorSpec`` while they
    live on NVMe.
    """

    def __init__(self, run: RunConfig, device="cuda", *, engine=None, plan=None, mesh=None):
        # an optional repro_torch.plan.InfinityPlan: its predictions are
        # reported beside the measured counters in the step metrics
        self.plan = plan
        self.mesh = mesh
        self.dp = mesh.world if mesh is not None else 1
        check_ported(run, plan.hardware.n_devices if plan is not None else None, self.dp)
        self.run = run
        self.device = torch.device(device)
        # this rank's key namespace in the stores, as the reference's
        self.rank_key = f"rank{mesh.rank if mesh is not None else 0}"
        self.engine = engine if engine is not None else make_engine(run, self.device, mesh)
        self.explicit = isinstance(self.engine, ExplicitZero3Engine)
        self._gspmd_mesh = self.dp > 1 and not self.explicit
        # explicit-engine MoE: expert rows are schedule units of their own
        self.is_moe = bool(getattr(self.engine, "is_moe", False))
        off = run.offload
        # params on NVMe: the layered epoch on the explicit engine (with
        # params on the device or host tier it takes the monolithic step),
        # the leaf scheduler around the step on the GSPMD engine
        self.param_nvme = off.param_tier == "nvme"
        self.layered = self.explicit and self.param_nvme
        if self.layered and run.parallel.partition_mode != "allgather":
            raise ValueError(
                "param_tier='nvme' on the explicit engine requires "
                "partition_mode='allgather' (the layer scheduler streams "
                "per-rank rows); broadcast is the non-scaling contrast "
                "baseline — keep params on the device/host tier for it")
        if self.layered and run.parallel.grad_compression != "none":
            raise ValueError(
                "grad_compression='int8' applies to the monolithic step's "
                "replicated-grad reduce; the layered epoch "
                "(param_tier='nvme' + zero3) reduce-scatters rows through "
                "the all-gather transpose and is not compressed")
        self.offgraph = run.opt_offgraph
        self.grad_offload = off.grad_tier != "device"
        # q8 rows go to the device as wire operands; q4 rows decode on the host
        self._wire_rows = off.param_quant == "q8"
        # one staging budget shared by every store and the row stager;
        # page-locked where it feeds the card
        self._pool = PinnedBufferPool(off.pinned_buffer_mb << 20,
                                      pin=self.device.type == "cuda")
        self._stager = None
        if self.param_nvme:
            self._stager = PinnedStager(self._pool, self.engine.layer_row_device()
                                        if self.layered else self.device)
        self.opt_store: Optional[ArrayStore] = None
        self.grad_store: Optional[ArrayStore] = None
        self.param_store: Optional[ArrayStore] = None
        self.offload: Optional[ChunkedAdamOffload] = None
        self.param_stream: Optional[ParamStreamer] = None
        self._ws = sched_mod.WorkingSetManager()
        self._sched: Optional[sched_mod.LayerSchedule] = None
        self._pe: Optional[sched_mod.PrefetchEngine] = None
        self._pe_stream: Optional[ParamStreamer] = None
        self._sched_tokens: Optional[int] = None
        self._layer_fns = None
        # the MoE layered epoch's dynamic units: their own prefetch engine
        # over ("x", layer, expert) rows, the hot cache and the predictor
        self._pe_x: Optional[sched_mod.PrefetchEngine] = None
        self._pe_x_stream: Optional[ParamStreamer] = None
        self._hot: Optional[sched_mod.HotUnitCache] = None
        self._pop: Optional[sched_mod.ExpertPopularity] = None
        self._step_fn = None
        self._trace_t0: Optional[float] = None
        self._trace_tid: Optional[int] = None
        self.trace_attributions: list = []

    def close(self) -> None:
        """Flush and shut down the stores; a closed executor must not step."""
        for store in (self.param_store, self.grad_store, self.opt_store):
            if store is not None:
                store.close()
        if self._stager is not None:
            self._stager.retire(wait=True)
        self.param_store = self.grad_store = self.opt_store = None
        self.param_stream = self.offload = None
        self._step_fn = None

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def init_state(self, generator: torch.Generator, *, seed_stores: bool = True) -> dict:
        """Engine init + store seeding; on the layered epoch the returned
        state's ``flat`` is a placeholder (the param store is
        authoritative). ``seed_stores=False`` skips the seeding where a
        checkpoint restore (which reseeds) follows."""
        state = self.engine.init_state(generator)
        return self.reseed(state) if seed_stores else state

    def _make_store(self, tier: str, name: str) -> ArrayStore:
        off = self.run.offload
        if tier == "nvme":
            # at dp > 1 each rank's stores in a directory of their own: no
            # file, sidecars included, is written by two processes
            root = (off.nvme_dir if self.dp == 1
                    else os.path.join(off.nvme_dir, self.rank_key))
            store = NvmeStore(os.path.join(root, name), pool=self._pool,
                              overlap=off.overlap, workers=off.nvme_workers)
        else:
            store = HostArrayStore(pool=self._pool, overlap=off.overlap,
                                   workers=off.nvme_workers)
        store.trace_cls = name  # tags this class's I/O spans
        if name == "param":
            store = qformat.maybe_wrap_store(store, off.param_quant)
        return store

    def reseed(self, state: dict, step: int = 0) -> dict:
        """(Re)populate the stores from ``state`` (m, v restart at zero).
        GSPMD engine: an off-graph optimizer's store is seeded from the
        params, leaf by leaf under their ``keystr`` names in tree order;
        with params on NVMe the param store takes every leaf under the
        same names (on a mesh the rank's shards, ``rank<r>/<keystr>``, in
        the rank's own store) and the state returns with ``params``
        dropped to the placeholder tree, else as it is. Layered epoch: the state
        returns with ``flat`` dropped to a placeholder, and the opt store
        is seeded in backward order, the order the reversed pass emits the
        rows' gradients."""
        off = self.run.offload
        if not self.layered:
            if self.offgraph:
                if self.opt_store is None:
                    self.opt_store = self._make_store(off.opt_tier, "opt")
                self.offload = ChunkedAdamOffload(self.opt_store)
                # the explicit engine's rank's flat, f32 (bf16 -> f32 is
                # exact), or the GSPMD engine's leaves
                self.offload.init_from_params(
                    {f"{self.rank_key}/flat": state["flat"].float()} if self.explicit
                    else self._rank_named(self.engine.respec(state["params"], "param", "opt")))
                self.offload.step_count = step
            if self.grad_offload and self.grad_store is None:
                self.grad_store = self._make_store(off.grad_tier, "grad")
            if self.param_nvme:
                self._seed_param_stream(self._rank_named(state["params"]), row_split=False)
                state = self._drop_params(state)
            return state
        keys = ("flat", "eflat") if self.is_moe else ("flat",)
        if any(isinstance(state[k], TensorSpec) for k in keys):
            raise ValueError("reseed needs materialized rows, not a placeholder")
        flat = state["flat"].detach().to("cpu")
        eflat = state["eflat"].detach().to("cpu") if self.is_moe else None
        if self.opt_store is None:
            self.opt_store = self._make_store(off.opt_tier, "opt")
        self.offload = ChunkedAdamOffload(self.opt_store)
        # backward order; a MoE layer's expert rows precede its dense row
        # (the reversed pass emits the experts' gradients before the
        # attention part's)
        seed: Dict[str, torch.Tensor] = {}
        for li in range(flat.shape[0] - 1, -1, -1):
            if eflat is not None:
                E = self.engine.n_experts
                for e in range(E):
                    seed[f"x{self.rank_key}/l{li * E + e}"] = eflat[li * E + e]
            seed[f"{self.rank_key}/l{li}"] = flat[li]
        self.offload.init_from_params(seed)
        self.offload.step_count = step
        if self.grad_offload and self.grad_store is None:
            self.grad_store = self._make_store(off.grad_tier, "grad")
        named = {self.rank_key: flat}
        if eflat is not None:
            named[f"x{self.rank_key}"] = eflat
        self._seed_param_stream(named, row_split=True)
        return self._drop_params(state)

    def _seed_param_stream(self, named: Dict[str, torch.Tensor], *, row_split: bool) -> None:
        if self.param_store is None:
            self.param_store = self._make_store("nvme", "param")
        self.param_stream = ParamStreamer(self.param_store,
                                          read_ahead=self.run.offload.param_read_ahead)
        self.param_stream.seed(named, row_split=row_split)

    def _drop_params(self, state: dict) -> dict:
        """``state`` with its store-resident params (the layered epoch's
        rows, the GSPMD engine's leaves) as placeholders."""
        state = dict(state)
        if not self.explicit:
            state["params"] = self._param_placeholder()
            return state
        state["flat"] = self._param_placeholder()
        if self.is_moe:
            state["eflat"] = self._eflat_placeholder()
        return state

    def _param_placeholder(self):
        """The layered epoch's (L, P) row spec, or the GSPMD engine's tree
        of leaf specs."""
        if not self.explicit:
            return self.engine.param_specs()
        return TensorSpec(self.engine.local_shape, torch.bfloat16)

    @staticmethod
    def _is_dropped(tree) -> bool:
        leaves = pt.tree_leaves(tree)
        return bool(leaves) and isinstance(leaves[0], TensorSpec)

    def _eflat_placeholder(self) -> TensorSpec:
        """The rank's (L * E, Pe/dp) expert rows' spec."""
        eng = self.engine
        return TensorSpec((eng.n_layers * eng.n_experts, eng.elayout.padded // self.dp),
                          torch.bfloat16)

    @property
    def total_param_bytes(self) -> int:
        """Bytes of all scheduler-managed rows (this rank's) or leaves (the
        never-fully-resident claim's denominator); 0 where no param is
        slow-tier resident."""
        if not self.param_nvme:
            return 0
        if not self.explicit:
            return sum(math.prod(s.shape) * s.dtype.itemsize
                       for s in pt.tree_leaves(self._param_placeholder()))
        return math.prod(self.engine.local_shape) * 2 + self.expert_total_bytes

    @property
    def expert_total_bytes(self) -> int:
        """Bytes of all expert rows (this rank's slices; the expert-paging
        claim's denominator: peak resident expert bytes stay below it); 0
        without MoE rows."""
        if not (self.layered and self.is_moe):
            return 0
        return math.prod(self._eflat_placeholder().shape) * 2

    def wait_host(self) -> None:
        """Wait until the pinned host tier holds the last step's values
        (before the host reads a host-tier state)."""
        self.engine.host_ready()

    def materialize_rows(self) -> dict:
        """The rows assembled from the param store, on the CPU: ``flat``
        (the rank's (L, P/dp) bf16) and, for MoE, ``eflat`` (the rank's (L *
        E, Pe/dp)) — for checks and checkpoints; the step never calls it."""
        loaded = self.param_stream.load_all()
        out = {"flat": loaded[self.rank_key]}
        if self.is_moe:
            out["eflat"] = loaded[f"x{self.rank_key}"]
        return out

    def materialize_flat(self) -> torch.Tensor:
        """The (L, P) bf16 dense rows assembled from the param store."""
        return self.materialize_rows()["flat"]

    def materialize_params(self) -> dict:
        """The GSPMD engine's param tree assembled from the param store, on
        the CPU (on a mesh the rank's shards) — for checks and
        checkpoints; the step never calls it."""
        return _unflatten_like(self._param_placeholder(),
                               self._unprefixed(self.param_stream.load_all()))

    # ------------------------------------------------------------------
    # tier-independent checkpoint views
    # ------------------------------------------------------------------

    def checkpoint_state(self, state: dict) -> Optional[dict]:
        """``state`` with its placeholder params (the layered epoch's rows,
        the GSPMD engine's leaves) materialized from the param store: what
        the full-state checkpoint persists. Waits for the pinned host
        tier's write-backs first, so a snapshot reads the last step's
        values. On a mesh every rank calls it: rank 0 gets the global
        state, the leaves the reference's checkpoint of the same state
        holds under the same keys, shapes and dtypes, each gathered over
        the ranks one leaf at a time (``engine.gather_state``); every other
        rank gets None."""
        self.wait_host()
        if self.param_nvme:
            state = dict(state)
            if self.explicit and isinstance(state["flat"], TensorSpec):
                state.update(self.materialize_rows())
            elif not self.explicit and self._is_dropped(state["params"]):
                state["params"] = self.materialize_params()
        return self.engine.gather_state(state)

    def portable_like(self, state: dict) -> dict:
        """The portable leaves' structure in ``state`` (the rank's tensors
        or placeholders; nothing gathered or read from a store): what a
        restore of a portable checkpoint reads its keys from."""
        if self.explicit:
            return {k: state[k] for k in self.engine.portable_keys}
        return {"params": state["params"]}

    def portable_state(self, state: dict) -> Optional[dict]:
        """The leaves whose presence and layout do not depend on the tiers,
        so a checkpoint of them restores into an executor at any tier; on
        a mesh, as ``checkpoint_state``, the global leaves on rank 0 and
        None on every other rank."""
        state = self.checkpoint_state(state)
        return None if state is None else self.portable_like(state)

    def adopt_state(self, portable: dict, *, step: int = 0) -> dict:
        """Portable leaves (global: a checkpoint's, written on any mesh) ->
        a full state for this executor's tiers on this rank: the moments
        (in-graph or streamed) and the int8 residual restart at zero,
        in-graph masters are the params' f32 copies, the stores are
        reseeded."""
        if self.explicit:
            portable = self.engine.shard_state(elastic.adapt_state_layout(portable, self))
            state = self.engine.place_state(self.engine.complete_state(portable))
        else:
            state = self.engine.adopt_params(portable["params"], step=step)
        return self.reseed(state, step=step)

    def restore_state(self, restored: dict, *, step: int) -> dict:
        """A full checkpoint restored on the CPU (global leaves, written on
        any mesh) -> this executor's state: the rank's part of each leaf
        (the explicit engine's rows re-padded for this dp first,
        ``runtime/elastic.adapt_state_layout``), placed on its tier, the
        stores reseeded (their moments restart at zero)."""
        restored = self.engine.shard_state(elastic.adapt_state_layout(restored, self))
        return self.reseed(self.engine.place_state(restored), step=step)

    def input_specs(self, shape: ShapeConfig) -> dict:
        return self.engine.input_specs(shape)

    def n_params_active(self) -> int:
        return self.engine.n_params_active()

    # ------------------------------------------------------------------
    # the layered epoch
    # ------------------------------------------------------------------

    def make_train_step(self):
        if self._step_fn is None:
            if self.layered:
                self._step_fn = (self._layered_moe_step() if self.is_moe
                                 else self._layered_step())
            elif not self.offgraph and not self.param_nvme and not self._gspmd_mesh:
                self._step_fn = self.engine.make_train_step()  # fully in-graph
            elif not self.offgraph:
                # the in-graph update on the device: the params stream, or,
                # on a mesh, the rank's bytes are summed over the ranks
                self._step_fn = self._instrumented(self.engine.make_train_step())
            else:
                grads_step = self.engine.make_train_step(grads_only=True)
                self._step_fn = self._instrumented(
                    self._explicit_offgraph_step(grads_step) if self.explicit
                    else self._gspmd_offgraph_step(grads_step))
        return self._step_fn

    # ------------------------------------------------------------------
    # the GSPMD engine's off-graph optimizer
    # ------------------------------------------------------------------

    def _instrumented(self, inner):
        """A step with param streaming (NVMe-resident leaves: loaded before,
        written back and dropped after) and per-step per-tier bandwidth
        metrics around it."""

        def step(state, batch):
            self._trace_step_begin()
            marks = {name: s.mark() for name, s in self._active_stores()}
            if self.param_nvme:
                self._ws.begin_step()
                state = self._load_params(state)
            with trace.span("train_step", sys="compute", attr="compute"):
                new_state, metrics = inner(state, batch)
            if self.param_nvme:
                self._save_params(new_state)
                new_state = self._drop_params(new_state)
            if self.grad_store is not None:
                self.grad_store.flush()  # retire this step's drain futures
            return new_state, self._with_tier_metrics(metrics, marks)

        return step

    def _explicit_offgraph_step(self, grads_step):
        """The explicit engine's grads-only step, then the streamed Adam
        over the rank's flat shard (``rank<r>/flat``): its gradient
        drained to the grad tier when that is slow, the updated bf16 rows
        placed like the old ``flat`` (written into the pinned tensor on the
        host tier, once the update has consumed the gradient and so the
        step's reads of the rows are done)."""
        tc = self.run.train
        param_host = self.engine.param_host
        key = f"{self.rank_key}/flat"

        def step(state, batch):
            new_state, g32, metrics = grads_step(state, batch)
            gflat = {key: g32}
            if self.grad_offload:
                gflat = self._drain_grads(gflat)
            lr = float(metrics["lr"])
            new_master = self.offload.step(gflat, lr=lr, beta1=tc.beta1,
                                           beta2=tc.beta2, eps=tc.eps,
                                           weight_decay=tc.weight_decay)
            rows = new_master[key].to(torch.bfloat16)
            old = state["flat"]
            new_state = dict(new_state)
            new_state["flat"] = old.copy_(rows) if param_host else rows.to(old.device)
            return new_state, metrics

        return step

    def _gspmd_offgraph_step(self, grads_step):
        tc = self.run.train
        eng = self.engine
        param_host = eng.param_host

        def step(state, batch):
            grads, metrics = grads_step(state, batch)
            # the rank's gradient in the optimizer's spec (its shard where
            # the gradient is whole and the optimizer split: stage 1)
            gflat = {k: g.float() for k, g in
                     self._rank_named(eng.respec(grads, "grad", "opt")).items()}
            if self.grad_offload:
                gflat = self._drain_grads(gflat)
            lr = float(adam_mod.lr_at(tc, torch.tensor(self.offload.step_count + 1,
                                                       dtype=torch.int32)))
            new_flat = self.offload.step(gflat, lr=lr, beta1=tc.beta1,
                                         beta2=tc.beta2, eps=tc.eps,
                                         weight_decay=tc.weight_decay)
            if self.dp > 1:
                new_flat = self._opt_to_params(state["params"], new_flat)
            # the update consumed every gradient, so the step's reads of the
            # params are done: a pinned host leaf may take its new value.
            # NVMe-resident leaves stay on the host, rounded there, for the
            # param store
            new_state = dict(state)
            new_state["params"] = _unflatten_like(
                state["params"], new_flat, in_place=param_host,
                device="cpu" if self.param_nvme else None)
            return new_state, dict(metrics, lr=lr)

        return step

    def _rank_named(self, tree: dict) -> Dict[str, torch.Tensor]:
        """The GSPMD engine's leaves by their opt- and param-store names:
        ``keystr``, under the rank's prefix (``rank<r>/``) on a mesh."""
        named = flatten_with_paths(tree)
        if self.dp == 1:
            return named
        return {f"{self.rank_key}/{k}": v for k, v in named.items()}

    def _unprefixed(self, named: Dict[str, object]) -> Dict[str, object]:
        """Store names -> ``keystr`` names (``_rank_named`` undone)."""
        if self.dp == 1:
            return named
        cut = len(self.rank_key) + 1
        return {k[cut:]: v for k, v in named.items()}

    def _opt_to_params(self, like: dict,
                       new_flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A mesh rank's updated f32 masters (opt-store names, the opt
        spec) -> its params by ``keystr``. Where the param and opt rules
        cut a leaf alike (every leaf at stages 0 and 3) the rank's master
        is its param shard: it stays on the host, for ``_unflatten_like``
        to round there (with params on NVMe it never crosses to the card).
        Where the params are whole and the optimizer split (stages 1-2)
        the master is rounded to the leaf's dtype on the device and
        all-gathered over the data ranks: every rank then holds, and with
        params on NVMe writes back to its own store, the whole leaf."""
        eng = self.engine
        out: Dict[str, torch.Tensor] = {}
        gather: dict = {}
        for path in pt.tree_paths(like):
            t = new_flat[f"{self.rank_key}/{keystr(path)}"]
            if pt.tree_get(eng.splits["opt"], path) == pt.tree_get(eng.splits["param"], path):
                out[keystr(path)] = t
            else:
                pt.tree_set(gather, path, t.to(self.device).to(pt.tree_get(like, path).dtype))
        out.update(flatten_with_paths(eng.respec(gather, "opt", "param")))
        return out

    def _drain_grads(self, gflat: Dict[str, torch.Tensor]) -> Dict[str, object]:
        """Drain f32 gradients to the grad tier: each becomes a write-then-
        read ``roundtrip`` future resolving to the store-resident copy,
        copied off the card after the event behind the kernels that wrote
        it. ``ChunkedAdamOffload.step`` resolves a leaf only when its first
        chunk reaches the update stage, so later leaves' drains overlap the
        pipeline's work on earlier ones."""
        ready = self._ready_event()
        return {k: self.grad_store.roundtrip(f"{k}/g", g, ready=ready)
                for k, g in gflat.items()}

    def _ensure_leaf_scheduler(self):
        """The GSPMD engine's leaves under the layered epoch's scheduler,
        one leaf a unit: at most ``window`` staged on the host at once while
        the rest are in flight or already on the device; rebuilt when
        ``reseed`` swapped the streamer."""
        if self._sched is None or self._pe_stream is not self.param_stream:
            off = self.run.offload
            stream = self.param_stream
            names = stream.names()
            window = off.prefetch_layers or max(2, off.param_read_ahead)

            def fetch(i):
                return [stream.read_row(names[i], 0)]

            self._sched = sched_mod.LayerSchedule(len(names), window,
                                                  read_ahead=off.param_read_ahead)
            self._pe = sched_mod.PrefetchEngine(fetch, self._ws, trace_cls="param")
            self._pe_stream = stream
        return self.param_stream.names(), self._sched, self._pe

    def _load_params(self, state: dict) -> dict:
        """``state`` with its params loaded from the store through the leaf
        scheduler: each leaf to the device as it lands (a pinned pool
        buffer, released before the next read is awaited, so the pool
        bounds the staging), its host copy evicted at once."""
        names, sched, pe = self._ensure_leaf_scheduler()
        host: Dict[int, torch.Tensor] = {}
        on_device: Dict[str, torch.Tensor] = {}

        def use(i):
            with trace.span("h2d_leaf", sys="store", cls="param"):
                on_device[names[i]] = self._stager.to_device(host[i])
                self._stager.retire(wait=True)

        pe.run_events(sched.forward(),
                      on_materialize=lambda i, vals: host.__setitem__(i, vals[0]),
                      on_use=use,
                      on_evict=lambda i: host.pop(i, None))
        state = dict(state)
        state["params"] = _unflatten_like(state["params"], self._unprefixed(on_device))
        return state

    def _save_params(self, new_state: dict) -> None:
        """The step's updated params back to the param store: device leaves
        copied off after an event behind the update's kernels, host leaves
        as they are."""
        with trace.span("param_writeback", sys="optim", attr="io_wait", cls="param"):
            self.param_stream.save_all(self._rank_named(new_state["params"]),
                                       ready=self._ready_event())

    def _ensure_row_scheduler(self, batch):
        """Plan + prefetcher over the rank's rows; rebuilt when ``reseed``
        swapped the streamer or, for the auto window, the batch's tokens
        changed. The auto window counts the global batch's tokens (the
        rank's slice times dp) and the whole row, as the reference's."""
        off = self.run.offload
        tokens = batch["tokens"].numel() * self.dp
        stale = (self._sched is None or self._pe_stream is not self.param_stream
                 or (not off.prefetch_layers and tokens != self._sched_tokens))
        if stale:
            L = self.engine.n_layers
            window = off.prefetch_layers or sched_mod.default_prefetch_layers(
                L, self.engine.layout.padded, tokens,
                compression_ratio=qformat.compression_ratio(off.param_quant))
            self._sched_tokens = tokens
            stream, wire, name = self.param_stream, self._wire_rows, self.rank_key

            def fetch(layer):
                return [stream.read_row(name, layer, wire=wire)]

            self._sched = sched_mod.LayerSchedule(L, window,
                                                  read_ahead=off.param_read_ahead)
            self._pe = sched_mod.PrefetchEngine(fetch, self._ws, trace_cls="param")
            self._pe_stream = stream
        return self._sched, self._pe

    def _device_row(self, vals):
        """The rank's host row (slice) -> the device (pinned, non-blocking):
        a bf16 row, or under q8 the wire operands ``(q, s)``."""
        with trace.span("h2d_row", sys="store", cls="param"):
            if self._wire_rows:
                return qformat.wire_row_device(vals[0], self._stager)
            return self._stager.to_device(vals[0])

    def _ready_event(self):
        """An event behind the kernels enqueued so far (None on the CPU,
        where a tensor is complete when its op returns)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _layered_step(self):
        eng = self.engine
        tc = self.run.train

        def step(state, batch):
            self._trace_step_begin()
            marks = {name: s.mark() for name, s in self._active_stores()}
            if self._layer_fns is None:
                self._layer_fns = eng.make_layer_fns()
            fns = self._layer_fns
            sched, pe = self._ensure_row_scheduler(batch)
            self._ws.begin_step()
            rows: Dict[int, torch.Tensor] = {}

            def run_pass(events, use_fn):
                pe.run_events(
                    events,
                    on_materialize=lambda l, vals: rows.__setitem__(
                        l, self._device_row(vals)),
                    on_use=use_fn,
                    on_evict=lambda l: rows.pop(l, None))

            # ---- forward ----
            x = fns["embed_fwd"](state["other"], batch["tokens"])
            acts: Dict[int, torch.Tensor] = {}

            def fwd_use(layer):
                nonlocal x
                acts[layer] = x  # the layer's input (its recompute seed)
                x = fns["layer_fwd"](x, rows[layer])

            run_pass(sched.forward(), fwd_use)

            # ---- head + reversed layer pass ----
            loss, dx, g_head = fns["head"](x, state["other"], batch["labels"])
            gdict: Dict[str, object] = {}
            # the grad norm's sum of squares stays on the device until finish
            sumsq = torch.zeros((), dtype=torch.float32, device=self.device)

            def bwd_use(layer):
                nonlocal dx, sumsq
                dx, g_row = fns["layer_vjp"](acts.pop(layer), rows[layer], dx)
                sumsq = fns["accum_sumsq"](sumsq, g_row)
                key = f"{self.rank_key}/l{layer}"
                gdict[key] = (self.grad_store.roundtrip(f"{key}/g", g_row,
                                                        ready=self._ready_event())
                              if self.grad_offload else g_row)

            run_pass(sched.backward(), bwd_use)

            g_emb = fns["embed_vjp"](state["other"], batch["tokens"], dx)
            new_other, new_other_opt, new_step, fm = fns["finish"](
                state["other"], state["other_opt"], state["step"],
                g_head, g_emb, sumsq)

            # reading lr waits for finish and so for the whole step's
            # device work: where the compute lands on the critical path
            with trace.span("device_sync", sys="compute", attr="compute"):
                lr_host = float(fm["lr"])

            # streamed per-row Adam on the host; bf16 rows straight back
            new_master = self.offload.step(
                gdict, lr=lr_host, beta1=tc.beta1, beta2=tc.beta2,
                eps=tc.eps, weight_decay=tc.weight_decay)
            with trace.span("param_writeback", sys="optim", cls="param"):
                for key, m32 in new_master.items():
                    rank, layer = key.split("/")  # "rank<r>/l<i>"
                    self.param_stream.write_row(rank, int(layer[1:]),
                                                m32.to(torch.bfloat16))
                self.param_stream.flush()
            if self.grad_store is not None:
                self.grad_store.flush()
            self._stager.retire(wait=True)

            new_state = {"flat": self._param_placeholder(), "other": new_other,
                         "other_opt": new_other_opt, "step": new_step}
            metrics = {"loss": loss, "grad_norm": fm["grad_norm"], "lr": fm["lr"]}
            return new_state, self._with_tier_metrics(metrics, marks)

        return step

    # ------------------------------------------------------------------
    # the MoE layered epoch: dynamic expert schedule units
    # ------------------------------------------------------------------

    def _ensure_expert_paging(self):
        """The ``("x", layer, expert)`` units' prefetch engine (class
        ``expert``, sharing the working-set accounting), the hot cache and
        the popularity predictor; rebuilt when ``reseed`` swapped the
        streamer."""
        if self._pe_x is not None and self._pe_x_stream is self.param_stream:
            return self._pe_x, self._hot, self._pop
        if self._hot is not None:
            self._hot.clear()
        eng, stream = self.engine, self.param_stream
        E, name = eng.n_experts, f"x{self.rank_key}"

        def fetch(unit):
            _, l, e = unit
            # the rank's slice, decoded by the store under param_quant:
            # expert rows travel bf16
            return [stream.read_row(name, l * E + e)]

        self._pe_x = sched_mod.PrefetchEngine(fetch, self._ws, cls="expert")
        # the budget in the global row's bytes, as each offer counts: every
        # rank keeps and drops the same units (the reference's decisions)
        budget = sched_mod.resolve_expert_hot_bytes(
            self.run.offload.expert_hot_mb, eng.top_k, eng.elayout.padded * 2)
        self._hot = sched_mod.HotUnitCache(budget, self._pe_x)
        self._pop = sched_mod.ExpertPopularity()
        self._pe_x_stream = stream
        return self._pe_x, self._hot, self._pop

    @staticmethod
    def _expert_waves(sel: list, W: int) -> list:
        """Selected expert ids -> fixed-width waves ``(ids, padded ids,
        mask)``; padding repeats the last id with a zero mask (zero output,
        zero gradient; its gradient slot is dropped)."""
        waves = []
        for i in range(0, len(sel), W):
            wave = sel[i:i + W]
            pad = W - len(wave)
            waves.append((wave, wave + [wave[-1]] * pad, [1.0] * len(wave) + [0.0] * pad))
        return waves

    def _layered_moe_step(self):
        eng = self.engine
        tc = self.run.train
        E, L = eng.n_experts, eng.n_layers
        W = max(1, eng.top_k)
        row_bytes = eng.elayout.padded * 2  # the global row's: the hot cache's unit
        xkey = f"x{self.rank_key}"

        def step(state, batch):
            self._trace_step_begin()
            marks = {name: s.mark() for name, s in self._active_stores()}
            if self._layer_fns is None:
                self._layer_fns = eng.make_layer_fns()
            fns = self._layer_fns
            sched, pe = self._ensure_row_scheduler(batch)
            pe_x, hot, pop = self._ensure_expert_paging()
            self._ws.begin_step()
            dev = self.device
            rows: Dict[int, object] = {}
            router = state["other"]["router"]
            sel_by_layer: Dict[int, list] = {}
            drop_fracs, loads = [], []

            def run_pass(events, use_fn, predict_fn):
                # predicted (forward) or known (backward) expert rows start
                # reading when their layer's dense row enters the horizon
                def on_prefetch(l):
                    for e in predict_fn(l):
                        if ("x", l, e) not in hot:
                            pe_x.prefetch(("x", l, e))

                pe.run_events(
                    events,
                    on_materialize=lambda l, vals: rows.__setitem__(
                        l, self._device_row(vals)),
                    on_use=use_fn,
                    on_evict=lambda l: rows.pop(l, None),
                    on_prefetch=on_prefetch)

            def wave_rows(l, wave):
                """One wave's (W, Pe) device rows (hot hits are free)."""
                fresh, rws = [], []
                for e in wave:
                    u = ("x", l, e)
                    payload = hot.get(u)
                    if payload is None:
                        payload = self._expert_row(pe_x.materialize(u))
                        fresh.append((u, payload))
                    rws.append(payload)
                rws += [rws[-1]] * (W - len(rws))
                return torch.stack(rws), fresh

            def retire(l, fresh):
                for u, payload in fresh:
                    if not hot.offer(u, payload, nbytes=row_bytes,
                                     popularity=pop.score(l, u[2])):
                        pe_x.evict(u)  # idempotent where offer dropped it

            def start_reads(l, sel):
                for e in sel:
                    if ("x", l, e) not in hot:
                        pe_x.prefetch(("x", l, e))

            def wave_args(ids, mask):
                return (torch.tensor(ids, dtype=torch.int64, device=dev),
                        torch.tensor(mask, dtype=torch.float32, device=dev))

            # ---- forward ----
            x = fns["embed_fwd"](state["other"], batch["tokens"])
            acts: Dict[int, torch.Tensor] = {}

            def fwd_use(l):
                nonlocal x
                acts[l] = x
                x_mid, counts_e, dropped, routed = fns["moe_attn"](x, rows[l], router[l])
                # the one host sync per layer: the waves need the routed set
                host = torch.cat([counts_e, dropped[None], routed[None]]).cpu()
                counts = host[:E]
                sel = [int(e) for e in torch.nonzero(counts > 0).flatten()]
                sel_by_layer[l] = sel
                routed_f = max(float(host[E + 1]), 1.0)
                drop_fracs.append(float(host[E]) / routed_f)
                load = counts.double() / routed_f
                loads.append(load)
                pop.update(l, load.tolist())
                start_reads(l, sel)
                out = x_mid
                for wave, ids, mask in self._expert_waves(sel, W):
                    erows, fresh = wave_rows(l, wave)
                    out = out + fns["moe_wave_fwd"](x_mid, rows[l], router[l], erows,
                                                    *wave_args(ids, mask))
                    retire(l, fresh)
                x = out

            run_pass(sched.forward(), fwd_use, lambda l: pop.top(l, W))

            # ---- head + reversed pass ----
            loss, dx, g_head = fns["head"](x, state["other"], batch["labels"])
            gdict: Dict[str, object] = {}
            g_router = [None] * L
            sumsq = torch.zeros((), dtype=torch.float32, device=dev)

            def drain(key, g):
                gdict[key] = (self.grad_store.roundtrip(f"{key}/g", g,
                                                        ready=self._ready_event())
                              if self.grad_offload else g)

            def bwd_use(l):
                nonlocal dx, sumsq
                x_in = acts.pop(l)
                x_mid = fns["moe_xmid"](x_in, rows[l])
                sel = sel_by_layer[l]
                start_reads(l, sel)
                dxmid, g_row, g_rt = dx, None, None
                for wave, ids, mask in self._expert_waves(sel, W):
                    erows, fresh = wave_rows(l, wave)
                    dxm, g_row_w, g_rt_w, g_er = fns["moe_wave_vjp"](
                        x_mid, rows[l], router[l], erows, *wave_args(ids, mask), dx)
                    dxmid = dxmid + dxm
                    g_row = g_row_w if g_row is None else g_row + g_row_w
                    g_rt = g_rt_w if g_rt is None else g_rt + g_rt_w
                    sumsq = fns["accum_sumsq2"](sumsq, g_er)
                    # only the wave's real rows drain: a padded slot's
                    # gradient must not reach the expert it repeats
                    for i, e in enumerate(wave):
                        drain(f"{xkey}/l{l * E + e}", g_er[i])
                    retire(l, fresh)
                dx_new, g_row_attn = fns["moe_attn_vjp"](x_in, rows[l], dxmid)
                g_row = g_row_attn if g_row is None else g_row + g_row_attn
                g_router[l] = g_rt
                sumsq = fns["accum_sumsq"](sumsq, g_row)
                dx = dx_new
                drain(f"{self.rank_key}/l{l}", g_row)

            run_pass(sched.backward(), bwd_use, lambda l: sel_by_layer.get(l, []))

            # unrouted experts step from known-zero gradients, fed straight
            # to the streamed Adam (their m and v decay as the all-resident
            # run's); no grad-tier traffic scales with E
            zero_row = torch.zeros(eng.elayout.padded // self.dp, dtype=torch.float32)
            for l in range(L):
                selset = set(sel_by_layer[l])
                for e in range(E):
                    if e not in selset:
                        gdict[f"{xkey}/l{l * E + e}"] = zero_row

            g_emb = fns["embed_vjp"](state["other"], batch["tokens"], dx)
            g_head = dict(g_head)
            zeros_rt = torch.zeros_like(router[0])
            g_head["router"] = g_head["router"] + torch.stack(
                [g if g is not None else zeros_rt for g in g_router])
            new_other, new_other_opt, new_step, fm = fns["finish"](
                state["other"], state["other_opt"], state["step"],
                g_head, g_emb, sumsq)

            with trace.span("device_sync", sys="compute", attr="compute"):
                lr_host = float(fm["lr"])
            new_master = self.offload.step(
                gdict, lr=lr_host, beta1=tc.beta1, beta2=tc.beta2,
                eps=tc.eps, weight_decay=tc.weight_decay)
            with trace.span("param_writeback", sys="optim", cls="param"):
                for key, m32 in new_master.items():
                    rank, layer = key.split("/")  # "[x]rank<r>/l<i>"
                    self.param_stream.write_row(rank, int(layer[1:]),
                                                m32.to(torch.bfloat16))
                # hot rows take the new masters, so the next step's hot hits
                # serve the updated parameters
                for u in hot.units():
                    _, l, e = u
                    hot.replace(u, self._expert_row(
                        [new_master[f"{xkey}/l{l * E + e}"].to(torch.bfloat16)]))
                self.param_stream.flush()
            if self.grad_store is not None:
                self.grad_store.flush()
            self._stager.retire(wait=True)

            new_state = {"flat": self._param_placeholder(),
                         "eflat": self._eflat_placeholder(),
                         "other": new_other, "other_opt": new_other_opt,
                         "step": new_step}
            metrics = {"loss": loss, "grad_norm": fm["grad_norm"], "lr": fm["lr"],
                       "moe_dropped_token_fraction": sum(drop_fracs) / len(drop_fracs),
                       "moe_expert_load": torch.stack(loads).mean(dim=0),
                       "expert_total_bytes": self.expert_total_bytes}
            return new_state, self._with_tier_metrics(metrics, marks)

        return step

    def _expert_row(self, vals) -> torch.Tensor:
        """One expert's host row (the rank's bf16 slice) -> the device."""
        with trace.span("h2d_row", sys="store", cls="expert"):
            return self._stager.to_device(vals[0])

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------

    def _active_stores(self):
        return [(name, s) for name, s in (("param", self.param_store),
                                           ("grad", self.grad_store),
                                           ("opt", self.opt_store))
                if s is not None]

    def _trace_step_begin(self) -> None:
        if trace.enabled():
            self._trace_t0 = time.perf_counter()
            self._trace_tid = threading.get_ident()

    def _with_trace_attribution(self, out: dict) -> dict:
        """The step's wall time partitioned from the recorded spans, as
        ``trace_*`` metrics."""
        if not (trace.enabled() and self._trace_t0 is not None):
            return out
        att = trace.TRACER.attribute_window(
            self._trace_t0, time.perf_counter(), main_tid=self._trace_tid)
        self._trace_t0 = None
        self.trace_attributions.append(att)
        out.update(trace.flatten_attribution(att))
        return out

    def _with_tier_metrics(self, metrics, marks) -> dict:
        """This step's per-tier counters (deltas, never cumulative):
        param-in/out, grad-out, opt-read/write bytes and GB/s, the NVMe
        aggregate, the pinned pool's peak, and the scheduler's residency.
        ``<class>_*_bytes`` are logical (the full-precision arrays moved),
        ``<class>_*_wire_bytes`` what crossed the tier — smaller under a
        quantized wire format, equal otherwise; the GB/s and the NVMe
        aggregate count wire bytes. At dp > 1 they are the rank's, and
        each integer counter's sum over the ranks sits beside it as
        ``<counter>_all_ranks`` (one sum over the ranks a step)."""
        out = dict(metrics)
        nvme = {"bytes_read": 0, "bytes_written": 0}
        for name, store in self._active_stores():
            d = store.delta_since(marks[name])
            r, w = d["bytes_read"], d["bytes_written"]
            lr, lw = d["logical_bytes_read"], d["logical_bytes_written"]
            if name == "param":
                out.update(param_in_bytes=lr, param_in_wire_bytes=r,
                           param_in_gbps=d["read_gbps"], param_out_bytes=lw,
                           param_out_wire_bytes=w, param_out_gbps=d["write_gbps"])
            elif name == "grad":
                out.update(grad_out_bytes=lw, grad_out_wire_bytes=w,
                           grad_out_gbps=d["write_gbps"])
            else:
                out.update(opt_read_bytes=lr, opt_read_wire_bytes=r,
                           opt_read_gbps=d["read_gbps"], opt_write_bytes=lw,
                           opt_write_wire_bytes=w, opt_write_gbps=d["write_gbps"])
            if store.kind == "nvme":
                nvme["bytes_read"] += r
                nvme["bytes_written"] += w
        out["nvme_bytes_read"] = nvme["bytes_read"]
        out["nvme_bytes_written"] = nvme["bytes_written"]
        out["nvme_pinned_peak_bytes"] = self._pool.peak_resident
        if self.param_nvme:  # scheduler residency
            out.update(self._ws.stats())
            out["param_total_bytes"] = self.total_param_bytes
        if self.dp > 1:
            keys = [k for k, v in out.items() if k.endswith("_bytes") and isinstance(v, int)]
            out.update({f"{k}_all_ranks": v for k, v in
                        zip(keys, self.mesh.sum_over_ranks([out[k] for k in keys]))})
        return self._with_plan_crosscheck(self._with_trace_attribution(out))

    def _with_plan_crosscheck(self, out: dict) -> dict:
        """Predicted beside measured: with a plan, its predictions sit next
        to the step's counters, per device as the counters are: the
        residency budget and the state bytes (``plan_*_shard_bytes``) are a
        device's, the slow-tier bytes a step (``plan_*_step_bytes``, the
        plan's count of the whole model) are scaled to the rank's share
        (``_plan_share``); the ``*_all_ranks`` sums of the counters hold
        the whole model's bytes and the duplicates of the leaves every
        rank holds whole. The residency claim is directional (the
        measured peak must stay at or below the plan's budget), so it also
        gets a pass/fail flag, ``plan_residency_ok``."""
        if self.plan is None:
            return out
        pred = self.plan.predictions
        pp = pred.get("peak_resident_param_bytes")
        if pp is not None:
            out["plan_peak_resident_param_bytes"] = pp
            if "peak_resident_param_bytes" in out:
                out["plan_residency_ok"] = bool(out["peak_resident_param_bytes"] <= pp)
        if "efficiency" in pred:
            out["plan_efficiency"] = pred["efficiency"]
        if "param_shard_bytes" in out and "n_params" in pred:
            # each device's share of the plan's state bytes (its
            # arithmetic: bf16 params, f32 grads, f32 master + m + v)
            n = pred["n_params"] / self.plan.hardware.n_devices
            for cls, per in (("param", plan_mod.PARAM_BYTES_PP),
                             ("grad", plan_mod.GRAD_BYTES_PP), ("opt", plan_mod.OPT_BYTES_PP)):
                out[f"plan_{cls}_shard_bytes"] = per * n
        for cls_, measured_keys in (
                ("param", ("param_in_bytes", "param_out_bytes")),
                ("grad", ("grad_out_bytes",)),
                ("opt", ("opt_read_bytes", "opt_write_bytes"))):
            if not any(k in out for k in measured_keys):
                continue
            # the plan counts the model's bytes once; a rank's counters
            # count its own, so the prediction beside them is the rank's
            # share of it (all of it at one rank)
            share = self._plan_share(cls_)
            for what in ("", "_wire"):
                total = sum(v for v in (pred.get(f"{cls_}_step_read{what}_bytes"),
                                        pred.get(f"{cls_}_step_write{what}_bytes"))
                            if v is not None)
                if total:
                    out[f"plan_{cls_}_step{what}_bytes"] = total * share
        return out

    def _plan_share(self, cls: str) -> float:
        """The rank's share of the bytes the plan predicts for state class
        ``cls`` a step: 1 at one rank; the explicit engine's ranks each
        stream 1/dp of every row; a GSPMD rank its elements of the class's
        spec over the model's (``engine.shard_share``), which counts the
        leaves the rank holds whole in full (``engine.unsplit_leaves``),
        so the ranks' shares sum past 1 by those leaves' duplicates."""
        if self.dp == 1:
            return 1.0
        if self.explicit:
            return 1.0 / self.dp
        return self.engine.shard_share(cls)

    def bandwidth_stats(self) -> dict:
        """Whole-run aggregate over every store, per class and combined."""
        stores = self._active_stores()
        if not stores:
            return {}
        out = {}
        tot_r = tot_w = 0
        tot_rt = tot_wt = 0.0
        for name, store in stores:
            s = store.bandwidth_stats()
            out[f"{name}_bytes_read"] = s["bytes_read"]
            out[f"{name}_bytes_written"] = s["bytes_written"]
            out[f"{name}_read_gbps"] = s["read_gbps"]
            out[f"{name}_write_gbps"] = s["write_gbps"]
            out[f"{name}_logical_bytes_read"] = s["logical_bytes_read"]
            out[f"{name}_logical_bytes_written"] = s["logical_bytes_written"]
            tot_r += s["bytes_read"]
            tot_w += s["bytes_written"]
            tot_rt += s["read_time"]
            tot_wt += s["write_time"]
        out["bytes_read"] = tot_r
        out["bytes_written"] = tot_w
        out["read_gbps"] = tot_r / max(tot_rt, 1e-9) / 1e9
        out["write_gbps"] = tot_w / max(tot_wt, 1e-9) / 1e9
        out["pinned_peak_bytes"] = self._pool.peak_resident
        return out


def _unflatten_like(like: dict, flat: Dict[str, torch.Tensor], *,
                    in_place: bool = False, device=None) -> dict:
    """``flat`` (``keystr`` name -> tensor) as a nested dict shaped like
    ``like`` (tensors or ``TensorSpec``), each leaf cast to ``like``'s
    dtype (round to nearest even) on ``device``, by default the device of
    ``like``'s tensor (of ``flat``'s where ``like`` holds a spec); with
    ``in_place`` written into ``like``'s own tensors (the pinned host tier
    keeps its residency)."""
    out: dict = {}
    for path in pt.tree_paths(like):
        leaf, new = pt.tree_get(like, path), flat[keystr(path)]
        if in_place:
            leaf.copy_(new)
        else:
            dev = device or getattr(leaf, "device", new.device)
            leaf = new.to(dtype=leaf.dtype).to(dev)
        pt.tree_set(out, path, leaf)
    return out
