"""Overlap-centric schedule-unit scheduler (paper Sec. 6), the port of
``repro/core/schedule.py``.

Parameters live in the slow tiers and stream through a bounded window of
schedule units, prefetched ahead of use and evicted right after, so the
device-resident working set is O(window). A unit is a hashable key naming
one independently movable row: a dense layer's row (its layer index) or
one expert's weights in an MoE layer (``("x", layer, expert)``).

  * ``LayerSchedule`` — the pure plan: an ordered event stream
    (``prefetch`` / ``materialize`` / ``use`` / ``evict``) for one pass,
    forward order or reversed for the backward;
  * ``WorkingSetManager`` — residency accounting: per-step peak resident
    bytes, prefetch hit rate, evictions, and per unit class (``cls``, e.g.
    ``expert_peak_resident_bytes``);
  * ``PrefetchEngine`` — runs a plan's reads over an async fetch backend
    (``ParamStreamer.read_row`` futures); units known only at run time
    (router-selected expert rows) go through ``prefetch`` /
    ``materialize`` / ``touch`` / ``evict`` directly;
  * ``HotUnitCache`` + ``ExpertPopularity`` — a byte-budgeted
    popularity/LRU cache that keeps hot expert rows resident across steps,
    and the routing-count EMA that predicts which rows to prefetch before
    the router has run.

``default_prefetch_layers`` derives the window from the paper's Sec. 3-4
model with the reference's constants, so both packages pick the same
window; ``default_kv_prefetch_blocks`` is its serving mirror, which the
planner uses for the KV read-ahead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.model_math import BYTES_PER_PARAM_FP16
from repro_torch.runtime import trace

# Paper Fig. 2b / Sec. 4 nominal rates used when no measured bandwidth is
# available: per-device NVMe bandwidth and per-device peak throughput.
PAPER_NVME_BYTES_PER_S = 1.6e9
PAPER_PEAK_FLOPS = 70e12


def default_prefetch_layers(num_layers: int, layer_param_count: int,
                            batch_tokens: int, *,
                            slow_bw: float = PAPER_NVME_BYTES_PER_S,
                            peak_flops: float = PAPER_PEAK_FLOPS,
                            compression_ratio: float = 1.0) -> int:
    """Bandwidth-aware window (paper Secs. 3-4): the layers of compute
    (``2 * 4 * batch_tokens * layer_param_count`` FLOPs each at
    ``peak_flops``) that hide one layer's fetch (``2 * layer_param_count``
    bytes at ``slow_bw``), +1 for the layer in use, deepened by a wire
    ``compression_ratio`` and clamped below full residency."""
    if num_layers <= 1:
        return 1
    read_t = BYTES_PER_PARAM_FP16 * layer_param_count / max(slow_bw, 1.0)
    compute_t = 2.0 * 4.0 * max(batch_tokens, 1) * layer_param_count / peak_flops
    window = int(math.ceil(read_t / max(compute_t, 1e-12))) + 1
    window = int(math.ceil(window * max(compression_ratio, 1.0)))
    return max(1, min(window, num_layers - 1))


def default_kv_prefetch_blocks(block_bytes: float, step_flops: float, *,
                               slow_bw: float = PAPER_NVME_BYTES_PER_S,
                               peak_flops: float = PAPER_PEAK_FLOPS) -> int:
    """KV-block read-ahead for serving: the decode steps (``step_flops``
    each at ``peak_flops``) that hide one block fetch (``block_bytes`` at
    ``slow_bw``), clamped to [1, 8] (the pinned pool backpressures
    anything deeper)."""
    read_t = max(block_bytes, 1.0) / max(slow_bw, 1.0)
    compute_t = max(step_flops, 1.0) / max(peak_flops, 1.0)
    return max(1, min(8, int(math.ceil(read_t / max(compute_t, 1e-12)))))


@dataclasses.dataclass(frozen=True)
class Event:
    """One scheduler action on one unit; ``op`` in {prefetch, materialize,
    use, evict}, ``unit`` a hashable key (a layer index for dense rows)."""

    op: str
    unit: object


class LayerSchedule:
    """The pure movement plan for one pass over a sequence of units.

    ``window`` bounds how many units are materialized (resident) at once;
    ``read_ahead`` adds reads in flight beyond the window. Every unit is
    materialized and used once per pass, and evicted right after its use.
    """

    def __init__(self, num_layers: int, window: int, read_ahead: int = 1):
        if num_layers < 1 or window < 1 or read_ahead < 1:
            raise ValueError(f"LayerSchedule({num_layers}, {window}, "
                             f"read_ahead={read_ahead}): all must be >= 1")
        self.num_layers = num_layers
        self.window = min(window, num_layers)
        self.read_ahead = read_ahead

    def pass_events(self, order: Optional[Sequence] = None) -> List[Event]:
        order = list(order) if order is not None else list(range(self.num_layers))
        n = len(order)
        horizon = self.window + self.read_ahead
        events: List[Event] = []
        prefetched = [False] * n
        materialized = [False] * n
        for idx in range(n):
            for j in range(idx, min(n, idx + horizon)):
                if not prefetched[j]:
                    events.append(Event("prefetch", order[j]))
                    prefetched[j] = True
            for j in range(idx, min(n, idx + self.window)):
                if not materialized[j]:
                    events.append(Event("materialize", order[j]))
                    materialized[j] = True
            events.append(Event("use", order[idx]))
            events.append(Event("evict", order[idx]))  # immediately after use
        return events

    def forward(self) -> List[Event]:
        return self.pass_events(range(self.num_layers))

    def backward(self) -> List[Event]:
        return self.pass_events(range(self.num_layers - 1, -1, -1))


class WorkingSetManager:
    """Residency + prefetch-effectiveness accounting for one executor.

    ``begin_step()`` resets the per-step view; ``stats()`` returns the step
    metrics. Byte counts cover scheduler-managed parameters only (the
    windowed rows/leaves) — replicated small states (embeddings, norms) are
    always device-resident and excluded by construction.
    """

    def __init__(self):
        self.current_bytes = 0
        self._cls_current: Dict[str, int] = {}
        self.begin_step()

    def begin_step(self) -> None:
        self.peak_bytes = self.current_bytes
        self.evictions = 0
        self.hits = 0
        self.misses = 0
        # per-class views (units resident across steps — a hot cache — carry
        # their bytes into the new step's baseline, same as the aggregate)
        self._cls_peak = dict(self._cls_current)
        self._cls_hits: Dict[str, int] = {}
        self._cls_misses: Dict[str, int] = {}
        self._cls_evictions: Dict[str, int] = {}

    def on_materialize(self, nbytes: int, hit: bool, cls: Optional[str] = None) -> None:
        self.current_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.current_bytes)
        if hit:
            self.hits += 1
        else:
            self.misses += 1
        if cls is not None:
            cur = self._cls_current.get(cls, 0) + nbytes
            self._cls_current[cls] = cur
            self._cls_peak[cls] = max(self._cls_peak.get(cls, 0), cur)
            bucket = self._cls_hits if hit else self._cls_misses
            bucket[cls] = bucket.get(cls, 0) + 1

    def on_hit(self, cls: Optional[str] = None) -> None:
        """A use served by an already-resident unit (hot-cache hit): counts
        toward the hit rate without changing resident bytes."""
        self.hits += 1
        if cls is not None:
            self._cls_hits[cls] = self._cls_hits.get(cls, 0) + 1

    def on_evict(self, nbytes: int, cls: Optional[str] = None) -> None:
        self.current_bytes -= nbytes
        self.evictions += 1
        if cls is not None:
            self._cls_current[cls] = self._cls_current.get(cls, 0) - nbytes
            self._cls_evictions[cls] = self._cls_evictions.get(cls, 0) + 1

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        out = {
            "peak_resident_param_bytes": self.peak_bytes,
            "prefetch_hit_rate": self.hits / total if total else 0.0,
            "evictions": self.evictions,
        }
        for cls in sorted(self._cls_peak):
            n = self._cls_hits.get(cls, 0) + self._cls_misses.get(cls, 0)
            out[f"{cls}_peak_resident_bytes"] = self._cls_peak[cls]
            out[f"{cls}_prefetch_hit_rate"] = (self._cls_hits.get(cls, 0) / n
                                               if n else 0.0)
            out[f"{cls}_evictions"] = self._cls_evictions.get(cls, 0)
        return out


class PrefetchEngine:
    """Executes a ``LayerSchedule``'s I/O against an async fetch backend.

    ``fetch(unit)`` returns a list of futures (one per rank shard for the
    explicit engine's rows; a single future for the GSPMD engine's leaves).
    ``prefetch`` issues the reads; ``materialize`` resolves them — a *hit*
    only when the unit was prefetched earlier AND every read had already
    completed when its turn came (the prefetch fully hid the slow-tier
    latency; a still-in-flight or on-demand fetch stalls the consumer and
    counts as a miss) — and records the bytes as resident until ``evict``.
    """

    def __init__(self, fetch: Callable[[object], list], ws: WorkingSetManager,
                 cls: Optional[str] = None,
                 trace_cls: Optional[str] = None):
        self._fetch = fetch
        self.ws = ws
        self.cls = cls  # unit class tag for per-class working-set metrics
        # span class tag: defaults to the metrics class; lets an unclassed
        # engine (dense param rows) still attribute its stalls to "param"
        self.trace_cls = trace_cls if trace_cls is not None else cls
        self._inflight: Dict[object, list] = {}
        self._resident: Dict[object, int] = {}  # unit -> materialized nbytes

    def prefetch(self, unit) -> None:
        if unit not in self._inflight and unit not in self._resident:
            trace.instant("prefetch_submit", sys="sched",
                          cls=self.trace_cls, unit=unit)
            self._inflight[unit] = self._fetch(unit)

    def touch(self, unit) -> bool:
        """Use of an already-resident unit (served by a hot cache): records a
        hit and returns True; returns False if the unit is not resident."""
        if unit not in self._resident:
            return False
        trace.instant("hot_hit", sys="sched", cls=self.trace_cls,
                      unit=unit)
        self.ws.on_hit(self.cls)
        return True

    def materialize(self, unit) -> list:
        futs = self._inflight.pop(unit, None)
        hit = futs is not None and all(f.done() for f in futs)
        if futs is None:
            futs = self._fetch(unit)
        # the scheduler-side stall: zero-length when the prefetch fully hid
        # the slow-tier latency, the whole fetch when issued on demand
        with trace.span("materialize_wait", sys="sched", attr="io_wait",
                        cls=self.trace_cls, unit=unit, hit=hit) as sp:
            vals = [f.result() for f in futs]
            nbytes = sum(int(v.nbytes) for v in vals)
            sp.set(nbytes=nbytes)
        self._resident[unit] = nbytes
        self.ws.on_materialize(nbytes, hit, self.cls)
        return vals

    def evict(self, unit) -> None:
        nbytes = self._resident.pop(unit, None)
        if nbytes is not None:
            trace.instant("evict", sys="sched", cls=self.trace_cls,
                          unit=unit, nbytes=nbytes)
            self.ws.on_evict(nbytes, self.cls)

    def run_events(self, events, *, on_materialize, on_use, on_evict=None,
                   on_prefetch=None) -> None:
        """The single interpreter of a ``LayerSchedule`` plan: I/O ops are
        handled here, ``on_materialize(unit, vals)`` receives each unit's
        fetched payloads, ``on_use(unit)`` runs the consumer's compute,
        ``on_evict(unit)`` (optional) drops consumer-side residents before
        the accounting eviction, and ``on_prefetch(unit)`` (optional) lets
        the consumer piggyback dynamic-unit prefetches (predicted expert
        rows) on the static plan's horizon."""
        for ev in events:
            if ev.op == "prefetch":
                self.prefetch(ev.unit)
                if on_prefetch is not None:
                    on_prefetch(ev.unit)
            elif ev.op == "materialize":
                on_materialize(ev.unit, self.materialize(ev.unit))
            elif ev.op == "use":
                on_use(ev.unit)
            else:
                if on_evict is not None:
                    on_evict(ev.unit)
                self.evict(ev.unit)


class ExpertPopularity:
    """Per-unit popularity EMA, fed by MoE routing counts.

    The router decides a layer's expert set only mid-layer, too late to hide
    the slow-tier fetch — so the executor prefetches the *predicted* top
    units when the layer enters the schedule horizon, and this EMA is the
    predictor. ``update(layer, load)`` folds one step's per-expert routed
    fraction in; ``top(layer, n)`` returns the n hottest expert ids.
    """

    def __init__(self, decay: float = 0.8):
        self.decay = decay
        self._ema: Dict[object, Dict[int, float]] = {}

    def update(self, layer, load: Sequence[float]) -> None:
        ema = self._ema.setdefault(layer, {})
        for e, v in enumerate(load):
            ema[e] = self.decay * ema.get(e, 0.0) + (1.0 - self.decay) * float(v)

    def score(self, layer, expert: int) -> float:
        return self._ema.get(layer, {}).get(expert, 0.0)

    def top(self, layer, n: int) -> List[int]:
        ema = self._ema.get(layer)
        if not ema:
            return []
        return sorted(ema, key=lambda e: (-ema[e], e))[:n]


class HotUnitCache:
    """Byte-budgeted LRU/popularity cache of materialized units.

    Units offered at evict time stay resident (their bytes remain in the
    ``WorkingSetManager``) until the budget forces the coldest out; a
    ``get`` hit returns the cached payload with no slow-tier traffic and
    counts as a prefetch hit. Victim choice is popularity-first (the EMA
    score at offer time) with LRU recency as the tie-breaker. Hot experts
    persist across steps — the same cache serves decode.
    """

    def __init__(self, budget_bytes: int, engine: PrefetchEngine):
        self.budget = int(budget_bytes)
        self.engine = engine
        self._payload: Dict[object, object] = {}
        self._nbytes: Dict[object, int] = {}
        self._score: Dict[object, tuple] = {}  # (popularity, recency tick)
        self._tick = 0
        self.bytes = 0

    def __contains__(self, unit) -> bool:
        return unit in self._payload

    def get(self, unit):
        """Cached payload for a resident unit (None on miss); records a hit."""
        if unit not in self._payload:
            trace.instant("hot_miss", sys="sched",
                          cls=self.engine.trace_cls, unit=unit)
            return None
        self._tick += 1
        pop, _ = self._score[unit]
        self._score[unit] = (pop, self._tick)
        self.engine.touch(unit)
        return self._payload[unit]

    def offer(self, unit, payload, nbytes: int, popularity: float = 0.0) -> bool:
        """Adopt an evict-bound unit. Returns True if it stays resident
        (the caller must then NOT evict it from the engine); on False the
        unit didn't fit and the caller evicts as usual."""
        if self.budget <= 0 or nbytes > self.budget:
            return False
        self._tick += 1
        self._payload[unit] = payload
        self._nbytes[unit] = int(nbytes)
        self._score[unit] = (float(popularity), self._tick)
        self.bytes += int(nbytes)
        kept = True
        while self.bytes > self.budget:
            victim = min(self._score, key=self._score.get)
            if victim == unit:
                kept = False
            self._drop(victim)
        return kept

    def units(self) -> List:
        return list(self._payload)

    def replace(self, unit, payload) -> None:
        """Swap a resident unit's payload in place (same bytes) — the
        executor refreshes cached rows after the optimizer writes new
        parameters, so a hot hit never serves a stale row."""
        if unit in self._payload:
            self._payload[unit] = payload

    def _drop(self, unit) -> None:
        self.bytes -= self._nbytes.pop(unit)
        del self._payload[unit], self._score[unit]
        self.engine.evict(unit)

    def clear(self) -> None:
        for unit in list(self._payload):
            self._drop(unit)


def resolve_expert_hot_bytes(expert_hot_mb: int, top_k: int,
                             expert_row_bytes: int) -> int:
    """The hot-expert cache budget. ``expert_hot_mb`` > 0 is explicit (MiB);
    0 (auto) holds the ``2 * top_k`` globally hottest expert rows — enough
    that a skewed router keeps its favorites resident across steps without
    materially moving the working-set bound. Shared by the planner's
    residency prediction and the executor so the two always agree."""
    if expert_hot_mb > 0:
        return expert_hot_mb << 20
    return 2 * max(top_k, 1) * int(expert_row_bytes)
