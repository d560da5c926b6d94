"""Overlap-centric schedule-unit scheduler (paper Sec. 6), the dense subset
of ``repro/core/schedule.py:60-330``.

Parameters live in the slow tiers and stream through a bounded window of
schedule units (one dense layer's row each), prefetched ahead of use and
evicted right after, so the device-resident working set is O(window):

  * ``LayerSchedule`` — the pure plan: an ordered event stream
    (``prefetch`` / ``materialize`` / ``use`` / ``evict``) for one pass,
    forward order or reversed for the backward;
  * ``WorkingSetManager`` — residency accounting: per-step peak resident
    bytes, prefetch hit rate, evictions;
  * ``PrefetchEngine`` — runs a plan's reads over an async fetch backend
    (``ParamStreamer.read_row`` futures).

``default_prefetch_layers`` derives the window from the paper's Sec. 3-4
model with the reference's constants, so both packages pick the same
window; ``default_kv_prefetch_blocks`` is its serving mirror, which the
planner uses for the KV read-ahead. The MoE pieces (``HotUnitCache``, ``ExpertPopularity``) wait for
ROADMAP Queue 1 item 6.
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
    metrics ``peak_resident_param_bytes``, ``prefetch_hit_rate`` and
    ``evictions``. Only scheduler-managed rows count: the small
    device-resident states are excluded by construction.
    """

    def __init__(self):
        self.current_bytes = 0
        self.begin_step()

    def begin_step(self) -> None:
        self.peak_bytes = self.current_bytes
        self.evictions = 0
        self.hits = 0
        self.misses = 0

    def on_materialize(self, nbytes: int, hit: bool) -> None:
        self.current_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.current_bytes)
        if hit:
            self.hits += 1
        else:
            self.misses += 1

    def on_evict(self, nbytes: int) -> None:
        self.current_bytes -= nbytes
        self.evictions += 1

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {"peak_resident_param_bytes": self.peak_bytes,
                "prefetch_hit_rate": self.hits / total if total else 0.0,
                "evictions": self.evictions}


class PrefetchEngine:
    """Executes a ``LayerSchedule``'s I/O against an async fetch backend.

    ``fetch(unit)`` returns a list of futures (one per rank's row).
    ``materialize`` resolves them — a *hit* only when the unit was
    prefetched earlier and every read had completed when its turn came —
    and records the bytes as resident until ``evict``.
    """

    def __init__(self, fetch: Callable[[object], list], ws: WorkingSetManager,
                 trace_cls: Optional[str] = None):
        self._fetch = fetch
        self.ws = ws
        self.trace_cls = trace_cls
        self._inflight: Dict[object, list] = {}
        self._resident: Dict[object, int] = {}  # unit -> materialized nbytes

    def prefetch(self, unit) -> None:
        if unit not in self._inflight and unit not in self._resident:
            trace.instant("prefetch_submit", sys="sched",
                          cls=self.trace_cls, unit=unit)
            self._inflight[unit] = self._fetch(unit)

    def materialize(self, unit) -> list:
        futs = self._inflight.pop(unit, None)
        hit = futs is not None and all(f.done() for f in futs)
        if futs is None:
            futs = self._fetch(unit)
        # zero-length when the prefetch hid the slow-tier latency
        with trace.span("materialize_wait", sys="sched", attr="io_wait",
                        cls=self.trace_cls, unit=unit, hit=hit) as sp:
            vals = [f.result() for f in futs]
            nbytes = sum(int(v.nbytes) for v in vals)
            sp.set(nbytes=nbytes)
        self._resident[unit] = nbytes
        self.ws.on_materialize(nbytes, hit)
        return vals

    def evict(self, unit) -> None:
        nbytes = self._resident.pop(unit, None)
        if nbytes is not None:
            trace.instant("evict", sys="sched", cls=self.trace_cls,
                          unit=unit, nbytes=nbytes)
            self.ws.on_evict(nbytes)

    def run_events(self, events, *, on_materialize, on_use, on_evict=None) -> None:
        """Interpret a plan: I/O ops here, ``on_materialize(unit, vals)``
        receives each unit's payloads, ``on_use(unit)`` runs the compute,
        ``on_evict(unit)`` drops consumer-side residents first."""
        for ev in events:
            if ev.op == "prefetch":
                self.prefetch(ev.unit)
            elif ev.op == "materialize":
                on_materialize(ev.unit, self.materialize(ev.unit))
            elif ev.op == "use":
                on_use(ev.unit)
            else:
                if on_evict is not None:
                    on_evict(ev.unit)
                self.evict(ev.unit)
