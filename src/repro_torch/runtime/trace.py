"""Span-level tracing + per-step stall attribution (the observability layer).

A pure-Python copy of ``repro/runtime/trace.py`` for the PyTorch port.

ZeRO-Infinity's whole value proposition (paper Sec. 4) is that slow-tier
I/O *overlaps* compute; when a run lands below the planner's predicted
Eq.-6 efficiency, the gap has to be attributable — NVMe read stalls?
grad-drain backpressure? expert-cache misses? This module is the
measurement side of that question:

  * ``Tracer`` — a low-overhead, thread-safe span/counter recorder. Spans
    are ring-buffered (a bounded ``deque``; old spans fall off, matched
    B/E pairs are emitted per complete span at export so eviction never
    unbalances the stream) and the disabled path is ~zero cost: ``span()``
    returns one shared no-op singleton, no allocation, no lock.
  * span taxonomy — every span carries a ``sys`` subsystem tag (``sched``
    scheduler prefetch, ``store`` tier I/O, ``compute`` jitted pieces,
    ``optim`` optimizer write-back, ``kv`` serving cache, ``serve`` the
    decode loop, ``elastic`` recovery: re-plan / re-shard / resume spans
    and straggler flags) plus optional ``cls`` (state class: param/grad/opt/
    expert/kv), ``unit`` (schedule unit), and free-form args (logical and
    wire byte counts for store I/O).
  * attribution — main-thread spans additionally carry ``attr``:
    ``"compute"`` (device/CPU work on the critical path) or ``"io_wait"``
    (the thread blocked on a slow-tier future). ``attribute_window``
    partitions a step's wall time into ``compute_s`` + per-class
    ``io_wait_s`` + ``other_s`` (exact by construction: categories are
    interval unions with cross-category overlap subtracted), and derives
    ``overlap_frac`` — the fraction of worker-thread I/O busy time hidden
    under compute — and the Eq.-6-style measured efficiency
    ``compute_s / (compute_s + io_wait_s)`` to print beside the plan's
    prediction.
  * exports — Chrome/Perfetto trace-event JSON (``export_chrome``: one
    track per thread with matched B/E pairs, one counter track per class
    with cumulative wire bytes) and a compact text stall report
    (``format_report``: top stall sources, per-tier busy/idle, measured
    vs predicted efficiency).

Usage::

    from repro_torch.runtime import trace
    trace.enable()
    with trace.span("nvme_read", sys="store", cls="param", nbytes=n):
        ...
    trace.export_chrome("out.json")
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# Subsystem tags (the ``sys=`` span arg). Kept as a tuple so gates can
# report coverage ("spans from >= 4 distinct subsystems") by one name.
SUBSYSTEMS = ("sched", "store", "compute", "optim", "kv", "serve", "elastic")


class _NoopSpan:
    """Shared do-nothing context manager — the disabled fast path returns
    this singleton, so a disabled ``span()`` call allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw) -> None:
        pass


_NOOP = _NoopSpan()


class _Span:
    """One live span: records t0/seq at entry, appends a complete record to
    the tracer's ring buffer at exit. ``set(**kw)`` attaches args that are
    only known mid-span (bytes read, hit/miss)."""

    __slots__ = ("_tr", "name", "sys", "cls", "attr", "unit", "args",
                 "_t0", "_s0")

    def __init__(self, tracer: "Tracer", name: str, sys_: Optional[str],
                 cls: Optional[str], attr: Optional[str], unit, args: dict):
        self._tr = tracer
        self.name = name
        self.sys = sys_
        self.cls = cls
        self.attr = attr
        self.unit = unit
        self.args = args

    def __enter__(self):
        self._s0 = next(self._tr._seq)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tr = self._tr
        th = threading.current_thread()
        tr._buf.append((self.name, self.sys, self.cls, self.attr, self.unit,
                        self._t0, t1, self._s0, next(tr._seq),
                        th.ident, th.name, self.args))
        return False

    def set(self, **kw) -> None:
        self.args.update(kw)


class Tracer:
    """Ring-buffered span/instant recorder. Thread safety: appends go to a
    bounded ``collections.deque`` (atomic under the GIL — no lock on the
    hot path); the monotonic sequence counter is an ``itertools.count``
    (likewise atomic). ``events()`` snapshots the buffer."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = int(capacity)
        self._buf: deque = deque(maxlen=self.capacity)
        self._seq = itertools.count()
        self._enabled = False
        self._t_origin = time.perf_counter()

    # -- lifecycle ----------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, capacity: Optional[int] = None) -> None:
        if capacity is not None and capacity != self.capacity:
            self.capacity = int(capacity)
            self._buf = deque(self._buf, maxlen=self.capacity)
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def clear(self) -> None:
        self._buf.clear()

    # -- recording ----------------------------------------------------------

    def span(self, name: str, *, sys: Optional[str] = None,
             cls: Optional[str] = None, attr: Optional[str] = None,
             unit=None, **args):
        """Context manager timing one operation. No-op singleton (zero
        allocation) when disabled."""
        if not self._enabled:
            return _NOOP
        return _Span(self, name, sys, cls, attr, unit, args)

    def instant(self, name: str, *, sys: Optional[str] = None,
                cls: Optional[str] = None, unit=None, **args) -> None:
        """Zero-duration marker event (Chrome ``i`` phase)."""
        if not self._enabled:
            return
        t = time.perf_counter()
        th = threading.current_thread()
        s = next(self._seq)
        self._buf.append((name, sys, cls, None, unit, t, t, s, s,
                          th.ident, th.name, args))

    def wrap(self, name: str, fn: Callable, *, sys: str = "compute",
             attr: Optional[str] = "compute", cls: Optional[str] = None
             ) -> Callable:
        """Wrap a callable so each invocation is a span. The disabled path
        is one attribute check on top of the call."""

        def traced(*a, **kw):
            if not self._enabled:
                return fn(*a, **kw)
            with self.span(name, sys=sys, attr=attr, cls=cls):
                return fn(*a, **kw)

        traced.__name__ = getattr(fn, "__name__", name)
        return traced

    # -- views --------------------------------------------------------------

    def events(self) -> List[tuple]:
        """Snapshot of the ring buffer (oldest first). Each record:
        (name, sys, cls, attr, unit, t0, t1, seq0, seq1, tid, tname, args).
        """
        return list(self._buf)

    def span_names(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self._buf:
            out[ev[0]] = out.get(ev[0], 0) + 1
        return out

    def subsystems(self) -> List[str]:
        """Distinct ``sys`` tags present in the buffer, SUBSYSTEMS order."""
        seen = {ev[1] for ev in self._buf if ev[1]}
        return [s for s in SUBSYSTEMS if s in seen] + sorted(
            s for s in seen if s not in SUBSYSTEMS)

    # -- Chrome/Perfetto export ---------------------------------------------

    def chrome_events(self) -> List[dict]:
        """The trace-event list: per-thread B/E span pairs (emitted from
        complete records, so pairs are always matched even after ring
        eviction) plus one cumulative-bytes counter track per class."""
        events = self.events()
        out: List[Tuple[int, dict]] = []
        t0 = self._t_origin
        tids: Dict[int, str] = {}
        for name, sys_, cls, attr, unit, a, b, s0, s1, tid, tname, args in \
                events:
            tids.setdefault(tid, tname)
            ev_args = {}
            if sys_:
                ev_args["sys"] = sys_
            if cls:
                ev_args["cls"] = cls
            if attr:
                ev_args["attr"] = attr
            if unit is not None:
                ev_args["unit"] = str(unit)
            for k, v in args.items():
                ev_args[k] = v if isinstance(v, (int, float, str, bool)) \
                    else str(v)
            us0 = (a - t0) * 1e6
            if a == b and s0 == s1:  # instant
                out.append((s0, {"name": name, "ph": "i", "ts": us0,
                                 "pid": 1, "tid": tid, "s": "t",
                                 "args": ev_args}))
                continue
            out.append((s0, {"name": name, "ph": "B", "ts": us0, "pid": 1,
                             "tid": tid, "args": ev_args}))
            out.append((s1, {"name": name, "ph": "E", "ts": (b - t0) * 1e6,
                             "pid": 1, "tid": tid}))
        # per-class counter tracks: cumulative wire bytes moved per class
        per_cls_total: Dict[str, float] = {}
        for name, sys_, cls, attr, unit, a, b, s0, s1, tid, tname, args in \
                events:
            nbytes = args.get("wire_bytes", args.get("nbytes"))
            if cls is None or nbytes is None:
                continue
            per_cls_total[cls] = per_cls_total.get(cls, 0.0) + float(nbytes)
            out.append((s1, {"name": f"{cls}_wire_bytes", "ph": "C",
                             "ts": (b - t0) * 1e6, "pid": 2,
                             "args": {"bytes": per_cls_total[cls]}}))
        # metadata: thread + process names so tracks are labelled
        meta = [{"name": "process_name", "ph": "M", "pid": 1,
                 "args": {"name": "repro"}},
                {"name": "process_name", "ph": "M", "pid": 2,
                 "args": {"name": "class_counters"}}]
        meta.extend({"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                     "args": {"name": tname}} for tid, tname in tids.items())
        out.sort(key=lambda p: p[0])  # seq order == per-track time order
        return meta + [e for _, e in out]

    def export_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events(),
                       "displayTimeUnit": "ms"}, f)

    # -- stall attribution --------------------------------------------------

    def attribute_window(self, t0: float, t1: float,
                         main_tid: Optional[int] = None) -> dict:
        """Partition the wall time of ``[t0, t1]`` into stall-attribution
        buckets from the recorded spans; see ``attribute_events``."""
        if main_tid is None:
            main_tid = threading.get_ident()
        return attribute_events(self.events(), t0, t1, main_tid)


# ---------------------------------------------------------------------------
# interval arithmetic + the attribution function (pure; unit-testable)
# ---------------------------------------------------------------------------


def _merge(ivs: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Union of intervals as a sorted, disjoint list."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        elif b > a:
            out.append((a, b))
    return out


def _total(ivs: List[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in ivs)


def _subtract(ivs, minus) -> List[Tuple[float, float]]:
    """``ivs`` minus ``minus`` (both disjoint-sorted)."""
    out = []
    for a, b in ivs:
        cur = a
        for ma, mb in minus:
            if mb <= cur or ma >= b:
                continue
            if ma > cur:
                out.append((cur, ma))
            cur = max(cur, mb)
            if cur >= b:
                break
        if cur < b:
            out.append((cur, b))
    return out


def _intersect(x, y) -> List[Tuple[float, float]]:
    out = []
    for a, b in x:
        for c, d in y:
            lo, hi = max(a, c), min(b, d)
            if hi > lo:
                out.append((lo, hi))
    return _merge(out)


def _clip(ivs, t0, t1):
    return [(max(a, t0), min(b, t1)) for a, b in ivs
            if min(b, t1) > max(a, t0)]


def attribute_events(events: Sequence[tuple], t0: float, t1: float,
                     main_tid: int) -> dict:
    """Per-step stall attribution over span records in ``[t0, t1]``.

    Main-thread spans tagged ``attr="compute"`` / ``attr="io_wait"``
    partition the step's critical path; worker-thread spans tagged
    ``attr="io"`` measure per-class tier busy time. Buckets are interval
    unions with cross-category overlap charged to the *innermost* wait
    (io_wait wins over an enclosing compute span), so

        compute_s + sum(io_wait_s per class) + other_s == wall  (exactly)

    and the attributed *fractions* always sum to 1. Also derived:
    ``io_busy_s``/``io_overlapped_s`` per class (worker time under the
    compute union), ``overlap_frac``, and the Eq.-6-style
    ``measured_efficiency = compute_s / (compute_s + io_wait_s)``.
    """
    wall = max(t1 - t0, 0.0)
    compute_iv: List[Tuple[float, float]] = []
    wait_iv: Dict[str, List[Tuple[float, float]]] = {}
    busy_iv: Dict[str, List[Tuple[float, float]]] = {}
    for name, sys_, cls, attr, unit, a, b, s0, s1, tid, tname, args in events:
        if b <= t0 or a >= t1 or attr is None:
            continue
        if tid == main_tid:
            if attr == "compute":
                compute_iv.append((a, b))
            elif attr == "io_wait":
                wait_iv.setdefault(cls or "other", []).append((a, b))
        elif attr == "io":
            busy_iv.setdefault(cls or "other", []).append((a, b))

    compute_u = _merge(_clip(compute_iv, t0, t1))
    # the innermost wait wins: subtract every io_wait union from compute,
    # and earlier classes from later ones so classes never double-count
    waits_u: Dict[str, List[Tuple[float, float]]] = {}
    claimed: List[Tuple[float, float]] = []
    for cls in sorted(wait_iv):
        u = _subtract(_merge(_clip(wait_iv[cls], t0, t1)), claimed)
        waits_u[cls] = u
        claimed = _merge(claimed + u)
    compute_u = _subtract(compute_u, claimed)

    compute_s = _total(compute_u)
    io_wait = {cls: _total(u) for cls, u in waits_u.items()}
    io_wait_s = sum(io_wait.values())
    other_s = max(wall - compute_s - io_wait_s, 0.0)

    io_busy, io_over = {}, {}
    for cls, ivs in busy_iv.items():
        u = _merge(_clip(ivs, t0, t1))
        io_busy[cls] = _total(u)
        io_over[cls] = _total(_intersect(u, compute_u))
    busy_total = sum(io_busy.values())
    over_total = sum(io_over.values())

    denom = max(compute_s + io_wait_s, 1e-12)
    return {
        "wall_s": wall,
        "compute_s": compute_s,
        "io_wait_s": io_wait_s,
        "io_wait_by_cls": io_wait,
        "other_s": other_s,
        "io_busy_by_cls": io_busy,
        "io_overlapped_by_cls": io_over,
        "overlap_frac": over_total / busy_total if busy_total else 0.0,
        "measured_efficiency": compute_s / denom if wall else 0.0,
        "attr_frac_sum": ((compute_s + io_wait_s + other_s) / wall
                          if wall else 1.0),
    }


def flatten_attribution(att: dict, prefix: str = "trace_") -> dict:
    """Attribution dict -> flat step-metric keys (floats only)."""
    out = {
        f"{prefix}wall_s": att["wall_s"],
        f"{prefix}compute_s": att["compute_s"],
        f"{prefix}io_wait_s": att["io_wait_s"],
        f"{prefix}other_s": att["other_s"],
        f"{prefix}overlap_frac": att["overlap_frac"],
        f"{prefix}measured_efficiency": att["measured_efficiency"],
        f"{prefix}attr_frac_sum": att["attr_frac_sum"],
    }
    for cls, v in att["io_wait_by_cls"].items():
        out[f"{prefix}io_wait_{cls}_s"] = v
    for cls, v in att["io_busy_by_cls"].items():
        out[f"{prefix}io_busy_{cls}_s"] = v
    return out


# ---------------------------------------------------------------------------
# the compact text report
# ---------------------------------------------------------------------------


def format_report(attributions: Sequence[dict],
                  predictions: Optional[dict] = None,
                  tracer: Optional["Tracer"] = None) -> str:
    """Human-readable stall report over per-step attribution dicts: top
    stall sources, per-tier busy/idle, and the measured-vs-predicted
    efficiency table (``predictions`` = ``InfinityPlan.predictions``)."""
    atts = [a for a in attributions if a.get("wall_s", 0) > 0]
    lines = ["== trace report =="]
    if not atts:
        lines.append("(no attributed steps recorded)")
        return "\n".join(lines)
    wall = sum(a["wall_s"] for a in atts)
    compute = sum(a["compute_s"] for a in atts)
    wait = sum(a["io_wait_s"] for a in atts)
    other = sum(a["other_s"] for a in atts)
    lines.append(
        f"steps: {len(atts)}  wall {wall * 1e3:.1f} ms = "
        f"compute {compute * 1e3:.1f} ms ({compute / wall:.1%}) + "
        f"io_wait {wait * 1e3:.1f} ms ({wait / wall:.1%}) + "
        f"other {other * 1e3:.1f} ms ({other / wall:.1%})")

    # top stall sources: per-class io_wait, descending
    stall: Dict[str, float] = {}
    busy: Dict[str, float] = {}
    over: Dict[str, float] = {}
    for a in atts:
        for cls, v in a["io_wait_by_cls"].items():
            stall[cls] = stall.get(cls, 0.0) + v
        for cls, v in a["io_busy_by_cls"].items():
            busy[cls] = busy.get(cls, 0.0) + v
        for cls, v in a["io_overlapped_by_cls"].items():
            over[cls] = over.get(cls, 0.0) + v
    lines.append("top stall sources (io_wait on the critical path):")
    if stall:
        for cls in sorted(stall, key=stall.get, reverse=True):
            lines.append(f"  {cls:>8s}: {stall[cls] * 1e3:8.1f} ms "
                         f"({stall[cls] / wall:6.1%} of wall)")
    else:
        lines.append("  (none — no critical-path io_wait recorded)")
    lines.append("per-class tier busy/idle (worker I/O vs step wall):")
    if busy:
        for cls in sorted(busy, key=busy.get, reverse=True):
            hid = over.get(cls, 0.0)
            lines.append(
                f"  {cls:>8s}: busy {busy[cls] * 1e3:8.1f} ms "
                f"({min(busy[cls] / wall, 1.0):6.1%} duty) | "
                f"{hid * 1e3:8.1f} ms overlapped with compute "
                f"({hid / busy[cls] if busy[cls] else 0.0:6.1%})")
    else:
        lines.append("  (no worker-thread I/O spans recorded)")

    meff = compute / max(compute + wait, 1e-12)
    lines.append("efficiency (measured vs predicted Eq. 6):")
    lines.append(f"  measured : {meff:.3f}  "
                 f"(compute / (compute + io_wait), overlap_frac "
                 f"{sum(over.values()) / max(sum(busy.values()), 1e-12):.3f})")
    if predictions:
        if "efficiency" in predictions:
            lines.append(f"  predicted: {predictions['efficiency']:.3f}  "
                         f"(plan Eq. 6, min over offloaded classes)")
        for cls in ("param", "grad", "opt", "act"):
            k = f"{cls}_efficiency"
            if k in predictions:
                lines.append(f"    {cls:>6s} predicted {predictions[k]:.3f}"
                             + (f" | measured io_wait {stall.get(cls, 0.0) * 1e3:.1f} ms"
                                if cls in stall else ""))
    else:
        lines.append("  predicted: n/a (no plan attached to this run)")
    if tracer is not None:
        lines.append("subsystems traced: " + ", ".join(tracer.subsystems()))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# module-level default tracer + functional API
# ---------------------------------------------------------------------------

TRACER = Tracer()


def span(name: str, **kw):
    return TRACER.span(name, **kw)


def instant(name: str, **kw) -> None:
    TRACER.instant(name, **kw)


def wrap(name: str, fn: Callable, **kw) -> Callable:
    return TRACER.wrap(name, fn, **kw)


def enabled() -> bool:
    return TRACER.enabled


def enable(capacity: Optional[int] = None) -> None:
    TRACER.enable(capacity)


def disable() -> None:
    TRACER.disable()


def clear() -> None:
    TRACER.clear()


def export_chrome(path: str) -> None:
    TRACER.export_chrome(path)
