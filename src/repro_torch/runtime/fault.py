"""Fault tolerance and straggler detection for the training loop
(``repro/runtime/fault.py``, the same policies and environment variables).

The failure model: a process dies (the step raises or hangs), a device
throws, or a host straggles (slow NVMe, thermal throttle, network).
Policies, held by tests/test_torch_fault.py:

  * ``FailureInjector``  — deterministic fault injection (env/step-driven)
    so restart paths are *tested*, not assumed.
  * ``retry_loop``       — supervision: on failure, restore latest
    checkpoint and resume; bounded restarts; jittered exponential backoff
    under a wall-clock recovery budget (``RecoveryBudgetExceeded``).
  * ``StragglerMonitor`` — per-step wall-time EMA + MAD outlier detection.
    Single-process action = log & count; the multi-host action (re-shard
    data away from the slow host / preempt to spares) plugs into
    ``on_straggler``.
"""
from __future__ import annotations

import os
import random
import time
from typing import Callable, Dict, List, Optional


class SimulatedFailure(RuntimeError):
    pass


class RecoveryBudgetExceeded(RuntimeError):
    """Cumulative recovery wall time blew the configured budget. NOT a
    ``SimulatedFailure``: supervision must stop retrying, not absorb it."""


class FailureInjector:
    """Raise at a target step, once. Configure via ctor or env:
    REPRO_FAIL_AT_STEP=N (and optional REPRO_FAIL_MARKER=<path> so the
    failure fires only in the first process incarnation). With ``rank``
    (a rank of a mesh) the marker is the rank's own, ``<path>.rank<r>``:
    every rank fails at the step and restarts, where one marker shared by
    the ranks would let the first to fail stop the others from failing
    (they would run on into the step's collectives, alone)."""

    def __init__(self, fail_at_step: Optional[int] = None, marker: Optional[str] = None,
                 rank: Optional[int] = None):
        env = os.environ.get("REPRO_FAIL_AT_STEP")
        self.fail_at = fail_at_step if fail_at_step is not None else (
            int(env) if env else None)
        self.marker = marker or os.environ.get("REPRO_FAIL_MARKER")
        if self.marker and rank is not None:
            self.marker = f"{self.marker}.rank{rank}"

    def maybe_fail(self, step: int) -> None:
        if self.fail_at is None or step != self.fail_at:
            return
        if self.marker:
            if os.path.exists(self.marker):
                return  # already failed once in a previous incarnation
            with open(self.marker, "w") as f:
                f.write(str(step))
        raise SimulatedFailure(f"injected failure at step {step}")


class StragglerMonitor:
    def __init__(self, factor: float = 3.0, warmup: int = 5):
        self.factor = factor
        self.warmup = warmup
        self.times: List[float] = []
        self.flagged: List[int] = []
        self._t0: Optional[float] = None
        self.on_straggler: Optional[Callable[[int, float, float], None]] = None
        # last observed dt / median ratio, for the step-metric surface
        self.last_slowdown: float = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        dt = time.perf_counter() - self._t0
        self._record(step, dt)
        return dt

    def median(self) -> Optional[float]:
        if not self.times:
            return None
        s = sorted(self.times)
        return s[len(s) // 2]

    def observe(self, step: int, dt: float) -> bool:
        """Offline-feed variant (unit tests / simulated timings)."""
        return self._record(step, dt)

    def _record(self, step: int, dt: float) -> bool:
        baseline = self.median()
        self.last_slowdown = dt / baseline if baseline else 0.0
        flag = bool(len(self.times) >= self.warmup and baseline
                    and dt > self.factor * baseline)
        if flag:
            self.flagged.append(step)
            if self.on_straggler:
                self.on_straggler(step, dt, baseline)
        self.times.append(dt)
        return flag

    def step_metrics(self) -> Dict[str, float]:
        """Per-step metric fields: cumulative flagged count + the latest
        step's slowdown ratio vs the running median."""
        return {"straggler_flagged": len(self.flagged),
                "straggler_slowdown": round(self.last_slowdown, 3)}


def retry_loop(run_once: Callable[[], None], *, max_restarts: int = 3,
               backoff_s: float = 0.1, jitter: float = 0.25,
               recovery_budget_s: Optional[float] = None, seed: int = 0,
               on_restart: Optional[Callable[[int, BaseException], None]] = None,
               stats: Optional[Dict[str, float]] = None) -> int:
    """Supervise ``run_once``; restart on failure. Returns restart count.

    ``jitter`` decorrelates herd restarts: each backoff is scaled by a
    uniform ``1 + [0, jitter)`` factor (deterministic per ``seed`` so tests
    stay reproducible). ``recovery_budget_s`` bounds the cumulative wall
    clock spent recovering — backoff sleeps plus re-attempts that fail
    again — raising ``RecoveryBudgetExceeded`` when blown. ``stats`` (a
    caller-supplied dict) is updated *live* with ``restarts`` and
    ``recovery_s``, so the running ``run_once`` closure can surface them
    in its step metrics.
    """
    rng = random.Random(seed)
    restarts = 0
    recovery = 0.0
    if stats is not None:
        stats.update(restarts=0, recovery_s=0.0)
    while True:
        t0 = time.perf_counter()
        try:
            run_once()
            return restarts
        except SimulatedFailure as e:
            if restarts > 0:
                # a recovery attempt that failed again is recovery time too
                recovery += time.perf_counter() - t0
            restarts += 1
            if restarts > max_restarts:
                raise
            if recovery_budget_s is not None and recovery >= recovery_budget_s:
                raise RecoveryBudgetExceeded(
                    f"{recovery:.2f}s cumulative recovery exceeds the "
                    f"{recovery_budget_s:.0f}s budget after {restarts - 1} "
                    "restarts") from e
            if on_restart:
                on_restart(restarts, e)
            delay = (backoff_s * (2 ** (restarts - 1))
                     * (1.0 + jitter * rng.random()))
            if recovery_budget_s is not None:
                delay = min(delay, max(0.0, recovery_budget_s - recovery))
            time.sleep(delay)
            recovery += delay
            if stats is not None:
                stats.update(restarts=restarts, recovery_s=recovery)
