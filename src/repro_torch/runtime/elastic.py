"""The single-process straggler action (``repro/runtime/elastic.py:245``).

Only ``wire_straggler`` is ported: the elastic supervisor, chaos
injection and cluster membership wait for ROADMAP.md Queue 1 item 5
(second part: the elastic runtime).
"""
from __future__ import annotations

from repro_torch.runtime import trace
from repro_torch.runtime.fault import StragglerMonitor


def wire_straggler(monitor: StragglerMonitor, log=print) -> StragglerMonitor:
    """Install the single-process straggler action: log the outlier and
    record a ``sys=elastic`` span (step and slowdown in its args) so a
    flagged step shows beside the recovery spans in the trace."""

    def action(step: int, dt: float, baseline: float) -> None:
        slowdown = dt / baseline if baseline else 0.0
        with trace.span("straggler", sys="elastic", cls="straggler",
                        step=step, slowdown=round(slowdown, 2)):
            log(f"straggler: step {step} took {dt * 1e3:.1f} ms "
                f"({slowdown:.1f}x the median {baseline * 1e3:.1f} ms)")

    monitor.on_straggler = action
    return monitor
