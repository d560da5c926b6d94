"""The single-process straggler action (``repro/runtime/elastic.py:245``)
and the dp-dependent layout adaptation a checkpoint restore runs
(``repro/runtime/elastic.py:267-297``).

The elastic supervisor, chaos injection and cluster membership wait for
ROADMAP.md Queue 1 item 5 (its second part: the elastic runtime).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def _repad_last(t: torch.Tensor, width: int) -> torch.Tensor:
    """Grow or shrink the last axis to ``width``. Only the zero pad region
    is ever cut (flat rows are padded to a dp multiple past the logical
    parameter count), so this is lossless across dp degrees."""
    cur = t.shape[-1]
    if cur == width:
        return t
    if cur > width:
        return t[..., :width].contiguous()
    return F.pad(t, (0, width - cur))


def adapt_state_layout(tree, executor):
    """Re-pad the dp-dependent leaves of a (host) state or portable tree to
    ``executor``'s layout. The explicit engine pads each per-layer flat
    row to a multiple of dp, so a checkpoint written at another dp degree
    re-pads here; the GSPMD engine's leaves are logical shapes and pass
    through untouched."""
    if not getattr(executor, "explicit", False) or not isinstance(tree, dict):
        return tree
    out = dict(tree)
    padded = executor.engine.layout.padded
    for k in ("flat", "master", "m", "v"):
        v = out.get(k)
        if isinstance(v, torch.Tensor) and v.dim() >= 1:
            out[k] = _repad_last(v, padded)
    if executor.is_moe and isinstance(out.get("eflat"), torch.Tensor):
        out["eflat"] = _repad_last(out["eflat"], executor.engine.elayout.padded)
    return out
