"""Serving-side KV-tier step metrics (the ``kv_*`` fields), ported from
``repro/runtime/metrics.py``. The training-side ``MetricsLogger`` and the
elastic metrics wait for the training slice."""
from __future__ import annotations


def kv_step_metrics(delta: dict, resident_bytes: int) -> dict:
    """Per-step KV-tier metrics for the serving loop, named like the
    training executor's per-tier counters (``param_in_*`` / ``grad_out_*``).

    ``delta`` is an ``ArrayStore.delta_since(mark)`` dict for the KV store:
    reads are blocks streaming *in* to refill a decode slot (admission),
    writes are sequences parked *out* to the slow tier. ``resident_bytes``
    is the device-resident slot-cache footprint. All values are per-step
    deltas, never cumulative.

    ``kv_in_bytes`` / ``kv_out_bytes`` are *logical* bytes (the decoded
    blocks the cache moved); ``kv_*_wire_bytes`` is what actually crossed
    the tier link — identical until a quantized wire format is ported."""
    wire_r = int(delta.get("bytes_read", 0))
    wire_w = int(delta.get("bytes_written", 0))
    return {
        "kv_resident_bytes": int(resident_bytes),
        "kv_in_bytes": int(delta.get("logical_bytes_read", wire_r)),
        "kv_out_bytes": int(delta.get("logical_bytes_written", wire_w)),
        "kv_in_wire_bytes": wire_r,
        "kv_out_wire_bytes": wire_w,
        "kv_in_gbps": float(delta.get("read_gbps", 0.0)),
        "kv_out_gbps": float(delta.get("write_gbps", 0.0)),
    }
