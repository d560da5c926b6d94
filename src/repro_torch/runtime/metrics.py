"""Step metrics, ported from ``repro/runtime/metrics.py``: the training
``MetricsLogger`` (tokens/s, step-time EMA, analytic MFU) and the
serving-side KV-tier counters (``kv_*``). The elastic metrics wait for the
elastic runtime (ROADMAP.md Queue 1 item 5)."""
from __future__ import annotations

from typing import Optional

# dense bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet), the
# MFU denominator on the card the port targets
H100_BF16_PEAK_FLOPS = 989e12


class MetricsLogger:
    def __init__(self, model_flops_per_token: float = 0.0,
                 peak_flops: float = H100_BF16_PEAK_FLOPS, n_chips: int = 1,
                 log_fn=print):
        self.fpt = model_flops_per_token
        self.peak = peak_flops * n_chips
        self.log_fn = log_fn
        self.ema: Optional[float] = None
        self.history = []

    def log(self, step: int, loss: float, tokens: int, dt: float, **kw) -> dict:
        """Record one step (``mfu_est`` = 6 * params * tokens/s / peak) and
        print its line."""
        self.ema = dt if self.ema is None else 0.9 * self.ema + 0.1 * dt
        tps = tokens / dt if dt > 0 else 0.0
        mfu = 6.0 * self.fpt * tps / self.peak if self.fpt else 0.0
        rec = {"step": step, "loss": float(loss), "tokens_per_s": tps,
               "step_time": dt, "step_time_ema": self.ema, "mfu_est": mfu, **kw}
        self.history.append(rec)
        self.log_fn(
            f"step {step:5d} | loss {loss:8.4f} | {tps:9.0f} tok/s | "
            f"{dt*1e3:7.1f} ms" + (f" | {k}" if (k := kw.get('note')) else ""))
        return rec


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
    the tier link — smaller under ``--kv-quant``, identical otherwise."""
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
