"""Public kernel entry points, dispatched by the tensors' device.

A CPU tensor goes to the plain PyTorch version in ``kernels/ref.py``; a
CUDA tensor goes to the hand-written kernel, which launches or raises —
there is no fallback from the card to the plain version. Any other device
raises. Each kernel counts its launches (``launch_counts``), so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import tiled_matmul as _mm


def _device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {dev}")
    return dev


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,H,Sq,D), k/v: (B,KV,Sk,D) -> (B,H,Sq,D); causal alignment
    ``k <= q + (Sk - Sq)`` as in the TPU kernel."""
    dev = _device(q, k, v)
    _fa.check_inputs(q, k, v, causal)
    if dev.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    return _fa.flash_attention_cuda(q, k, v, causal=causal)


def tiled_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M,K) @ w: (K,N) -> (M,N) in x's dtype, f32 accumulation."""
    dev = _device(x, w)
    _mm.check_inputs(x, w)
    if dev.type == "cpu":
        return ref.matmul_ref(x, w)
    return _mm.tiled_matmul_cuda(x, w)


def launch_counts() -> dict:
    """Kernel launches so far in this process, by kernel."""
    return {"flash_attention": _fa.launches, "tiled_matmul": _mm.launches}


def reset_launch_counts() -> None:
    _fa.launches = 0
    _mm.launches = 0
