"""Plain PyTorch versions of the port's kernels (``repro/kernels/ref.py``).

Each is what the CUDA kernel computes, written with stock torch ops: the
CPU path of ``kernels/ops.py`` and the card-side reference in
``chip_smoke.py`` and the CUDA tests. Products are taken on float32
copies, so the accumulation is f32 exactly where the JAX oracles ask for
``preferred_element_type=float32``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with f32 accumulation; output in x's dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (B,H,Sq,D), k/v: (B,KV,Sk,D) -> (B,H,Sq,D). fp32 softmax.

    Query head h reads kv head h // (H // KV) (``repeat_interleave``, not
    tiling). The causal mask is aligned at the end: query i sees key j iff
    j <= i + (Sk - Sq), so the last query sees the last key.
    """
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    n_rep = H // KV
    k = k.repeat_interleave(n_rep, dim=1)
    v = v.repeat_interleave(n_rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (D ** -0.5)
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(Sk - Sq)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
