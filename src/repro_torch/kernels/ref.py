"""Plain PyTorch versions of the port's kernels (``repro/kernels/ref.py``).

Each is what the CUDA kernel computes, written with stock torch ops: the
CPU path of ``kernels/ops.py`` and the card-side reference in
``chip_smoke.py`` and the CUDA tests. Products are taken on float32
copies, so the accumulation is f32 exactly where the JAX oracles ask for
``preferred_element_type=float32``. The backward versions are written out
by hand (not autograd through the forward), so the CPU runs the same
``torch.autograd.Function`` wiring as the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.qformat import dequant_q8

NEG_INF = -1e30


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with f32 accumulation; output in x's dtype. Either
    operand may be a strided view (a transpose)."""
    return (x.float() @ w.float()).to(x.dtype)


def quantized_matmul_ref(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                         transpose: bool = False) -> torch.Tensor:
    """x (M, K) @ dequant(q, s) (K, N) -> (M, N), or with ``transpose``
    x (M, N) @ dequant(q, s)^T -> (M, K) (the dX product); f32 math, output
    in x's dtype, as the TPU kernel ``_qmm_kernel`` computes it."""
    w = dequant_q8(q, s)
    return (x.float() @ (w.T if transpose else w)).to(x.dtype)


def visible(Sq: int, Sk: int, causal: bool, window: int, device) -> torch.Tensor:
    """(Sq, Sk) bool, aligned at the end: query i sees key j iff, under
    ``causal``, j <= i + (Sk - Sq) and, with ``window`` > 0 (causal or
    not), j > i + (Sk - Sq) - window (``repro/models/common.py:164-167``
    with the query's position i + (Sk - Sq)). ``window`` 0 is global."""
    m = torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        m = m.tril(Sk - Sq)
    if window > 0:
        m = m.triu(Sk - Sq - window + 1)
    return m


def _scores(q, k, causal, window=0):
    """f32 scaled scores (B,H,Sq,Sk), masked keys at -1e30; k already
    repeated to H heads."""
    D, Sq, Sk = q.shape[-1], q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (D ** -0.5)
    if causal or window > 0:
        s = torch.where(visible(Sq, Sk, causal, window, q.device), s,
                        torch.full_like(s, NEG_INF))
    return s


def attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0):
    """q: (B,H,Sq,D), k/v: (B,KV,Sk,D) -> (out (B,H,Sq,D) in q's dtype,
    lse (B,H,Sq) f32), lse the log-sum-exp of each row's scaled scores.

    Query head h reads kv head h // (H // KV) (``repeat_interleave``, not
    tiling). The masks are aligned at the end (``visible``): under causal
    query i sees key j iff j <= i + (Sk - Sq), so the last query sees the
    last key, and a ``window`` > 0 also hides keys j <= i + (Sk - Sq) -
    window. p is rounded to v's dtype before the P@V product, as the TPU
    kernel does.
    """
    n_rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(n_rep, dim=1)
    v = v.repeat_interleave(n_rep, dim=1)
    s = _scores(q, k, causal, window)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """The forward's output alone (see ``attention_fwd_ref``)."""
    return attention_fwd_ref(q, k, v, causal=causal, window=window)[0]


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: int = 0):
    """Gradients (dq, dk, dv) of ``attention_fwd_ref``'s output, each in
    its input's dtype, from the saved output ``o`` and ``lse``:

        p  = exp(s - lse)                  (the forward's softmax, f32)
        dv = sum over the group's heads of p_r^T @ do, p_r = p in v's dtype
        dp = do @ v^T,  delta = rowsum(do * o)
        ds = p * (dp - delta)
        dq = scale * ds @ k,  dk = scale * sum over the group of ds^T @ q
    """
    B, H, Sq, D = q.shape
    KV = k.shape[1]
    n_rep = H // KV
    scale = D ** -0.5
    kr = k.repeat_interleave(n_rep, dim=1).float()
    vr = v.repeat_interleave(n_rep, dim=1).float()
    s = _scores(q, kr, causal, window)
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(v.dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    # GQA: the n_rep query heads of a group sum into their KV head
    dk = dk.reshape(B, KV, n_rep, *dk.shape[2:]).sum(2)
    dv = dv.reshape(B, KV, n_rep, *dv.shape[2:]).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# index of each scalar in the fused-Adam scalar vector (the Pallas SMEM operand)
ADAM_SCALARS = ("lr", "b1", "b2", "eps", "wd", "c1", "c2")


def adam_ref(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
             scalars: torch.Tensor) -> torch.Tensor:
    """AdamW with decay inside lr, ``scalars`` = (7,) f32
    ``[lr, b1, b2, eps, wd, c1, c2]``; all arrays f32 of one shape.

    Updates p, m and v IN PLACE and returns p's bf16 copy. Each operation
    rounds in f32 in the order the TPU kernel writes it (no fused
    multiply-add), so the CUDA kernel repeats it bit for bit.
    """
    lr, b1, b2, eps, wd, c1, c2 = scalars.unbind()
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * g * g
    mh = m_new / c1
    vh = v_new / c2
    p_new = p - lr * (mh / (torch.sqrt(vh) + eps) + wd * p)
    m.copy_(m_new)
    v.copy_(v_new)
    p.copy_(p_new)
    return p.to(torch.bfloat16)
