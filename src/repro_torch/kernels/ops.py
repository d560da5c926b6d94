"""Public kernel entry points, dispatched by the tensors' device.

A CPU tensor goes to the plain PyTorch version in ``kernels/ref.py``; a
CUDA tensor goes to the hand-written kernel, which launches or raises —
there is no fallback from the card to the plain version. Any other device
raises. Each kernel counts its launches (``launch_counts``), so a run can
show that its main path went through the kernels.

Flash attention, the tiled matmul and the quantized matmul are
differentiable: where autograd records (grad mode on and an input that
requires grad) the call goes through a ``torch.autograd.Function`` whose
backward dispatches the same way — the backward kernels on the card, the
plain backward written out in ``kernels/ref.py`` on the CPU. Elsewhere
(serving under ``no_grad``) the forward runs alone and saves nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_adam as _ad
from repro_torch.kernels import quantized_matmul as _qmm
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


def _records(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _attention_fwd(q, k, v, causal: bool, with_lse: bool):
    if _device(q, k, v).type == "cpu":
        o, lse = ref.attention_fwd_ref(q, k, v, causal=causal)
        return (o, lse) if with_lse else o
    return _fa.flash_attention_cuda(q, k, v, causal=causal, with_lse=with_lse)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _attention_fwd(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        if _device(q, do).type == "cpu":
            grads = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=ctx.causal)
        else:
            grads = _fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                 causal=ctx.causal)
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,H,Sq,D), k/v: (B,KV,Sk,D) -> (B,H,Sq,D); causal alignment
    ``k <= q + (Sk - Sq)`` as in the TPU kernel. Differentiable."""
    _device(q, k, v)
    _fa.check_inputs(q, k, v, causal)
    if _records(q, k, v):
        return _FlashAttention.apply(q, k, v, causal)
    return _attention_fwd(q, k, v, causal, with_lse=False)


# ---------------------------------------------------------------------------
# tiled matmul
# ---------------------------------------------------------------------------


def _matmul(x, w):
    if _device(x, w).type == "cpu":
        return ref.matmul_ref(x, w)
    return _mm.tiled_matmul_cuda(x, w)


class _TiledMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        # transposed views: the kernel reads the saved tensors in place
        dx = _matmul(dy, w.T) if ctx.needs_input_grad[0] else None
        dw = _matmul(x.T, dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def tiled_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M,K) @ w: (K,N) -> (M,N) in x's dtype, f32 accumulation; either
    operand may be a strided view. Differentiable: dX = dY @ W^T and
    dW = X^T @ dY, each in its operand's dtype."""
    _device(x, w)
    _mm.check_inputs(x, w)
    if _records(x, w):
        return _TiledMatmul.apply(x, w)
    return _matmul(x, w)


# ---------------------------------------------------------------------------
# quantized matmul
# ---------------------------------------------------------------------------


def _qmatmul(x, q, s, transpose=False):
    if _device(x, q, s).type == "cpu":
        return ref.quantized_matmul_ref(x, q, s, transpose=transpose)
    return _qmm.quantized_matmul_cuda(x, q, s, transpose=transpose)


class _QuantizedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q, s, anchor):
        ctx.save_for_backward(x, q, s)
        return _qmatmul(x, q, s)

    @staticmethod
    def backward(ctx, dy):
        x, q, s = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = _qmatmul(dy, q, s, transpose=True) if ctx.needs_input_grad[0] else None
        # dW = X^T @ dY, the transposed view read in place by the tiled matmul
        dw = _matmul(x.T, dy) if ctx.needs_input_grad[3] else None
        return dx, None, None, dw


def quantized_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                     anchor: torch.Tensor | None = None) -> torch.Tensor:
    """x: (M,K) @ dequant(q: (K,N) int8, s: (K,N/32) fp16) -> (M,N) in x's
    dtype, f32 math; q and s are the q8 wire layout (``core/qformat.py``)
    and may be column-slice views.

    Differentiable in x (dX = dY @ dequant^T, the kernel's transposed
    orientation) and in ``anchor``: a (K, N) tensor whose values are never
    read, standing for the weight in autograd. Its gradient is dW = X^T @ dY
    (the tiled matmul), so a view of a row that requires grad scatters dW
    into the row's gradient at the weight's offset."""
    _device(x, q, s)
    _qmm.check_inputs(x, q, s)
    if anchor is not None and tuple(anchor.shape) != tuple(q.shape):
        raise ValueError(f"quantized_matmul: anchor {tuple(anchor.shape)} is not "
                         f"q's shape {tuple(q.shape)}")
    if _records(*[t for t in (x, anchor) if t is not None]):
        return _QuantizedMatmul.apply(x, q, s, anchor)
    return _qmatmul(x, q, s)


# ---------------------------------------------------------------------------
# fused Adam
# ---------------------------------------------------------------------------


def adam_scalars(lr, b1, b2, eps, wd, c1, c2, device) -> torch.Tensor:
    """The (7,) f32 scalar vector ``[lr, b1, b2, eps, wd, c1, c2]``; any
    entry may be a 0-d device tensor, so nothing waits on the host."""
    vals = [torch.as_tensor(s, dtype=torch.float32, device=device).reshape(())
            for s in (lr, b1, b2, eps, wd, c1, c2)]
    return torch.stack(vals)


def fused_adam(p32: torch.Tensor, g32: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Fused AdamW over one f32 leaf of any shape (``scalars`` from
    ``adam_scalars``): updates p32, m and v IN PLACE and returns p's bf16
    copy, shaped like the leaf.

    The leaf is viewed as (R, 128) rows, as the TPU kernel takes it; a leaf
    whose size is not a multiple of 128 is zero-padded into a copy and the
    results copied back (the padding lanes update to zero and are dropped).
    """
    _device(p32, g32, m, v, scalars)
    if not all(t.is_contiguous() for t in (p32, m, v)):
        raise ValueError("fused_adam: p32, m and v are updated in place and "
                         "must be contiguous")
    shape, n = p32.shape, p32.numel()
    pad = (-n) % _ad.LANE

    def rows(t):
        t = t.reshape(-1)
        if pad:
            t = F.pad(t, (0, pad))
        return t.view(-1, _ad.LANE)

    pr, gr, mr, vr = (rows(t) for t in (p32, g32.float(), m, v))
    scalars = scalars.contiguous()
    _ad.check_inputs(pr, gr, mr, vr, scalars)
    if pr.device.type == "cpu":
        pbf = ref.adam_ref(pr, gr, mr, vr, scalars)
    else:
        pbf = _ad.fused_adam_cuda(pr, gr, mr, vr, scalars)
    if pad:  # the rows were copies: write the update back into the leaf
        for dst, src in ((p32, pr), (m, mr), (v, vr)):
            dst.copy_(src.reshape(-1)[:n].view(shape))
    return pbf.reshape(-1)[:n].view(shape)


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------


def launch_counts() -> dict:
    """Kernel launches so far in this process, by kernel; the tiled
    matmul's also by route (``tiled_matmul`` is their sum)."""
    return {"flash_attention": _fa.launches,
            "flash_attention_bwd": _fa.bwd_launches,
            "tiled_matmul": _mm.wgmma_launches + _mm.simt_launches,
            "tiled_matmul_wgmma": _mm.wgmma_launches,
            "tiled_matmul_simt": _mm.simt_launches, "fused_adam": _ad.launches,
            "quantized_matmul": _qmm.launches,
            "quantized_matmul_dx": _qmm.dx_launches}


def reset_launch_counts() -> None:
    _fa.launches = 0
    _fa.bwd_launches = 0
    _mm.wgmma_launches = 0
    _mm.simt_launches = 0
    _ad.launches = 0
    _qmm.launches = 0
    _qmm.dx_launches = 0
