"""Causal GQA flash attention on the card: the ctypes wrappers around
``csrc/flash_attention.cu``, forward and backward.

The forward replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``); the backward has no TPU
counterpart (the reference differentiates its jnp chunked attention). Both
take any batch / head / sequence strides with a contiguous last dim, so the
model's ``(B, S, H, D)`` activations and their gradients go in and out as
transposed views without a copy. The source's header comment states the
design and what bounds it on an H100. The plain versions are
``kernels/ref.py:attention_fwd_ref`` / ``attention_bwd_ref``; the CPU path
goes there through ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernels in this process (ops.launch_counts reads
# them); one backward launch is the delta, dK/dV and dQ kernels together
launches = 0
bwd_launches = 0

HEAD_DIMS = (32, 64, 128)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fwd, bwd = lib.flash_attention_fwd, lib.flash_attention_bwd
    if fwd.argtypes is None:
        fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                        + [ctypes.c_int64] * 12
                        + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                           ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_float, ctypes.c_void_p])
        bwd.restype = ctypes.c_int
    return lib


def _check_cuda(ts, D: int) -> None:
    """What the CUDA kernels take beyond ``check_inputs``: head_dim, one
    dtype, a contiguous last dim."""
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    codes = _build.DTYPE_CODES
    if ts[0].dtype not in codes or any(t.dtype != ts[0].dtype for t in ts):
        raise ValueError(f"flash_attention: dtypes {[t.dtype for t in ts]}; "
                         f"want one of {list(codes)} for all")
    for t in ts:
        if t.stride(-1) != 1:
            raise ValueError("flash_attention_cuda: last dim must be "
                             f"contiguous (strides {t.stride()})")


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> None:
    """Raise ``ValueError`` on shapes neither version takes."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want "
                         "(B,H,Sq,D) and two (B,KV,Sk,D)")
    B, H, Sq, D = q.shape
    Bk, KV, Sk, Dk = k.shape
    if Bk != B or Dk != D or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}: batch/head_dim differ or H % KV")
    if causal and Sq > Sk:
        raise ValueError(f"flash_attention: causal needs Sq <= Sk "
                         f"({Sq} > {Sk}): a query row would see no key")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, with_lse: bool = False):
    """q: (B,H,Sq,D), k/v: (B,KV,Sk,D) on one CUDA device, shapes checked by
    ``check_inputs`` (``kernels/ops.py`` does both) -> (B,H,Sq,D) in q's
    dtype and q's memory layout; with ``with_lse`` also the (B,H,Sq) f32
    log-sum-exp, as ``(o, lse)``. Launches the kernel or raises."""
    global launches
    D = q.shape[-1]
    _check_cuda((q, k, v), D)
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)  # keeps q's strides: (B,S,H,D) storage stays so
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None,
            B, H, KV, Sq, Sk, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *o.stride()[:3], int(causal),
            _build.DTYPE_CODES[q.dtype], D ** -0.5, stream)
    _build.check(lib, rc, "flash_attention")
    launches += 1
    return (o, lse) if with_lse else o


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True):
    """Gradients (dq, dk, dv) of the forward on one CUDA device, from the
    saved output ``o`` and f32 ``lse`` (B,H,Sq) and the output gradient
    ``do`` (B,H,Sq,D); each gradient in its input's dtype and memory layout.
    Launches the delta, dK/dV and dQ kernels in that order or raises."""
    global bwd_launches
    D = q.shape[-1]
    _check_cuda((q, k, v, o, do), D)
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse {lse.dtype} "
                         f"{tuple(lse.shape)}; want contiguous f32 {(B, H, Sq)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]]
    c_strides = (ctypes.c_int64 * len(strides))(*strides)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), B, H, KV, Sq, Sk, D,
            ctypes.cast(c_strides, ctypes.c_void_p), int(causal),
            _build.DTYPE_CODES[q.dtype], D ** -0.5, stream)
    _build.check(lib, rc, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv
