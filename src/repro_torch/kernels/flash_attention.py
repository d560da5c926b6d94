"""Causal GQA flash attention on the card: the ctypes wrapper around
``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``). The kernel takes any batch /
head / sequence strides with a contiguous last dim, so the model's
``(B, S, H, D)`` activations go in as a transposed view without a copy.
The source's header comment states the design and what bounds it on an
H100. The plain version is ``kernels/ref.py:attention_ref``; the CPU path
goes there through ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel in this process (ops.launch_counts reads it)
launches = 0

HEAD_DIMS = (32, 64, 128)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_int64] * 12
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


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
                         *, causal: bool = True) -> torch.Tensor:
    """q: (B,H,Sq,D), k/v: (B,KV,Sk,D) on one CUDA device, shapes checked by
    ``check_inputs`` (``kernels/ops.py`` does both) -> (B,H,Sq,D) in q's
    dtype and q's memory layout. Launches the kernel or raises."""
    global launches
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    codes = _build.DTYPE_CODES
    if q.dtype not in codes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; want one of {list(codes)}")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("flash_attention_cuda: last dim must be "
                             f"contiguous (strides {t.stride()})")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)  # keeps q's strides: (B,S,H,D) storage stays so
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, H, KV, Sq, Sk, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *o.stride()[:3], int(causal),
            codes[q.dtype], D ** -0.5, stream)
    _build.check(lib, rc, "flash_attention")
    launches += 1
    return o
