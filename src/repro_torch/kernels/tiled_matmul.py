"""Tiled matmul on the card: the ctypes wrapper around
``csrc/tiled_matmul.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/tiled_matmul.py``
(``tiled_matmul`` / ``_mm_kernel``): (M,K) @ (K,N) with f32 accumulation,
output in x's dtype, ragged edges masked inside the kernel. Each operand is
read through its row and column strides, so a transposed or column-sliced
view goes in without a copy (the gradient products read the saved tensors
in place). The source's
header comment states the design and what bounds it on an H100. The plain
version is ``kernels/ref.py:matmul_ref``; the CPU path goes there through
``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel in this process (ops.launch_counts reads it)
launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("tiled_matmul")
    fn = lib.tiled_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_int64] * 4 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def check_inputs(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise ``ValueError`` on shapes neither version takes."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"tiled_matmul: x {tuple(x.shape)} @ w "
                         f"{tuple(w.shape)}: want (M,K) @ (K,N)")


def tiled_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M,K) @ w: (K,N) on one CUDA device, any strides, shapes checked
    by ``check_inputs`` (``kernels/ops.py`` does both) -> (M,N) row-major in
    x's dtype. Launches the kernel or raises."""
    global launches
    codes = _build.DTYPE_CODES
    if x.dtype not in codes or w.dtype != x.dtype:
        raise ValueError(f"tiled_matmul: dtypes {x.dtype}/{w.dtype}; want "
                         f"one of {list(codes)} for both")
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tiled_matmul(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                              M, N, K, *x.stride(), *w.stride(),
                              codes[x.dtype], stream)
    _build.check(lib, rc, "tiled_matmul")
    launches += 1
    return y
