"""Quantized matmul on the card: the ctypes wrapper around
``csrc/quantized_matmul.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/tiled_matmul.py``
(``quantized_matmul`` / ``_qmm_kernel``): x (M,K) @ dequant(q (K,N) int8,
s (K,N/32) fp16), the q8 wire layout of ``core/qformat.py``, with f32 math
and the output in x's dtype; the weight is dequantized tile by tile in
shared memory. ``transpose=True`` is the dX product x (M,N) @ dequant^T,
which the TPU kernel lacks. x is read through its strides; q and s through
their row strides (a column slice goes in as a view). The source's header
comment states the design and what bounds it on an H100. The plain version
is ``kernels/ref.py:quantized_matmul_ref``; ``kernels/ops.py`` dispatches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.qformat import BLOCK as QBLOCK
from repro_torch.kernels import _build

# launches of the CUDA kernel in this process, by orientation
# (ops.launch_counts reads them)
launches = 0
dx_launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("quantized_matmul")
    fn = lib.quantized_matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_int64] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def check_inputs(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    """Raise ``ValueError`` on what neither version takes."""
    if x.dim() != 2 or q.dim() != 2 or s.dim() != 2:
        raise ValueError(f"quantized_matmul: x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"s {tuple(s.shape)}: want 2-D operands")
    K, N = q.shape
    if q.dtype != torch.int8 or s.dtype != torch.float16:
        raise ValueError(f"quantized_matmul: q {q.dtype}, s {s.dtype}; want int8, float16")
    if N % QBLOCK or tuple(s.shape) != (K, N // QBLOCK):
        raise ValueError(f"quantized_matmul: q {tuple(q.shape)} with s {tuple(s.shape)}: "
                         f"want N % {QBLOCK} == 0 and s (K, N/{QBLOCK})")
    if x.shape[1] != K:
        raise ValueError(f"quantized_matmul: x {tuple(x.shape)} @ q {tuple(q.shape)}: "
                         f"contraction sizes differ")


def quantized_matmul_cuda(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                          transpose: bool = False) -> torch.Tensor:
    """x @ dequant(q, s) (or ``@ dequant(q, s)^T``) on one CUDA device ->
    row-major in x's dtype; shapes checked by the caller (``kernels/ops.py``
    checks the forward's with ``check_inputs``; the backward's dX follows
    from it). x may have any strides; q and s need a unit column stride.
    Launches the kernel or raises."""
    global launches, dx_launches
    codes = _build.DTYPE_CODES
    if x.dtype not in codes:
        raise ValueError(f"quantized_matmul: x dtype {x.dtype}; want one of {list(codes)}")
    if q.stride(1) != 1 or s.stride(1) != 1:
        raise ValueError("quantized_matmul_cuda: q and s need a unit column stride")
    M = x.shape[0]
    K, N = q.shape
    n_out, n_contract = (K, N) if transpose else (N, K)
    y = torch.empty((M, n_out), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.quantized_matmul(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                                  M, n_out, n_contract, *x.stride(), q.stride(0),
                                  s.stride(0), int(transpose), codes[x.dtype], stream)
    _build.check(lib, rc, "quantized_matmul")
    if transpose:
        dx_launches += 1
    else:
        launches += 1
    return y
