"""Quantized matmul on the card: the ctypes wrapper around
``csrc/quantized_matmul.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/tiled_matmul.py``
(``quantized_matmul`` / ``_qmm_kernel``): x (M,K) @ dequant(q (K,N) int8,
s (K,N/32) fp16), the q8 wire layout of ``core/qformat.py``, with f32
accumulation and the output in x's dtype; the weight is dequantized tile by
tile in shared memory. ``transpose=True`` is the dX product
x (M,N) @ dequant^T, which the TPU kernel lacks. q and s are read through
their row strides (a column slice goes in as a view).

The source holds two kernels, and ``route`` picks one per call by a stated
rule (not a fallback: each route launches its kernel or raises):

- ``"wgmma"``: bf16 x that TMA reads K-major (``tiled_matmul.tma_layout``
  gives ``"row"``) and q that TMA can describe (``q_tma_ld``: unit column
  stride, row stride a multiple of 16 bytes, base on 16 bytes). Tensor
  cores fed by a TMA/mbarrier ring, the int8 tile dequantized in shared
  memory into a bf16 hi + lo pair; ``plan`` picks its tile. Every quantized
  call of the q8 training path meets this, forward and dX.
- ``"simt"``: everything else -- f32 x (wgmma's only f32 input is TF32,
  which would break the f32 tolerance), x read M-major, and q views TMA
  cannot describe. The first design's CUDA-core f32 FMAs.

The source's header comment states the design and what bounds it on an
H100. The plain version is ``kernels/ref.py:quantized_matmul_ref``;
``kernels/ops.py`` dispatches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.qformat import BLOCK as QBLOCK
from repro_torch.kernels import _build
from repro_torch.kernels.tiled_matmul import tma_layout

# launches of each route's kernel in this process, by orientation
# (ops.launch_counts reads them; each orientation's sum is its count)
wgmma_launches = 0
simt_launches = 0
dx_wgmma_launches = 0
dx_simt_launches = 0

BM = 128  # the wgmma kernel's block rows
# a 128 x 64 block's time over a 128 x 128 block's at the same contraction:
# 0.57-0.62 on an H100 at the q8 training shapes (launch/tune_tiled.py)
BN64_COST = 0.6
_sms: dict = {}


def _lib() -> ctypes.CDLL:
    lib = _build.load("quantized_matmul")
    if lib.quantized_matmul.argtypes is None:
        lib.quantized_matmul.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                         + [ctypes.c_int64] * 4 + [ctypes.c_int] * 2
                                         + [ctypes.c_void_p])
        lib.quantized_matmul.restype = ctypes.c_int
        lib.quantized_matmul_wgmma.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                               + [ctypes.c_int64] * 3 + [ctypes.c_int] * 2
                                               + [ctypes.c_void_p])
        lib.quantized_matmul_wgmma.restype = ctypes.c_int
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


def q_tma_ld(q: torch.Tensor) -> Optional[int]:
    """The row stride (bytes) under which TMA reads an int8 (K, N) q, or
    None when it cannot: a unit column stride, rows a multiple of 16 bytes
    apart and no closer than a row's length, the base on 16 bytes. A single
    row is never stepped, so it takes any stride."""
    if q.dtype != torch.int8 or q.dim() != 2 or q.data_ptr() % 16:
        return None
    K, N = q.shape
    if q.stride(1) != 1 and N > 1:
        return None
    ld = q.stride(0) if K > 1 else -(-N // 16) * 16
    return ld if ld % 16 == 0 and ld >= N else None


def _wgmma_strides(x: torch.Tensor, q: torch.Tensor):
    """(x's row stride, q's row stride) for the wgmma kernel, or None when
    either operand is not one it reads."""
    if min(x.shape) <= 0 or min(q.shape) <= 0:
        return None
    lx, lq = tma_layout(x), q_tma_ld(q)
    return (lx[1], lq) if lx and lx[0] == "row" and lq is not None else None


def route(x: torch.Tensor, q: torch.Tensor) -> str:
    """``"wgmma"`` when x is bf16 that TMA reads K-major and TMA can
    describe q (``q_tma_ld``), else ``"simt"``; the same rule for both
    orientations (the dX product reads q in place as W^T)."""
    return "wgmma" if _wgmma_strides(x, q) else "simt"


def plan(M: int, n_out: int, sms: int = 132) -> dict:
    """The wgmma kernel's launch for an (M, .) @ (., n_out) product on a
    card with ``sms`` SMs, by a stated rule. A block's 197 KB of shared
    memory at 128 x 128 (131 KB at 128 x 64) leaves one block per SM, so a
    launch takes whole waves of ``sms`` blocks: the tile is the one whose
    waves, rounded up, times its block's time (1 at 128 x 128, ``BN64_COST``
    at 128 x 64) is least, 128 x 128 on a tie. So 128 x 64 where 128 x 128
    tiles leave a last wave mostly idle (the training shapes' 160 tiles:
    2 waves of 128 x 128 against 3 of 128 x 64) or fill under the card. The
    contraction is never split. Returns ``{"tile": [BM, BN], "blocks",
    "waves"}``; ``waves`` is blocks over SMs."""
    def blocks(bn):
        return -(-M // BM) * -(-n_out // bn)

    cost = {bn: -(-blocks(bn) // sms) * (1.0 if bn == 128 else BN64_COST) for bn in (128, 64)}
    bn = 64 if cost[64] < cost[128] else 128
    return {"tile": [BM, bn], "blocks": blocks(bn), "waves": blocks(bn) / sms}


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def quantized_matmul_cuda(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                          transpose: bool = False, simt: bool = False) -> torch.Tensor:
    """x @ dequant(q, s) (or ``@ dequant(q, s)^T``) on one CUDA device ->
    row-major in x's dtype, on the route ``route`` picks; ``simt=True`` runs
    the CUDA-core kernel whatever the operands (the previous design, timed
    beside the new one). Shapes checked by the caller (``kernels/ops.py``
    checks the forward's with ``check_inputs``; the backward's dX follows
    from it). q and s need a unit column stride. Launches the kernel or
    raises."""
    global wgmma_launches, simt_launches, dx_wgmma_launches, dx_simt_launches
    codes = _build.DTYPE_CODES
    if x.dtype not in codes:
        raise ValueError(f"quantized_matmul: x dtype {x.dtype}; want one of {list(codes)}")
    if q.stride(1) != 1 or s.stride(1) != 1:
        raise ValueError("quantized_matmul_cuda: q and s need a unit column stride")
    strides = None if simt else _wgmma_strides(x, q)
    chosen = "wgmma" if strides else "simt"
    M = x.shape[0]
    K, N = q.shape
    n_out, n_contract = (K, N) if transpose else (N, K)
    y = torch.empty((M, n_out), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if chosen == "wgmma":
            bn = plan(M, n_out, _sm_count(x.device))["tile"][1]
            rc = lib.quantized_matmul_wgmma(
                x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), M, n_out,
                n_contract, strides[0], strides[1], s.stride(0), int(transpose), bn, stream)
        else:
            rc = lib.quantized_matmul(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                                      M, n_out, n_contract, *x.stride(), q.stride(0),
                                      s.stride(0), int(transpose), codes[x.dtype], stream)
    if rc:
        _build.check(lib, rc, f"quantized_matmul ({chosen}, transpose={transpose}, M={M}, "
                              f"q {tuple(q.shape)} strides {q.stride()}, x strides "
                              f"{x.stride()})")
    if transpose:
        if chosen == "wgmma":
            dx_wgmma_launches += 1
        else:
            dx_simt_launches += 1
    elif chosen == "wgmma":
        wgmma_launches += 1
    else:
        simt_launches += 1
    return y
