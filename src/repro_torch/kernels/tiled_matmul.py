"""Tiled matmul on the card: the ctypes wrapper around
``csrc/tiled_matmul.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/tiled_matmul.py``
(``tiled_matmul`` / ``_mm_kernel``): (M,K) @ (K,N) with f32 accumulation,
output in x's dtype, ragged edges handled inside the kernel. Each operand is
read through its strides, so a transposed or column-sliced view goes in
without a copy (the gradient products read the saved tensors in place).

The source holds two kernels, and ``route`` picks one per call by a stated
rule (not a fallback: each route launches its kernel or raises):

- ``"wgmma"``: both operands bf16 and describable by TMA -- one unit stride,
  the other stride a multiple of 8 elements (16 bytes) and no smaller than
  the rows it spans, base aligned to 16 bytes. Tensor cores fed by a
  TMA/mbarrier ring; ``plan`` picks its tile and K split per shape. Every
  bf16 product of the serving and training paths meets this.
- ``"simt"``: everything else -- f32 (wgmma's only f32 input is TF32, which
  would break the f32 tolerance) and bf16 views TMA cannot describe, such as
  an odd row stride. The first design's CUDA-core f32 FMAs.

The source's header comment states the design and what bounds it on an
H100. The plain version is ``kernels/ref.py:matmul_ref``; the CPU path goes
there through ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

ROUTES = ("wgmma", "simt")
# launches of each route's kernel in this process (ops.launch_counts reads
# them; their sum is the tiled matmul's count)
wgmma_launches = 0
simt_launches = 0

BM, BK = 128, 64  # the wgmma kernel's block rows and k slice
SPLIT_SLICES = 16  # k slices each part of a split K keeps, at the least
_sms: dict = {}


def _lib() -> ctypes.CDLL:
    lib = _build.load("tiled_matmul")
    if lib.tiled_matmul.argtypes is None:
        lib.tiled_matmul.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                     + [ctypes.c_int64] * 4 + [ctypes.c_int, ctypes.c_void_p])
        lib.tiled_matmul.restype = ctypes.c_int
        lib.tiled_matmul_wgmma.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_int, ctypes.c_int64] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.tiled_matmul_wgmma.restype = ctypes.c_int
    return lib


def check_inputs(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise ``ValueError`` on shapes neither version takes."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"tiled_matmul: x {tuple(x.shape)} @ w "
                         f"{tuple(w.shape)}: want (M,K) @ (K,N)")


def tma_layout(t: torch.Tensor) -> Optional[Tuple[str, int]]:
    """How TMA reads a bf16 (R, C) operand: ``("row", ld)`` when C runs along
    the unit stride and rows lie ``ld`` elements apart, ``("col", ld)`` when
    R does, None when TMA cannot describe it. A dimension of size 1 takes
    any stride (it is never stepped), so it counts as packed."""
    if t.dtype != torch.bfloat16 or t.dim() != 2 or t.data_ptr() % 16:
        return None
    R, C = t.shape
    s0, s1 = t.stride()
    if s1 == 1 or C == 1:
        ld = s0 if R > 1 else -(-C // 8) * 8
        if ld % 8 == 0 and ld >= C:
            return "row", ld
    if s0 == 1 or R == 1:
        ld = s1 if C > 1 else -(-R // 8) * 8
        if ld % 8 == 0 and ld >= R:
            return "col", ld
    return None


def _layouts(x: torch.Tensor, w: torch.Tensor):
    """Both operands' ``tma_layout``, or None when either has none."""
    if min(*x.shape, w.shape[1]) <= 0:
        return None
    lx, lw = tma_layout(x), tma_layout(w)
    return (lx, lw) if lx and lw else None


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """``"wgmma"`` when both operands are bf16 and TMA can describe each
    (``tma_layout``), else ``"simt"``."""
    return "wgmma" if _layouts(x, w) else "simt"


def plan(M: int, N: int, K: int, sms: int = 132) -> dict:
    """The wgmma kernel's launch for an (M,K) @ (K,N) product on a card with
    ``sms`` SMs, by a stated rule (from the kernel's times on an H100 at
    the main paths' shapes, PERF.md):

    - split K into as many parts as 128 x 128 tiles still fit once on the
      SMs (tiles x split <= SMs), each part at least ``SPLIT_SLICES`` k
      slices long: only the weight gradients' K = 4096 splits (in 2);
      shorter K is cheaper unsplit than its f32 partial sums cost;
    - tile 128 x 64 instead when K does not split and 128 x 128 tiles
      would fill at most half the SMs (decode): twice the blocks, two per
      SM; else 128 x 128.

    Returns ``{"tile": [BM, BN], "split", "blocks", "waves"}``; ``waves`` is
    blocks over the blocks the card holds at once (one 128 x 128 block per
    SM, two 128 x 64)."""
    kt = -(-K // BK)
    tiles = -(-M // BM) * -(-N // 128)
    split = max(1, min(sms // tiles, kt // SPLIT_SLICES))
    split = -(-kt // -(-kt // split))  # as the kernel trims it: no empty part
    bn, per_sm = 128, 1
    if split == 1 and 2 * tiles <= sms:
        bn, per_sm = 64, 2
        tiles = -(-M // BM) * -(-N // bn)
    return {"tile": [BM, bn], "split": split, "blocks": tiles * split,
            "waves": tiles * split / (sms * per_sm)}


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def tiled_matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                      simt: bool = False) -> torch.Tensor:
    """x: (M,K) @ w: (K,N) on one CUDA device, shapes checked by
    ``check_inputs`` (``kernels/ops.py`` does both) -> (M,N) row-major in
    x's dtype, on the route ``route`` picks; ``simt=True`` runs the
    CUDA-core kernel whatever the operands (the previous design, timed
    beside the new one). Launches the kernel or raises."""
    global wgmma_launches, simt_launches
    codes = _build.DTYPE_CODES
    if x.dtype not in codes or w.dtype != x.dtype:
        raise ValueError(f"tiled_matmul: dtypes {x.dtype}/{w.dtype}; want "
                         f"one of {list(codes)} for both")
    layouts = None if simt else _layouts(x, w)
    chosen = "wgmma" if layouts else "simt"
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if chosen == "wgmma":
            p = plan(M, N, K, _sm_count(x.device))
            ws = (torch.empty((p["split"], M, N), dtype=torch.float32, device=x.device)
                  if p["split"] > 1 else None)
            (xm, xld), (wm, wld) = layouts
            rc = lib.tiled_matmul_wgmma(
                x.data_ptr(), w.data_ptr(), y.data_ptr(),
                None if ws is None else ws.data_ptr(), M, N, K,
                int(xm == "row"), xld, int(wm == "col"), wld, p["tile"][1],
                p["split"], stream)
        else:
            rc = lib.tiled_matmul(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                  M, N, K, *x.stride(), *w.stride(),
                                  codes[x.dtype], stream)
    if rc:
        _build.check(lib, rc, f"tiled_matmul ({chosen}, M={M} N={N} K={K}, x strides "
                              f"{x.stride()}, w strides {w.stride()})")
    if chosen == "wgmma":
        wgmma_launches += 1
    else:
        simt_launches += 1
    return y
