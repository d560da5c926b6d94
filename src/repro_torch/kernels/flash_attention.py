"""Causal GQA flash attention on the card: the ctypes wrappers around
``csrc/flash_attention.cu``, forward and backward, with an optional local
window (``window`` > 0: query i sees key j only if j > i + (Sk - Sq) -
window, recurrentgemma's local attention; 0 is global).

The forward replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``); the backward has no TPU
counterpart (the reference differentiates its jnp chunked attention). Both
take any batch / head / sequence strides with a contiguous last dim, so the
model's ``(B, S, H, D)`` activations and their gradients go in and out as
transposed views without a copy.

The source holds two sets of kernels, and ``route`` picks one per call by a
stated rule (not a fallback: each route launches its kernels or raises):

- ``"wgmma"``: bf16, head_dim 64, 128, 192 or 256 (smollm-135m's,
  llama-3.2-3b's, nemotron-4-340b's, gemma-7b's and recurrentgemma-9b's),
  every operand one TMA can describe (``tma_strides``). Tensor cores fed by
  TMA under mbarriers; ``plan`` states their tiles and grids, which differ
  above head_dim 128: dQ blocks of 64 query rows, and dK/dV blocks that
  each accumulate one slab of head_dim (``SLAB``). Every bf16 attention
  call of the serving and training paths meets this.
- ``"simt"``: everything else -- f32 (wgmma's only f32 input is TF32, which
  would break the f32 tolerance), head_dim 32, views TMA cannot describe.
  The first design's CUDA-core f32 FMAs, at every head_dim on request
  (``simt=True``: the timed baseline). The smoke configs' head_dim 16 and 8
  have no kernel: they run on the CPU only.

The window never changes the route; it narrows each block's walk to the
tiles its rows' windows reach (``plan``), and a tile partly inside is
masked per element. The source's header comment states the design and
what bounds it on an H100. The plain versions are ``kernels/ref.py:attention_fwd_ref`` /
``attention_bwd_ref``; the CPU path goes there through ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

ROUTES = ("wgmma", "simt")
# launches in this process by route, forward and backward (ops.launch_counts
# reads them; one backward launch is the delta, dK/dV and dQ kernels
# together), and of those the launches with a local window
wgmma_launches = 0
simt_launches = 0
bwd_wgmma_launches = 0
bwd_simt_launches = 0
window_launches = 0
bwd_window_launches = 0

HEAD_DIMS = (32, 64, 128, 192, 256)
WGMMA_HEAD_DIMS = (64, 128, 192, 256)
# the wgmma kernels' tiles (csrc/flash_attention.cu, namespace wg): query
# rows per forward block (and dQ block up to head_dim 128), keys per K/V
# tile and per dK/dV block, query rows per tile of the dK/dV loop (and per
# dQ block above head_dim 128)
BQ, BKV, BQB = 128, 64, 64
# the columns of head_dim one dK/dV block accumulates: a 64-column chunk
# multiple, so that its two accumulators stay within a thread's registers
SLAB = {64: 64, 128: 128, 192: 64, 256: 128}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fwd, bwd = lib.flash_attention_fwd, lib.flash_attention_bwd
    if fwd.argtypes is None:
        fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                        + [ctypes.c_int64] * 12
                        + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_float, ctypes.c_int,
                           ctypes.c_void_p])
        bwd.restype = ctypes.c_int
    return lib


def tma_strides(t: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """The batch, head and sequence strides (elements) under which TMA reads
    a bf16 (B, H, S, D) operand, or None when it cannot: a unit last stride,
    the others positive multiples of 8 elements (16 bytes), the base aligned
    to 16 bytes. A dimension of size 1 is never stepped, so it takes any
    stride and is given 8."""
    if t.dtype != torch.bfloat16 or t.dim() != 4 or t.stride(-1) != 1 or t.data_ptr() % 16:
        return None
    out = []
    for size, st in zip(t.shape[:3], t.stride()[:3]):
        if size == 1:
            st = 8
        if st <= 0 or st % 8:
            return None
        out.append(st)
    return tuple(out)


def route(q: torch.Tensor, *ts: torch.Tensor) -> str:
    """``"wgmma"`` when q and every tensor of ``ts`` (k, v; and dO for the
    backward) are bf16 of a head_dim in ``WGMMA_HEAD_DIMS`` that TMA can
    describe (``tma_strides``), else ``"simt"``."""
    if q.shape[-1] not in WGMMA_HEAD_DIMS or min(q.shape) == 0:
        return "simt"
    return "wgmma" if all(tma_strides(t) for t in (q, *ts)) else "simt"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _kv_range(first_row: int, last_row: int, Sq: int, Sk: int, causal: bool,
              window: int = 0) -> Tuple[int, int]:
    """The [first, last) K/V tiles that query rows first_row ... last_row
    see (the kernels' rule): under causal up to the frontier key
    last_row + (Sk - Sq); with a window from the first key past
    first_row + (Sk - Sq) - window."""
    n = _cdiv(Sk, BKV)
    last = min(n, (last_row + Sk - Sq) // BKV + 1) if causal else n
    first = max(0, first_row + Sk - Sq - window + 1) // BKV if window > 0 else 0
    return first, max(first, last)


def _q_range(k0: int, Sq: int, Sk: int, causal: bool, window: int = 0) -> Tuple[int, int]:
    """The [first, last) query tiles of BQB rows that see a key of the K/V
    tile from key k0 (the dK/dV kernels' rule): under causal from the first
    row i >= k0 - (Sk - Sq); with a window the rows below
    min(k0 + BKV, Sk) - 1 - (Sk - Sq) + window."""
    first = max(0, k0 - (Sk - Sq)) // BQB if causal else 0
    end = Sq
    if window > 0:
        end = min(Sq, max(0, min(k0 + BKV, Sk) - 1 - (Sk - Sq) + window))
    return first, max(first, _cdiv(end, BQB))


def plan(B: int, H: int, KV: int, Sq: int, Sk: int, causal: bool = True,
         sms: int = 132, window: int = 0, D: int = 64) -> dict:
    """The wgmma kernels' tiles and grids for one call at head_dim ``D`` on a
    card with ``sms`` SMs, as the kernels compute them:

    - forward and dQ: one block per (query rows, head, batch) -- BQ rows,
      and BQB for dQ above head_dim 128 -- the last query tile first, each
      block walking the K/V tiles of BKV keys from the first its first
      row's window reaches (``window`` > 0) up to the causal frontier of its
      last row;
    - dK/dV: one block per (BKV keys, slab of ``SLAB[D]`` columns of
      head_dim, KV head, batch), key tile 0 first, each block walking its
      group's H/KV query heads and, for each, the query tiles of BQB rows
      from the frontier of its first key to the last row whose window
      reaches its last key.

    Under causal without a window the first launched block has the most
    work, so the heavy blocks never form a tail; under a window the work
    is flat past the first ``window`` rows and the order stays correct, not
    optimal. Returns, per kernel, ``tile`` (rows, columns of a step),
    ``blocks``, ``blocks_per_sm`` (blocks over SMs), ``order`` (the tile
    index of each group of blocks in launch order), ``steps`` (the tiles
    each of those blocks walks) and ``pairs`` (tile pairs over the grid);
    dK/dV also ``slab`` and ``slabs``."""
    if D not in WGMMA_HEAD_DIMS:
        raise ValueError(f"flash_attention.plan: head_dim {D} not in {WGMMA_HEAD_DIMS}")

    def q_grid(rows):
        order = list(range(_cdiv(Sq, rows) - 1, -1, -1))
        steps = []
        for t in order:
            first, last = _kv_range(t * rows, min((t + 1) * rows, Sq) - 1, Sq, Sk, causal,
                                    window)
            steps.append(last - first)
        blocks = len(order) * H * B
        return {"tile": [rows, BKV], "blocks": blocks, "blocks_per_sm": blocks / sms,
                "order": order, "steps": steps, "pairs": sum(steps) * H * B}

    n_kt, n_rep, slabs = _cdiv(Sk, BKV), H // KV, D // SLAB[D]
    k_order = list(range(n_kt))
    k_steps = []
    for t in k_order:
        first, last = _q_range(t * BKV, Sq, Sk, causal, window)
        k_steps.append(n_rep * (last - first))
    blocks = n_kt * slabs * KV * B
    return {"fwd": q_grid(BQ), "dq": q_grid(BQ if D <= 128 else BQB),
            "dkdv": {"tile": [BKV, BQB], "slab": SLAB[D], "slabs": slabs, "blocks": blocks,
                     "blocks_per_sm": blocks / sms, "order": k_order, "steps": k_steps,
                     "pairs": sum(k_steps) * slabs * KV * B}}


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
                 causal: bool, window: int = 0) -> None:
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
    if window < 0:
        raise ValueError(f"flash_attention: window {window}; want >= 0 (0 = global)")


def _read(t: torch.Tensor, chosen: str) -> tuple:
    """The batch, head and sequence strides an input is read through: on the
    wgmma route TMA's (``tma_strides``), else the tensor's own."""
    return tma_strides(t) if chosen == "wgmma" else t.stride()[:3]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         with_lse: bool = False, simt: bool = False):
    """q: (B,H,Sq,D), k/v: (B,KV,Sk,D) on one CUDA device, shapes checked by
    ``check_inputs`` (``kernels/ops.py`` does both) -> (B,H,Sq,D) in q's
    dtype and q's memory layout; with ``with_lse`` also the (B,H,Sq) f32
    log-sum-exp, as ``(o, lse)``. Runs on the route ``route`` picks;
    ``simt=True`` runs the CUDA-core kernel whatever the operands (the
    previous design, timed beside the new one). Launches or raises."""
    global wgmma_launches, simt_launches, window_launches
    D = q.shape[-1]
    _check_cuda((q, k, v), D)
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)  # keeps q's strides: (B,S,H,D) storage stays so
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    chosen = "simt" if simt else route(q, k, v)
    strides = [*_read(q, chosen), *_read(k, chosen), *_read(v, chosen), *o.stride()[:3]]
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None,
            B, H, KV, Sq, Sk, D, *strides, int(causal), int(window),
            _build.DTYPE_CODES[q.dtype], D ** -0.5, int(chosen == "wgmma"), stream)
    _build.check(lib, rc, f"flash_attention ({chosen}, q {tuple(q.shape)} strides "
                          f"{q.stride()}, k {tuple(k.shape)} strides {k.stride()})")
    if chosen == "wgmma":
        wgmma_launches += 1
    else:
        simt_launches += 1
    window_launches += window > 0
    return (o, lse) if with_lse else o


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0, simt: bool = False):
    """Gradients (dq, dk, dv) of the forward on one CUDA device, from the
    saved output ``o`` and f32 ``lse`` (B,H,Sq) and the output gradient
    ``do`` (B,H,Sq,D); each gradient in its input's dtype and memory layout.
    Launches the delta, dK/dV and dQ kernels of the route ``route(q, k, v,
    do)`` picks (``simt=True``: the CUDA-core ones) in that order or
    raises."""
    global bwd_wgmma_launches, bwd_simt_launches, bwd_window_launches
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
    chosen = "simt" if simt else route(q, k, v, do)
    strides = [s for t in (q, k, v) for s in _read(t, chosen)] + list(o.stride()[:3]) \
        + list(_read(do, chosen)) + [s for t in (dq, dk, dv) for s in t.stride()[:3]]
    c_strides = (ctypes.c_int64 * len(strides))(*strides)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), B, H, KV, Sq, Sk, D,
            ctypes.cast(c_strides, ctypes.c_void_p), int(causal), int(window),
            _build.DTYPE_CODES[q.dtype], D ** -0.5, int(chosen == "wgmma"), stream)
    _build.check(lib, rc, f"flash_attention_bwd ({chosen}, q {tuple(q.shape)} strides "
                          f"{q.stride()}, dO strides {do.stride()})")
    if chosen == "wgmma":
        bwd_wgmma_launches += 1
    else:
        bwd_simt_launches += 1
    bwd_window_launches += window > 0
    return dq, dk, dv
