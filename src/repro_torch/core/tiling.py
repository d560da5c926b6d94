"""Memory-centric tiling (paper Sec. 5.1.3), the counterpart of
``repro/core/tiling.py:tiled_matmul_xla``.

A large linear ``y = x @ W`` is restated as a sequence of smaller linears
over tiles of ``W``. Every product goes through ``kernels.ops.tiled_matmul``
(the hand-written kernel on the card, its plain version on the CPU), so the
MLP projections run on the port's kernel, forward and backward. The kernel
reads strided operands, so the column tiles of ``W`` go in as views. A
weight that arrived in the q8 wire layout (a ``QWeight``) goes through
``kernels.ops.quantized_matmul`` instead, tiled the same way.
"""
from __future__ import annotations

import torch

from repro_torch.core.partition import QWeight
from repro_torch.core.qformat import BLOCK as QBLOCK
from repro_torch.kernels import ops


def _product(x: torch.Tensor, w) -> torch.Tensor:
    if isinstance(w, QWeight):
        return ops.quantized_matmul(x, w.q, w.s, w.anchor)
    return ops.tiled_matmul(x, w)


def _slice(w, rows: slice, cols: slice):
    """A tile of ``w`` as views; a ``QWeight``'s column tiles must cover
    whole quant blocks."""
    if not isinstance(w, QWeight):
        return w[rows, cols]
    lo, hi = cols.start or 0, cols.stop if cols.stop is not None else w.q.shape[1]
    if lo % QBLOCK or hi % QBLOCK:
        raise ValueError(f"a column tile [{lo}, {hi}) of a q8 weight must cover "
                         f"whole {QBLOCK}-element quant blocks")
    anchor = None if w.anchor is None else w.anchor[rows, cols]
    return QWeight(w.q[rows, cols], w.s[rows, lo // QBLOCK:hi // QBLOCK], anchor)


def tiled_matmul(x: torch.Tensor, w, tiles: int = 1,
                 axis: str | None = None) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) with W processed in ``tiles`` sequential tiles;
    ``w`` is a tensor or a ``QWeight``.

    axis="n": tile output columns (each step produces a slice of y).
    axis="k": tile the contraction (each step accumulates into an f32 y) —
              used when K >> N. Output in x's dtype either way.
    """
    lead, K = x.shape[:-1], x.shape[-1]
    N = (w.q if isinstance(w, QWeight) else w).shape[1]
    x2 = x.reshape(-1, K)
    if tiles <= 1:
        return _product(x2, w).reshape(*lead, N)
    if axis is None:
        axis = "n" if N >= K else "k"
    every = slice(None)
    if axis == "n":
        if N % tiles:
            raise ValueError(f"N={N} not divisible by tiles={tiles}")
        step = N // tiles
        ys = [_product(x2, _slice(w, every, slice(i * step, (i + 1) * step)))
              for i in range(tiles)]
        return torch.cat(ys, dim=-1).reshape(*lead, N)
    if K % tiles:
        raise ValueError(f"K={K} not divisible by tiles={tiles}")
    step = K // tiles
    acc = torch.zeros((x2.shape[0], N), dtype=torch.float32, device=x.device)
    for i in range(tiles):
        # products of the working-type values are exact in f32, so the f32
        # kernel call is the reference's f32-accumulated einsum (a q8
        # weight is dequantized to f32 in either kernel)
        rows = slice(i * step, (i + 1) * step)
        wk = _slice(w, rows, every)
        acc += _product(x2[:, rows].float(),
                        wk if isinstance(wk, QWeight) else wk.float())
    return acc.to(x.dtype).reshape(*lead, N)
