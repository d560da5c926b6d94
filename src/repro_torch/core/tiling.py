"""Memory-centric tiling (paper Sec. 5.1.3), the counterpart of
``repro/core/tiling.py:tiled_matmul_xla``.

A large linear ``y = x @ W`` is restated as a sequence of smaller linears
over tiles of ``W``. Every product goes through ``kernels.ops.tiled_matmul``
(the hand-written kernel on the card, its plain version on the CPU), so the
MLP projections run on the port's kernel, forward and backward. The kernel
reads strided operands, so the column tiles of ``W`` go in as views.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def tiled_matmul(x: torch.Tensor, w: torch.Tensor, tiles: int = 1,
                 axis: str | None = None) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) with W processed in ``tiles`` sequential tiles.

    axis="n": tile output columns (each step produces a slice of y).
    axis="k": tile the contraction (each step accumulates into an f32 y) —
              used when K >> N. Output in x's dtype either way.
    """
    lead, K = x.shape[:-1], x.shape[-1]
    N = w.shape[1]
    x2 = x.reshape(-1, K)
    if tiles <= 1:
        return ops.tiled_matmul(x2, w).reshape(*lead, N)
    if axis is None:
        axis = "n" if N >= K else "k"
    if axis == "n":
        if N % tiles:
            raise ValueError(f"N={N} not divisible by tiles={tiles}")
        step = N // tiles
        ys = [ops.tiled_matmul(x2, w[:, i * step:(i + 1) * step])
              for i in range(tiles)]
        return torch.cat(ys, dim=-1).reshape(*lead, N)
    if K % tiles:
        raise ValueError(f"K={K} not divisible by tiles={tiles}")
    step = K // tiles
    acc = torch.zeros((x2.shape[0], N), dtype=torch.float32, device=x.device)
    for i in range(tiles):
        # products of the working-type values are exact in f32, so the f32
        # kernel call is the reference's f32-accumulated einsum
        acc += ops.tiled_matmul(x2[:, i * step:(i + 1) * step].float(),
                                w[i * step:(i + 1) * step].float())
    return acc.to(x.dtype).reshape(*lead, N)
