"""int8 gradient compression with error feedback (``repro/optim/compression.py``).

Blocks of 256 elements, each scaled by ``max(absmax / 127, 1e-12)`` (the
division as the reference's jitted step computes it) and
rounded half to even (``torch.round``, as ``jnp.round``), clipped to
[-127, 127]. ``psum_compressed`` adds the carried residual, quantizes,
keeps the new residual (the quantization error) and returns the mean over
the ranks of the dequantized payloads, cast back to the input's dtype.

Across the ranks of a ``launch/mesh.LocalMesh`` the int8 payload and its
f32 scales are all-gathered and summed in rank order, each rank's product
added to the running f32 sum with one rounding (the multiply-add the
reference's compiled step fuses it into), then divided by the ranks. One
rank: the reduce is the identity, but the quantization and the error
feedback still change the numbers, exactly as the reference's do.
"""
from __future__ import annotations

from typing import Optional

import torch

BLOCK = 256


def _pad_len(n: int, block: int) -> int:
    return (-n) % block


def quantize_int8(x: torch.Tensor, block: int = BLOCK):
    """x: any shape -> (q int8 (nb, block), scales f32 (nb,), (shape, dtype))."""
    flat = x.reshape(-1).float()
    pad = _pad_len(flat.shape[0], block)
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    # absmax / 127 as XLA compiles the reference's jitted step: a multiply
    # by the f32 reciprocal, which may round one ulp from a true division
    scale = torch.amax(blocks.abs(), dim=1, keepdim=True) * torch.tensor(
        1.0 / 127.0, dtype=torch.float32)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0], (tuple(x.shape), x.dtype)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Inverse of ``quantize_int8``; ``shape`` is the ``(shape, dtype)`` it
    returned (or a plain shape, then f32 unless ``dtype`` is given)."""
    if isinstance(shape, tuple) and len(shape) == 2 and isinstance(shape[1], torch.dtype):
        shape, recorded = shape
        dtype = dtype or recorded
    dtype = dtype or torch.float32
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def psum_compressed(x: torch.Tensor, error: Optional[torch.Tensor] = None, mesh=None):
    """Mean-all-reduce ``x`` over ``mesh``'s ranks (None: this process
    alone) in the int8 wire format with error feedback -> (reduced x in x's
    dtype, new f32-or-promoted residual). ``x + error`` promotes as the
    reference does (bf16 + f32 -> f32)."""
    n = mesh.world if mesh is not None else 1
    if n == 1 and _world_size() > 1:
        raise ValueError(
            "psum_compressed without a mesh in a run of "
            f"{_world_size()} ranks would reduce this rank's payload alone: "
            "pass the run's launch/mesh.LocalMesh")
    out_dtype = x.dtype
    if error is not None:
        x = x + error
    q, scale, struct = quantize_int8(x)
    if x.dtype == torch.float32:
        # x - q * s rounded once, as the reference's compiled step fuses it
        # (a multiply-add); exact in f64 first, since q * s has at most 31
        # significant bits and lies within a factor 2 of x where q != 0
        qs = (q.double() * scale.double()[:, None]).reshape(-1)[:x.numel()]
        new_error = (x.double() - qs.reshape(x.shape)).float()
    else:
        new_error = x - dequantize_int8(q, scale, struct, dtype=x.dtype)
    qs = mesh.gather_stack(q) if n > 1 else q[None]  # (n, nb, BLOCK) int8
    ss = mesh.gather_stack(scale) if n > 1 else scale[None]  # (n, nb) f32
    # each rank's q * s is exact in f64 (31 significant bits at most): added
    # to the running sum and rounded to f32 once, a fused multiply-add
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for r in range(n):
        acc = (acc.double() + qs[r].double() * ss[r].double()[:, None]).float()
    total = acc.reshape(-1)[:x.numel()].reshape(x.shape)
    return (total / n).to(out_dtype), new_error
