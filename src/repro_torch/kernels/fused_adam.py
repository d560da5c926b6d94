"""Fused AdamW on the card: the ctypes wrapper around ``csrc/fused_adam.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/fused_adam.py``
(``fused_adam_flat`` / ``_adam_kernel``): one pass over (R, 128) f32 p, g,
m, v with the scalars ``[lr, b1, b2, eps, wd, c1, c2]`` as a (7,) f32
device tensor. Unlike the functional TPU kernel, p, m and v are updated IN
PLACE (the update reads and writes each element once, and the optimizer
state is the largest device allocation of the step); the bf16 copy of p is
a new tensor. The source's header comment states what bounds it. The plain
version is ``kernels/ref.py:adam_ref``; ``kernels/ops.py:fused_adam``
dispatches by device and pads arbitrary leaves to 128 lanes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel in this process (ops.launch_counts reads it)
launches = 0

LANE = 128


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_adam")
    fn = lib.fused_adam
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def check_inputs(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, scalars: torch.Tensor) -> None:
    """Raise ``ValueError`` on what neither version takes."""
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != LANE \
                or t.shape != p.shape:
            raise ValueError(f"fused_adam: {name} {t.dtype} {tuple(t.shape)}; "
                             f"want f32 (R, {LANE}) like p {tuple(p.shape)}")
    if scalars.dtype != torch.float32 or tuple(scalars.shape) != (7,):
        raise ValueError(f"fused_adam: scalars {scalars.dtype} "
                         f"{tuple(scalars.shape)}; want f32 (7,)")


def fused_adam_cuda(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """(R, 128) f32 p, g, m, v and (7,) f32 scalars on one CUDA device,
    checked by ``check_inputs`` -> p's bf16 copy; p, m, v updated in place.
    Launches the kernel or raises."""
    global launches
    for t in (p, g, m, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_adam_cuda: p, g, m, v must be contiguous "
                             "and 16-byte aligned")
    pbf = torch.empty(p.shape, dtype=torch.bfloat16, device=p.device)
    lib = _lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = lib.fused_adam(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                            v.data_ptr(), pbf.data_ptr(), scalars.data_ptr(),
                            p.numel(), stream)
    _build.check(lib, rc, "fused_adam")
    launches += 1
    return pbf
