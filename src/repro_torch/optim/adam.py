"""Partitioned mixed-precision AdamW (``repro/optim/adam.py``).

Model-state layout as in the paper's 20-bytes/param accounting: bf16
compute parameters, fp32 master + m + v. ``apply_updates`` advances the
step on the device: lr (``lr_at``) and the f32 bias corrections are 0-d
device tensors, so nothing waits on the host. Every leaf update goes
through ``kernels.ops.fused_adam`` — the fused-Adam kernel on the card, its
plain version on the CPU — which updates ``master``/``m``/``v`` IN PLACE:
the returned ``AdamState`` holds the same tensors as the one passed in.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.core import partition as pt
from repro_torch.kernels import ops


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    master: dict  # fp32 params
    m: dict
    v: dict


def init_state(params: dict) -> AdamState:
    """f32 masters (copies) and zero moments for a nested dict of params,
    on the params' device."""
    master = pt.tree_map(lambda p: p.float().clone(), params)
    zeros = lambda: pt.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                      device=p.device), params)
    dev = pt.tree_leaves(params)[0].device
    return AdamState(torch.zeros((), dtype=torch.int32, device=dev), master,
                     zeros(), zeros())


def lr_at(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``tc.lr`` over ``tc.warmup_steps``; f32 0-d tensor
    on the step's device."""
    warm = torch.clamp(step.float() / max(tc.warmup_steps, 1), max=1.0)
    return warm * tc.lr


def update_scalars(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """The fused-Adam kernel's (7,) scalars for the update that makes the
    step count ``step`` (0-d int32, on the device): ``lr_at(step)`` and the
    f32 bias corrections ``1 - beta ** step``."""
    sf = step.float()
    c1 = 1.0 - torch.pow(torch.tensor(tc.beta1, dtype=torch.float32,
                                      device=sf.device), sf)
    c2 = 1.0 - torch.pow(torch.tensor(tc.beta2, dtype=torch.float32,
                                      device=sf.device), sf)
    return ops.adam_scalars(lr_at(tc, step), tc.beta1, tc.beta2, tc.eps,
                            tc.weight_decay, c1, c2, sf.device)


def apply_updates(grads: dict, state: AdamState, tc: TrainConfig, *,
                  params_prev: dict | None = None):
    """Returns (new compute-dtype params, new AdamState). ``grads`` is a
    nested dict (bf16 or f32 leaves) shaped like ``state.master``;
    ``params_prev`` supplies each leaf's compute dtype (default bf16).
    A bf16 param is the kernel's rounded copy; an f32 param is a copy of
    the master."""
    step = state.step + 1
    scalars = update_scalars(tc, step)
    paths = pt.tree_paths(grads)
    params = {}
    for path in paths:
        p32 = pt.tree_get(state.master, path)
        pbf = ops.fused_adam(p32, pt.tree_get(grads, path),
                             pt.tree_get(state.m, path),
                             pt.tree_get(state.v, path), scalars)
        dt = (pt.tree_get(params_prev, path).dtype if params_prev is not None
              else torch.bfloat16)
        pt.tree_set(params, path, pbf if dt == torch.bfloat16 else p32.to(dt, copy=True))
    return params, AdamState(step, state.master, state.m, state.v)


def max_update_ratio(tc: TrainConfig, step: int) -> float:
    """The largest ``|m_hat / sqrt(v_hat)|`` AdamW can reach at ``step``
    (1-based) whatever the gradients: by Cauchy-Schwarz over the two
    moments' weights, ``sqrt(c2) / c1 * sqrt((1-b1)^2 / (1-b2) *
    sum_{k<step} (b1^2/b2)^k)`` (finite for b1^2 < b2)."""
    b1, b2 = tc.beta1, tc.beta2
    c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    s = sum((b1 * b1 / b2) ** k for k in range(step))
    return c2 ** 0.5 / c1 * ((1.0 - b1) ** 2 / (1.0 - b2) * s) ** 0.5


def parity_bound(tc: TrainConfig, lrs) -> float:
    """How far one weight of two AdamW runs that start equal can drift
    apart in ``len(lrs)`` steps (lr of each step in ``lrs``) whatever their
    gradients: each step's normalized updates differ by at most
    ``2 * lr * max_update_ratio``, and the decay term scales the
    difference so far by at most ``1 + lr * wd``."""
    bound = 0.0
    for t, lr in enumerate(lrs, start=1):
        bound = bound * (1.0 + lr * tc.weight_decay) + 2.0 * lr * max_update_ratio(tc, t)
    return bound
