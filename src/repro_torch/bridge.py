"""Weight bridge: the JAX package's param tree, as numpy, onto the port.

The port cannot reproduce ``jax.random``'s bits, so parity tests initialize
in JAX, move the tree through numpy (``np.asarray`` per leaf) and load it
here. bf16 leaves arrive as numpy arrays of the ``ml_dtypes`` bfloat16
type; they are recognised by dtype name and reinterpreted bit for bit
(``uint16`` view -> ``torch.bfloat16`` view), so the port never imports
``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(arr, device="cpu") -> torch.Tensor:
    """One numpy array (bf16 included) -> a torch tensor with the same bits."""
    arr = np.array(arr, order="C")  # a private contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays -> nested dict of torch tensors, at any
    depth (the hybrid's ``groups``/``tail`` subtrees included)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def zero3_state_from_numpy(state: dict, device="cpu", *, rank: int = 0, dp: int = 1,
                           mode: str = "allgather") -> dict:
    """The JAX package's ``ExplicitZero3Engine.init_state`` output with
    every leaf as numpy (``flat`` (L, P) bf16 rows, ``other``, ``other_opt``
    (an ``AdamState``-shaped 4-tuple step/master/m/v), ``step``, and where
    present the MoE expert rows ``eflat`` (L * E, Pe) bf16 (with the f32
    router in ``other``), the in-graph f32 ``master``/``m``/``v`` and the
    int8 residuals ``g_err``) -> the port engine's state, so both packages
    start from the same state; with ``dp`` > 1, rank ``rank``'s shard of
    it (``shard_zero3_state``)."""
    from repro_torch.optim.adam import AdamState

    step, master, m, v = state["other_opt"]
    out = {
        "flat": tensor_from_numpy(state["flat"], device),
        "other": params_from_numpy(state["other"], device),
        "other_opt": AdamState(tensor_from_numpy(step, device),
                               params_from_numpy(master, device),
                               params_from_numpy(m, device),
                               params_from_numpy(v, device)),
        "step": tensor_from_numpy(state["step"], device),
    }
    for key in ("eflat", "master", "m", "v", "g_err"):
        if key in state:
            out[key] = params_from_numpy(state[key], device)
    return shard_zero3_state(out, rank, dp, mode)


def shard_zero3_state(state: dict, rank: int, dp: int, mode: str = "allgather") -> dict:
    """A global explicit-engine state (torch) -> rank ``rank``'s shard of
    it among ``dp`` ranks: the (L, P) ``flat`` and ``master``/``m``/``v``
    as ``partition.row_shard`` splits them under ``mode``, the MoE expert
    rows ``eflat`` (L * E, Pe) by columns (the layered epoch's layout),
    each (dp, ...) residual's slice ``[rank]``; the small 'other' states
    whole, as the reference replicates them. The state itself at dp = 1."""
    from repro_torch.core.partition import row_shard, tree_map

    if dp == 1:
        return state
    out = dict(state)
    for key in ("flat", "master", "m", "v"):
        if key in out:
            out[key] = row_shard(out[key], rank, dp, mode).contiguous()
    if "eflat" in out:
        out["eflat"] = row_shard(out["eflat"], rank, dp, "allgather").contiguous()
    if "g_err" in out:
        out["g_err"] = tree_map(lambda t: t[rank:rank + 1].contiguous(), out["g_err"])
    return out


def gspmd_state_from_numpy(state: dict, run, device="cpu", *, rank: int = 0,
                           dp: int = 1, model: int = 1) -> dict:
    """The JAX package's GSPMD engine state with every leaf as numpy
    (``params``, and ``opt`` an ``AdamState``-shaped 4-tuple
    step/master/m/v where the optimizer is in-graph) -> the port engine's
    state for ``run``; on a ``dp`` x ``model`` mesh, rank ``rank``'s shards
    of it (``shard_gspmd_state``)."""
    from repro_torch.optim.adam import AdamState

    out = {"params": params_from_numpy(state["params"], device)}
    if "opt" in state:
        step, master, m, v = state["opt"]
        out["opt"] = AdamState(tensor_from_numpy(step, device),
                               *(params_from_numpy(t, device) for t in (master, m, v)))
    return shard_gspmd_state(out, run, rank, dp, model)


def shard_gspmd_state(state: dict, run, rank: int, dp: int, model: int = 1) -> dict:
    """A whole GSPMD engine state (torch) -> the shards of rank ``rank``
    (data coordinate ``rank // model``, model coordinate ``rank % model``)
    of a ``dp`` x ``model`` mesh, laid out by the port's rules
    (``partition.leaf_splits`` along both axes at ``run``'s ZeRO stage,
    ``partition.cut_leaf``): the params by the param rules, the masters and
    moments by the opt rules, the step count as it is. The state itself on
    one rank."""
    from repro_torch.core import partition as pt
    from repro_torch.models import registry
    from repro_torch.optim.adam import AdamState

    if dp * model == 1:
        return state
    defs = registry.build(run.model, run.parallel).defs
    sizes = {"data": dp, "model": model}
    coords = {"data": rank // model, "model": rank % model}

    def shard(tree, cls):
        splits = {a: pt.leaf_splits(defs, run.model, sizes, run.parallel, cls, axis=a)
                  for a in sizes}
        out: dict = {}
        for path in pt.tree_paths(tree):
            dims = {a: pt.tree_get(t, path) for a, t in splits.items()}
            pt.tree_set(out, path, pt.cut_leaf(pt.tree_get(tree, path), dims, coords, sizes))
        return out

    out = {"params": shard(state["params"], "param")}
    if "opt" in state:
        opt = state["opt"]
        out["opt"] = AdamState(opt.step, *(shard(t, "opt") for t in opt[1:]))
    return out
