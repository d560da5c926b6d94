"""Activation checkpoint policies of a model's blocks: the port of
``_remat_policy`` (``repro/models/transformer.py:46-51``).

``remat`` takes ``parallel.remat`` and calls a block under it:

  * ``none``: no checkpoint; the block's activations are kept;
  * ``full``: ``torch.utils.checkpoint`` (non-reentrant): nothing is
    saved, the backward recomputes the whole block (the reference's
    ``nothing_saveable``);
  * ``dots``: the same checkpoint with a selective policy, the reference's
    ``dots_with_no_batch_dims_saveable``: the outputs of the products
    without a batch dimension are saved, everything else is recomputed.
    Those products are the tiled matmul (``repro_torch::tiled_matmul``, the
    MLP projections) and ``aten.mm`` (the QKV/O projections, rglru's gates
    and in/out projections, mamba2's projections, the MoE router).
    Batched products (``aten.bmm``: the attention scores, the SSD
    einsums, the MoE experts' ``gecd,edf``, whose ``e`` is a batch dim in
    the reference too) are recomputed, and so is flash attention, whose
    kernel an ``autograd.Function`` launches outside the dispatcher: its
    forward runs again in the backward, as the reference recomputes its
    batched attention products.

A product without a batch dim must reach the dispatcher as ``mm`` (``x @
w`` with a 2-D ``w``) or as the tiled matmul to be saved: a
``torch.einsum`` dispatches to ``bmm`` even with a batch of one.

The policy saves every such product, as ``dots_with_no_batch_dims_saveable``
names them; the reference's partial evaluation then keeps only those its
backward reads. A block's last product (the MLP's down projection,
mamba2's out projection) feeds only the residual sum that leaves the
block, so the reference keeps no residual for it while the port holds it
until the block's backward: one (tokens, d_model) product per block more
than the reference. Not saving it would rerun its kernel in the
recompute instead: a non-reentrant checkpoint re-saves an op's inputs
only by running the op again.

The selective policy sees each op of a checkpointed block through a
Python dispatch mode, in the forward and again in the recompute: a host
cost per op, which ``full`` does not pay (PERF.md measures both).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels import ops  # noqa: F401 (registers repro_torch::tiled_matmul)

# the dispatcher ops whose outputs ``dots`` saves
SAVEABLE = frozenset({torch.ops.aten.mm.default, torch.ops.repro_torch.tiled_matmul.default})


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Save the products without a batch dim, recompute the rest."""
    if op in SAVEABLE:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def dots_context():
    """The selective checkpoint contexts of one ``dots`` block."""
    return create_selective_checkpoint_contexts(dots_policy)


def remat(policy: str, fn, *args):
    """``fn(*args)`` under the checkpoint ``policy`` (``none``, ``full`` or
    ``dots``, as ``ParallelConfig`` checks it)."""
    if policy == "none":
        return fn(*args)
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=dots_context)
