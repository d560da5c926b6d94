"""Explicit ZeRO-3 engine, dense family (``repro/core/zero.py``), one
process per data-parallel rank.

Each layer's parameters flatten into one row (``core/partition.py``
``FlatLayout``, the reference's byte order), the (L, P) bf16 ``flat``,
padded to a multiple of dp. The ranks of a ``launch/mesh.LocalMesh`` each
hold a shard of it (``partition.row_shard``), the reference's placement:

  * ``partition_mode="allgather"`` (bandwidth-centric, the paper's Sec.
    6.1): rank r holds columns ``[r * P/dp, (r+1) * P/dp)`` of every row,
    the local (L, P/dp). A layer materializes as the all-gather of its
    slices (``RowGather``: forward ``all_gather_into_tensor``, backward
    the bf16 ``reduce_scatter_tensor`` of the row's cotangent, which is
    upcast to f32 only after, as the reference's ``psum_scatter``);
  * ``"broadcast"`` (the owner baseline): rank r holds the layers ``[r *
    L/dp, (r+1) * L/dp)`` whole (L % dp == 0, as the reference asserts);
    a layer reaches the other ranks as the reference's masked psum
    (``Psum``: the owner's row, zeros elsewhere, summed; its backward sums
    the cotangents), so the gradient reaches the owner alone.

At dp = 1 the gather and its transpose are the identity and a row is used
as it is read. Each rank takes rows ``[r * B/dp, (r+1) * B/dp)`` of the
global batch; the loss is scaled by 1/dp before its sum over the ranks,
the 'other' gradients and the grad norm's sums of squares are summed over
them, the small 'other' states update alike on every rank. Two ways to
step:

  * **the monolithic step** (``make_train_step``; params on the device or
    host tier): one autograd pass over the rank's flat, the reference's
    ``sharded_step``. ``parallel.prefetch`` only reorders the gathers in
    the reference (gather(i+1) issued before compute(i)), so it changes no
    number and the port gathers in order whatever its value. In-graph
    tiers update the local flat with the fused-Adam kernel over its f32
    ``master``/``m``/``v``, the reference's partitioned in-graph update
    (``repro/core/zero.py:499-506``), and take its bf16 copy as the new
    ``flat``; off-graph tiers (``run.opt_offgraph``) return the local f32
    flat gradient for the executor's streamed Adam and advance only
    ``step`` and the small 'other' states. ``grad_compression="int8"``
    reduces the 'other' gradients through
    ``optim/compression.psum_compressed`` (the mean, scaled back by dp)
    with the rank's f32 residual ``g_err`` (a leading dim of 1: the rank's
    slice of the reference's (dp, ...) leaf).
  * **the layered epoch** (``make_layer_fns``; params on NVMe): the step
    as the pieces the executor's scheduler drives over rows streamed
    through the prefetch window (``core/executor.py``): ``embed_fwd``,
    ``layer_fwd``, ``layer_vjp`` (the layer's forward recomputed under
    autograd: the paper's "parameters loaded one additional time"),
    ``head``, ``accum_sumsq``, ``embed_vjp`` and ``finish`` (Adam on the
    small device-resident states).

Gradient dtypes follow the reference: the monolithic step differentiates
with respect to the bf16 ``flat``, so its row gradients are bf16 (summed in
bf16 where a leaf's pieces meet) and only then upcast to f32; the layered
epoch's ``layer_vjp`` carries each row's bf16 cotangent (the
reduce-scattered slice) in f32 to the grad tier.

Host tier (``param_tier="host"``, and ``opt_tier="host"`` while the
optimizer is in-graph): on the card ``flat`` and ``master``/``m``/``v``
live in page-locked CPU memory and cross to the device around the step on
the current stream (``core/engine.PinnedHostTier``); on the CPU the host
tier is the device, as the reference's host tier is on a CPU backend.

Under q8 transport (``offload.param_quant="q8"``) a layered row reaches
``layer_fwd`` and ``layer_vjp`` as its wire operands ``(q, s)``: the MLP
weights in ``quantized_leaves`` (a static plan per layout and dp) go into
the quantized-matmul kernel as they are, every other leaf is dequantized
on the device. At dp > 1 each rank's operands are its slice's, encoded in
blocks from the slice's first element; the ranks all-gather the int8
quants and fp16 scales (34 bytes a block of 32 on the collective, where
the decoded bf16 takes 64), so a row is the concatenation of the ranks'
block grids (``partition.unflatten_wire_row``). Its gradient is the
reduce-scatter of the gathered bf16 anchor row's, upcast after: the
reference's transpose of the gather of the decoded row. q4 rows reach the
pieces decoded by the store and gather as bf16 rows do.

MoE (the ``moe`` family) runs as the layered epoch only, as in the
reference: a layer's attention and norm leaves flatten into its dense row,
each expert's weights into their own expert row (``eflat``, (L * E, Pe),
row ``l * E + e``, paged as a unit of its own), and the (L, d, E) router
is a small f32 'other' state so its master stays full precision. The
layer runs as pieces: ``moe_attn`` (attention and the routing counts),
then fixed-width waves of router-selected expert rows (``moe_wave_fwd`` /
``moe_wave_vjp``) whose sum is the all-resident ``moe_ffn``, and
``moe_attn_vjp``. The monolithic step refuses MoE, as the reference's. At
dp > 1 each rank holds the (L * E, Pe/dp) column slice of ``eflat``, as
the reference's ``P(None, axis)``; ``moe_attn`` sums the routing counts
over the ranks (one all-reduce, before the executor reads them), so every
rank selects the same experts and runs the same waves; a wave's (W, Pe/dp)
slices are all-gathered along dim 1 (``LeafGather``; backward the bf16
reduce-scatter, upcast after) and the router's f32 gradient is summed over
the ranks.

``parallel.remat`` applies to the monolithic step's layers
(``models/remat.py``); the layered epoch recomputes each layer in its
reversed pass whatever the policy.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.config import RunConfig, ShapeConfig
from repro_torch.core import partition as pt
from repro_torch.core.engine import PinnedHostTier
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_mod
from repro_torch.models import remat as remat_mod
from repro_torch.models import transformer
from repro_torch.models.transformer import TensorSpec
from repro_torch.optim import adam as adam_mod
from repro_torch.optim import compression
from repro_torch.runtime import trace


class RowGather(torch.autograd.Function):
    """A layer's row from the ranks' slices: forward the all-gather of the
    (P/dp,) slices into the (P,) row, backward the reduce-scatter (a sum,
    in the cotangent's dtype) of the row's cotangent into this rank's
    slice: the reference's ``all_gather`` and its transpose."""

    @staticmethod
    def forward(ctx, piece, mesh):
        ctx.mesh = mesh
        return mesh.all_gather(piece)

    @staticmethod
    def backward(ctx, ct):
        return ctx.mesh.reduce_scatter(ct), None


class LeafGather(torch.autograd.Function):
    """A GSPMD leaf from the ranks' shards along ``dim``: forward the
    all-gather of the shards over ``axis`` (None: every rank; the GSPMD
    engine's ZeRO gathers run over ``"data"``), backward the
    reduce-scatter (a sum, in the cotangent's dtype: bf16 for bf16
    leaves) of the leaf's cotangent into this rank's shard, the transpose
    XLA emits for a ZeRO-3 leaf (``core/engine.py``). Context parallelism
    gathers the leaves split over ``"model"`` so, and its K/V along the
    sequence (``ModelAxis``)."""

    @staticmethod
    def forward(ctx, shard, mesh, dim, axis=None):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return mesh.all_gather(shard, dim, axis)

    @staticmethod
    def backward(ctx, ct):
        return ctx.mesh.reduce_scatter(ct, ctx.dim, ctx.axis), None, None, None


class ToModel(torch.autograd.Function):
    """Forward the identity, backward the all-reduce of the cotangent over
    the model axis: what enters a column-parallel product (each model
    rank's part of the input's gradient summed), Megatron's ``f``."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ctx.mesh.all_reduce(ct, "model"), None


class FromModel(torch.autograd.Function):
    """Forward the all-reduce over the model axis, backward the identity:
    a row-parallel product's partial sums joined (Megatron's ``g``), the
    vocab-parallel embedding's rows and cross-entropy's sums."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x, "model")

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class ModelSum(torch.autograd.Function):
    """Forward the all-reduce over the model axis, backward the all-reduce
    of the cotangent over it: a statistic summed over the model ranks'
    parts of a split dim (the gated RMS norm's sum of squares over the
    SSM's ``inner`` channels) that each rank then uses on its own part, so
    each rank's cotangent of it is partial. ``FromModel``'s identity
    backward would keep the rank's own alone."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x, "model")

    @staticmethod
    def backward(ctx, ct):
        return ctx.mesh.all_reduce(ct, "model"), None


class ModelAxis:
    """A rank's model-parallel context, what ``models/common.py``,
    ``models/transformer.py``, ``models/moe.py``, ``models/mamba2.py`` and
    ``models/rglru.py`` take as ``mp`` (None at one model rank): the mesh
    (its ``"model"`` group), this rank's model coordinate ``rank`` among
    ``size`` and the attention ``strategy`` of
    ``partition.choose_attn_strategy``: ``"tp"`` (heads, MLP columns,
    vocab rows and the recurrent blocks' ``inner`` channels split over the
    model ranks, Megatron's explicit collectives) or ``"cp"`` (each rank
    its ``S / size`` chunk of the sequence; the leaves split over model
    gathered before use, but MoE's experts and the ``inner`` channels,
    whose block gathers the sequence instead). ``chunked`` says, under
    ``"cp"``, whether a call's activations are the rank's chunk of the
    sequence (training, and a prompt that splits over the ranks) or the
    whole of it on every model rank (``whole()``: a prompt that does not
    split, the reference's divisibility guard, and a decode step's one
    token). ``inner`` says whether the recurrent blocks' ``inner``
    channels split over the model ranks (the engine reads it from the
    rules, which leave a dim whole that does not divide); where they do
    not, a recurrent block runs whole on every rank."""

    def __init__(self, mesh, strategy: str, chunked: bool = True, inner: bool = False):
        self.mesh, self.strategy, self.chunked, self.inner = mesh, strategy, chunked, inner
        self.rank, self.size = mesh.coords()["model"], mesh.model

    @property
    def tp(self) -> bool:
        return self.strategy == "tp"

    @property
    def seq(self) -> bool:
        """Whether the activations are the rank's chunk of the sequence."""
        return self.strategy == "cp" and self.chunked

    def whole(self) -> "ModelAxis":
        """This rank's context for a call whose activations are whole."""
        return ModelAxis(self.mesh, self.strategy, chunked=False, inner=self.inner)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Before a column-parallel product (``ToModel``)."""
        return ToModel.apply(x, self.mesh)

    def join(self, x: torch.Tensor) -> torch.Tensor:
        """After a row-parallel product: the partial sums' all-reduce
        (``FromModel``)."""
        return FromModel.apply(x, self.mesh)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The model ranks' ``t`` along ``dim`` (``LeafGather`` over model:
        backward the reduce-scatter)."""
        return LeafGather.apply(t, self.mesh, dim, "model")

    def scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The model ranks' partial ``t`` summed, this rank's chunk along
        ``dim`` (``ScatterModel``: backward the all-gather)."""
        return ScatterModel.apply(t, self.mesh, dim)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the model ranks, backward the sum of their
        cotangents (``ModelSum``)."""
        return ModelSum.apply(t, self.mesh)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the model ranks (no gradient)."""
        return self.mesh.all_reduce(t.detach(), "model", op="max")

    def stack(self, t: torch.Tensor) -> torch.Tensor:
        """``(size, *t.shape)``: the model ranks' ``t`` in rank order (no
        gradient)."""
        return self.mesh.all_gather(t.detach()[None], 0, "model")


class ScatterModel(torch.autograd.Function):
    """Forward the reduce-scatter over the model axis along ``dim`` (the
    ranks' partial sums summed, each rank its chunk), backward the
    all-gather of the chunks' cotangents: the expert-parallel MoE's join
    under context parallelism, ``LeafGather``'s transpose."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.reduce_scatter(x, dim, "model")

    @staticmethod
    def backward(ctx, ct):
        return ctx.mesh.all_gather(ct, ctx.dim, "model"), None, None


class Psum(torch.autograd.Function):
    """The sum of the ranks' tensors, backward the sum of their cotangents
    (the reference's ``psum`` and its transpose); the broadcast baseline's
    layer, each rank's piece its row or zeros."""

    @staticmethod
    def forward(ctx, piece, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(piece)

    @staticmethod
    def backward(ctx, ct):
        return ctx.mesh.all_reduce(ct), None


def _psum(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over ``mesh``'s ranks (the reference's ``psum``); ``t``
    itself at one rank."""
    return t if mesh is None else mesh.all_reduce(t)


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.to("cpu")


def _trace_wrap_fns(fns: dict) -> dict:
    """Each piece in a compute span. On the card the span covers the
    host's launches; the executor's ``device_sync`` span is where the
    device work lands on the critical path."""
    return {name: trace.wrap(name, fn, sys="compute", attr="compute")
            for name, fn in fns.items()}


class ExplicitZero3Engine:
    """ZeRO-3 with explicit rows, one rank of ``mesh`` (None: one rank),
    at every tier placement the reference's explicit engine takes. In-graph
    tiers keep the rank's f32 ``master``/``m``/``v`` shard in the state;
    off-graph tiers (``opt_offgraph``) keep them in the executor's stores.
    The small 'other' states (embedding, final norm) stay on the device
    with their Adam state, whole on every rank."""

    def __init__(self, run: RunConfig, device="cuda", mesh=None):
        cfg = run.model
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"explicit engine: family {cfg.family!r}: dense and moe "
                "families only, as the reference")
        self.is_moe = cfg.family == "moe"
        if self.is_moe and run.offload.param_tier != "nvme":
            raise ValueError(
                "explicit-engine MoE requires param_tier='nvme': expert rows "
                "page through the layered scheduler; use the pjit engine for "
                "all-resident MoE")
        self.run = run
        self.device = torch.device(device)
        self.mesh = mesh
        self.dp = mesh.world if mesh is not None else 1
        self.rank = mesh.rank if mesh is not None else 0
        self.mode = run.parallel.partition_mode
        if self.dp > 1 and self.mode == "broadcast" and cfg.n_layers % self.dp:
            raise ValueError(
                "broadcast (owner) mode needs n_layers % dp == 0 - and that is "
                "the point: single-owner placement does not scale; use "
                "partition_mode='allgather' (bandwidth-centric) at scale.")
        self.offgraph = run.opt_offgraph
        self.layered = run.offload.param_tier == "nvme"
        # the host tier is page-locked CPU memory on the card, the device
        # itself on the CPU
        pinned = self.device.type == "cuda"
        self.param_host = run.offload.param_tier == "host" and pinned
        self.opt_host = run.offload.opt_tier == "host" and pinned and not self.offgraph
        self.host = PinnedHostTier(self.device)
        if self.is_moe:
            self.block_fn = None  # MoE layers run as make_layer_fns pieces
            self.defs = moe_mod.param_defs(cfg)
        else:
            self.block_fn = transformer.make_block_fn(cfg, run.parallel)
            self.defs = transformer.param_defs(cfg)
        self.n_layers = cfg.n_layers
        self._build_layout()
        # the MLP weights whose products read the q8 wire row in place;
        # fixed by the layout, the same for every row and step
        self.quantized_leaves = (pt.quantized_leaf_plan(self.layout, self.dp)
                                 if run.offload.param_quant == "q8" else ())

    def _dense_blocks(self, blocks: dict) -> dict:
        """The per-layer leaves of the dense row: for MoE all but the
        ``moe`` subtree (expert rows and router page and update apart)."""
        if self.is_moe:
            return {k: v for k, v in blocks.items() if k != "moe"}
        return blocks

    def _build_layout(self) -> None:
        self.layout = pt.build_layout(self._dense_blocks(self.defs["blocks"]), self.dp)
        if self.is_moe:
            # one flat row per (layer, expert), split like the dense rows
            cfg = self.run.model
            rdefs = moe_mod.expert_row_defs(cfg)
            self.elayout = pt.build_layout(pt.tree_map(
                lambda d: pt.ParamDef((1,) + d.shape, (None,) + d.axes, d.dtype,
                                      d.init, d.init_scale), rdefs), self.dp)
            self.n_experts = cfg.n_experts
            self.top_k = cfg.top_k

    def _flatten_experts(self, moe_params: dict) -> torch.Tensor:
        """The ``moe`` subtree (leaves (L, E, ...)) -> the (L * E, Pe) bf16
        expert rows, row ``l * E + e``."""
        LE = self.n_layers * self.n_experts
        sub = {n: moe_params[n].reshape((LE,) + tuple(moe_params[n].shape[2:]))
               for n in moe_mod.expert_leaf_names(self.run.model)}
        return pt.flatten_blocks(sub, self.elayout, torch.bfloat16)

    def _other_defs(self) -> dict:
        """The small device-resident ('other') states: embeddings, the final
        norm and, for MoE, the stacked (L, d, E) f32 router."""
        out = {"embed": self.defs["embed"], "ln_f": self.defs["ln_f"]}
        if self.is_moe:
            out["router"] = self.defs["blocks"]["moe"]["router"]
        return out

    # ------------------------------------------------------------------
    # state and data interface
    # ------------------------------------------------------------------

    @property
    def grad_compress(self) -> bool:
        """int8 + error feedback on the 'other' gradients' reduce
        (``optim/compression.py``), its residual carried as ``g_err``."""
        return self.run.parallel.grad_compression == "int8"

    def g_err_zeros(self) -> dict:
        """Fresh error-feedback residuals: one f32 zero copy of each
        'other' leaf, with a leading dim of 1, this rank's slice of the
        reference's (dp, ...) stack (each rank's residual is its own
        quantization error, never reduced)."""
        return pt.tree_map(
            lambda d: torch.zeros((1,) + tuple(d.shape), dtype=torch.float32,
                                  device=self.device),
            self._other_defs())

    def shard_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """This rank's part of global (L, P) rows (``partition.row_shard``
        under the partition mode); the rows themselves at dp = 1."""
        if self.dp == 1:
            return rows
        return pt.row_shard(rows, self.rank, self.dp, self.mode).contiguous()

    @property
    def local_shape(self) -> tuple:
        """The rank's (L, P/dp) (allgather) or (L/dp, P) (broadcast) flat."""
        L, P = self.n_layers, self.layout.padded
        return (L, P // self.dp) if self.mode == "allgather" else (L // self.dp, P)

    def init_state(self, generator: torch.Generator) -> dict:
        """``{"flat": the rank's bf16 rows, "other", "other_opt", "step"}``,
        plus ``g_err`` under int8 compression and the f32 ``master`` (the
        flat's copy) and zero ``m``/``v`` while the optimizer is in-graph;
        the global state drawn from ``generator`` (on the engine's device,
        the same on every rank), the rank's shard kept, placed by
        ``place_state``."""
        params = pt.init_tree(self.defs, generator, self.device)
        other = {"embed": params["embed"], "ln_f": params["ln_f"]}
        if self.is_moe:
            other["router"] = params["blocks"]["moe"]["router"].float()
        state = {
            "flat": self.shard_rows(pt.flatten_blocks(self._dense_blocks(params["blocks"]),
                                                      self.layout, torch.bfloat16)),
            "other": other,
            "other_opt": adam_mod.init_state(other),
            "step": torch.zeros((), dtype=torch.int32, device=self.device),
        }
        if self.is_moe:  # the rank's column slice, as the dense rows'
            eflat = self._flatten_experts(params["blocks"]["moe"])
            state["eflat"] = (eflat if self.dp == 1 else
                              pt.row_shard(eflat, self.rank, self.dp, "allgather").contiguous())
        return self.place_state(self.complete_state(state))

    @property
    def portable_keys(self) -> tuple:
        """The tier-independent leaves of this engine's state."""
        return ("flat", "other", "other_opt", "step") + (("eflat",) if self.is_moe else ())

    def complete_state(self, state: dict) -> dict:
        """The tier-independent leaves (``flat``, ``other``, ``other_opt``,
        ``step``) plus what this placement adds around them: a zero
        ``g_err`` under int8 compression; in-graph, the flat's f32 copy as
        ``master`` and zero moments. (A checkpoint carries neither the
        rank-local residual nor, on a migration, the moments.)"""
        state = {k: state[k] for k in self.portable_keys}
        if self.grad_compress:
            state["g_err"] = self.g_err_zeros()
        if not self.offgraph:
            flat32 = state["flat"].to(self.device).float()
            state.update(master=flat32, m=torch.zeros_like(flat32),
                         v=torch.zeros_like(flat32))
        return state

    def gather_state(self, state: dict) -> Optional[dict]:
        """The global state of the rank's materialized ``state``, the
        leaves the reference's checkpoint of it holds: on rank 0 the rows
        (``flat``, in-graph ``master``/``m``/``v``, MoE's ``eflat``)
        all-gathered over the ranks, one leaf at a time, each handed to
        the CPU as it is gathered; ``g_err`` as the reference's (dp, ...)
        stack of the ranks' residuals; ``other``, ``other_opt`` and
        ``step`` as they are (equal on every rank). None on every other
        rank, which holds at most one leaf's global rows at once. The
        identity at dp = 1."""
        if self.dp == 1:
            return state
        keep = self.rank == 0
        out = {}
        for key, val in state.items():
            if key in ("flat", "master", "m", "v", "eflat"):
                val = self.gather_rows(key, val)
            elif key == "g_err":
                val = pt.tree_map(lambda t: self.mesh.all_gather(t.to(self.device)), val)
            if keep:
                out[key] = (adam_mod.AdamState(*(pt.tree_map(_cpu, t) for t in val))
                            if key == "other_opt" else pt.tree_map(_cpu, val))
        return out if keep else None

    def shard_state(self, state: dict) -> dict:
        """A global state (a checkpoint's, its rows re-padded for this dp
        by ``runtime/elastic.adapt_state_layout``) -> this rank's part of
        it (``bridge.shard_zero3_state``: the rows as ``partition.row_shard``
        cuts them, MoE's expert rows by columns, ``g_err``'s row of this
        rank, the rest as it is); ``g_err`` restarts at zero where the
        checkpoint was written at another dp (each rank's residual is its
        own quantization error, not portable)."""
        from repro_torch.bridge import shard_zero3_state

        same_dp = all(t.shape[0] == self.dp for t in pt.tree_leaves(state.get("g_err", {})))
        out = shard_zero3_state(dict(state), self.rank, self.dp, self.mode)
        if not same_dp:
            out["g_err"] = self.g_err_zeros()
        return out

    def place_state(self, state: dict) -> dict:
        """``state``'s leaves where this engine keeps them: the host-tier
        ``flat`` and ``master``/``m``/``v`` in pinned CPU memory on the
        card; the layered epoch's ``flat`` on the CPU (the executor seeds
        the param store from it); everything else on the device."""
        dev = lambda tree: pt.tree_map(lambda t: t.to(self.device), tree)
        out = {}
        for key, val in state.items():
            if isinstance(val, TensorSpec):
                out[key] = val
            elif key == "other_opt":
                out[key] = adam_mod.AdamState(*(dev(t) for t in val))
            elif key in ("flat", "eflat") and self.layered:
                out[key] = val.to("cpu")
            elif (key == "flat" and self.param_host) or (
                    key in ("master", "m", "v") and self.opt_host):
                out[key] = self.host.pin(val)
            else:
                out[key] = dev(val)
        return out

    def host_ready(self) -> None:
        """Wait for the last step's write-backs into the pinned host tier."""
        self.host.ready()

    def input_specs(self, shape: ShapeConfig) -> dict:
        B, S = shape.global_batch, shape.seq_len
        return {"tokens": TensorSpec((B, S), torch.int32),
                "labels": TensorSpec((B, S), torch.int32)}

    def n_params_active(self) -> int:
        other = sum(math.prod(d.shape) for d in pt.tree_leaves(self._other_defs()))
        blocks = sum(self.layout.sizes) * self.n_layers
        if self.is_moe:  # only the top_k routed experts are active
            blocks += sum(self.elayout.sizes) * self.top_k * self.n_layers
        return blocks + other

    def _row_dim(self, key: str) -> int:
        """The dim along which the ranks' parts of ``key``'s rows join:
        the columns (allgather mode, and MoE's expert rows always) or the
        layers (broadcast mode)."""
        return 1 if key == "eflat" or self.mode == "allgather" else 0

    def gather_rows(self, key: str, rows: torch.Tensor) -> torch.Tensor:
        """The global rows of the rank's part ``rows`` of ``key`` (``flat``
        and its ``master``/``m``/``v``, or ``eflat``): their all-gather
        over the ranks, on the device. The rows themselves at dp = 1."""
        if self.dp == 1:
            return rows
        return self.mesh.all_gather(rows.to(self.device), self._row_dim(key))

    def params_from_state(self, state: dict) -> dict:
        """The bundle-shaped param tree rebuilt from an engine state with
        materialized rows (``InfinityExecutor.checkpoint_state``): the
        eval path, the bundle's prefill after a layered run. At dp > 1
        every rank calls it, on its own rows: they are all-gathered over
        the ranks first, so each rank gets dp 1's tree."""
        state = dict(state)
        for key in ("flat", "eflat") if self.is_moe else ("flat",):
            state[key] = self.gather_rows(key, state[key])
        rows = [pt.unflatten_row(r, self.layout) for r in state["flat"]]
        blocks: dict = {}
        for path in self.layout.paths:
            pt.tree_set(blocks, path, torch.stack([pt.tree_get(r, path) for r in rows]))
        if self.is_moe:
            L, E = self.n_layers, self.n_experts
            erows = [pt.unflatten_row(r, self.elayout) for r in state["eflat"]]
            moe_p = {p[0]: torch.stack([pt.tree_get(r, p) for r in erows]).reshape(
                (L, E) + tuple(pt.tree_get(erows[0], p).shape))
                for p in self.elayout.paths}
            moe_p["router"] = state["other"]["router"].float()
            blocks["moe"] = moe_p
        return {"embed": state["other"]["embed"], "blocks": blocks,
                "ln_f": state["other"]["ln_f"]}

    def layer_row_device(self) -> torch.device:
        """Where the rank's slice of a layer row lives: the engine's
        device."""
        return self.device

    # ------------------------------------------------------------------
    # the monolithic step (params on the device or host tier)
    # ------------------------------------------------------------------

    def make_train_step(self, *, grads_only: bool = None):
        """``step(state, batch)``, the reference's ``sharded_step`` on this
        rank's flat and batch slice. ``grads_only=None`` resolves from the
        tiers (``opt_offgraph``). In-graph -> ``(new_state, {loss,
        grad_norm, lr})`` with the flat updated through the fused-Adam
        kernel (its master/m/v in place); with ``grads_only`` ->
        ``(new_state, g32, metrics)``, ``g32`` the rank's f32 flat gradient
        (its reduce-scattered shard), ``new_state`` the old ``flat`` with
        ``step`` and 'other' advanced. Metrics are 0-d device tensors, the
        same on every rank; ``lr`` is the new step's (``adam.lr_at``)."""
        if grads_only is None:
            grads_only = self.offgraph
        if self.is_moe:
            raise NotImplementedError(
                "explicit-engine MoE has no monolithic step: expert rows page "
                "through the layered epoch (param_tier='nvme' + "
                "make_layer_fns)")
        pc, tc, cfg = self.run.parallel, self.run.train, self.run.model
        L, dp, layout, block_fn = self.n_layers, self.dp, self.layout, self.block_fn
        mesh, rank = self.mesh, self.rank
        remat = pc.remat
        compress = self.grad_compress
        param_host = self.param_host
        opt_host = self.opt_host and not grads_only
        host = self.host
        lpr = L // dp  # broadcast: the layers each rank owns

        def gather_layer(rows, i):
            """Layer i's (P,) row on every rank, from the rank's rows."""
            if dp == 1:  # the gather and its transpose are the identity
                return rows[i]
            if self.mode == "allgather":
                return RowGather.apply(rows[i], mesh)
            # broadcast: the owner's row, zeros on the other ranks, summed
            # (the reference's masked psum); the zeros stay in the graph so
            # every rank takes part in the backward's sum
            owner, local = i // lpr, min(max(i - rank * lpr, 0), lpr - 1)
            piece = rows[local]
            if rank != owner:
                piece = torch.where(torch.zeros((), dtype=torch.bool, device=piece.device),
                                    piece, torch.zeros_like(piece))
            return Psum.apply(piece, mesh)

        def body_core(x, row, positions):
            return block_fn(x, pt.unflatten_row(row, layout, torch.bfloat16), positions)

        def local_loss(flat, other, batch):
            x = cm.embed(other["embed"], batch["tokens"], cfg)
            B, S, _ = x.shape
            positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
            # one unbind: the flat's gradient is one stack of the rows'
            # (indexing a row would add a full-size zero gradient per layer)
            rows = flat.unbind(0)
            for i in range(L):
                row = gather_layer(rows, i)
                x = remat_mod.remat(remat, body_core, x, row, positions)
            x = cm.norm(x, other["ln_f"], cfg.norm_kind)
            lg = cm.logits(other["embed"], x, cfg)
            return cm.lm_loss(lg[:, :-1], batch["labels"][:, 1:], cfg.vocab_size)

        def value_and_grad(flat, other, batch):
            with torch.enable_grad():
                flat_ = flat.detach().requires_grad_()
                o = pt.tree_map(lambda t: t.detach().requires_grad_(), other)
                paths = pt.tree_paths(o)
                # scaled by 1/dp before the cross-rank sum
                loss_s = local_loss(flat_, o, batch) / dp
                grads = torch.autograd.grad(loss_s, [flat_] + pt.tree_leaves(o))
            g_other: dict = {}
            for path, g in zip(paths, grads[1:]):
                pt.tree_set(g_other, path, g)
            return _psum(mesh, loss_s.detach()), grads[0], g_other

        def reduce_other(g_other, g_err):
            """The 'other' gradients' cross-rank sum, or the int8 wire format
            with error feedback (the mean, scaled back by dp), each leaf's
            residual in its rank's slice."""
            if not compress:
                return pt.tree_map(lambda g: _psum(mesh, g), g_other), None
            red: dict = {}
            errs: dict = {}
            for path in pt.tree_paths(g_other):
                g = pt.tree_get(g_other, path)
                r, ne = compression.psum_compressed(g, pt.tree_get(g_err, path)[0], mesh)
                pt.tree_set(red, path, (r.float() * dp).to(g.dtype))
                pt.tree_set(errs, path, ne.float()[None])
            return red, errs

        def step(state, batch):
            flat, other = state["flat"], state["other"]
            if param_host:  # pinned host -> the device, ahead of the forward
                flat = host.to_device(flat)
            loss, g_flat, g_other = value_and_grad(flat, other, batch)
            g_other, new_g_err = reduce_other(g_other, state.get("g_err"))
            new_step = state["step"] + 1
            lr = adam_mod.lr_at(tc, new_step)
            g32 = g_flat.float()  # the bf16 cotangent, upcast as the reference's
            gnorm = torch.sqrt(_psum(mesh, torch.sum(g32 ** 2)) + sum(
                torch.sum(g.float() ** 2) for g in pt.tree_leaves(g_other)))
            metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
            new_other, new_other_opt = adam_mod.apply_updates(
                g_other, state["other_opt"], tc, params_prev=other)
            new_state = {"flat": state["flat"], "other": new_other,
                         "other_opt": new_other_opt, "step": new_step}
            if new_g_err is not None:
                new_state["g_err"] = new_g_err
            if grads_only:  # the executor's streamed Adam updates the flat
                return new_state, g32, metrics
            # the flat's AdamW on its f32 master and moments, in place
            keys = ("master", "m", "v")
            master, m, v = (host.to_device(state[k]) if opt_host else state[k]
                            for k in keys)  # pinned host -> the device
            new_flat = ops.fused_adam(master, g32, m, v,
                                      adam_mod.update_scalars(tc, new_step))
            if opt_host:  # updated masters and moments back to their pinned tensors
                master, m, v = (host.write_back(state[k], t)
                                for k, t in zip(keys, (master, m, v)))
            if param_host:  # the updated bf16 rows back likewise
                new_flat = host.write_back(state["flat"], new_flat)
            new_state.update(flat=new_flat, master=master, m=m, v=v)
            return new_state, metrics

        return step

    # ------------------------------------------------------------------
    # per-layer pieces for the scheduler-driven layered epoch
    # ------------------------------------------------------------------

    def make_layer_fns(self) -> dict:
        """The layered step's pieces (``repro/core/zero.py:599``) over the
        rank's (P/dp,) row slices and batch slice. Forward pieces run
        without autograd; ``layer_vjp`` and ``head`` record only their own
        graph and return gradients (``torch.autograd.grad``). At dp > 1 a
        row is gathered before its layer (``RowGather``: ``layer_vjp``'s
        row gradient is the reduce-scattered slice), and ``head``'s loss
        and 'other' gradients, ``accum_sumsq``'s sum of squares and
        ``embed_vjp``'s gradients are summed over the ranks."""
        if self.run.parallel.partition_mode != "allgather":
            raise ValueError(
                "layered epochs need the bandwidth-centric (allgather) row "
                "layout; the broadcast baseline stores whole layers per owner")
        if self.grad_compress:
            raise ValueError(
                "grad_compression='int8' wires into the monolithic step's "
                "replicated-grad reduce; the layered epoch's per-row reduce-"
                "scatter is implicit in the all-gather transpose and is not "
                "compressed - run it with grad_compression='none'")
        cfg, tc, dp, mesh = self.run.model, self.run.train, self.dp, self.mesh
        block_fn, layout, plan = self.block_fn, self.layout, self.quantized_leaves

        def _unflatten(row, anchor=None):
            """``row``: a bf16 row, or a q8 wire row ``(q, s)`` whose
            gradient ``anchor`` (a zero row) carries; at dp > 1 the rank's
            slice of either, gathered here (a wire row as its quants and
            scales, the anchor as a bf16 row)."""
            if isinstance(row, tuple):
                q, s = row
                if dp > 1:
                    q, s = mesh.all_gather(q), mesh.all_gather(s)
                    if anchor is not None:
                        anchor = RowGather.apply(anchor, mesh)
                return pt.unflatten_wire_row(q, s, anchor, layout, plan, dp)
            if dp > 1:
                row = RowGather.apply(row, mesh)
            return pt.unflatten_row(row, layout, torch.bfloat16)

        def _positions(x):
            B, S = x.shape[0], x.shape[1]
            return torch.arange(S, device=x.device)[None, :].expand(B, S)

        def _grad_row(row, device):
            """(the leaf that takes a row's gradient, the row's leaves read
            through it), under autograd: a bf16 row (slice) is its own leaf,
            its gradient the reduce-scattered slice; a wire row takes no
            gradient itself and a zero row (slice) stands in for it
            (``unflatten_wire_row``)."""
            if isinstance(row, tuple):
                anchor = torch.zeros(layout.padded // dp, dtype=torch.bfloat16,
                                     device=device, requires_grad=True)
                return anchor, _unflatten(row, anchor)
            row_ = row.detach().requires_grad_()
            return row_, _unflatten(row_)

        def _grad_leaves(tree):
            return pt.tree_map(lambda t: t.detach().requires_grad_(), tree)

        def _as_tree(paths, grads, like):
            out: dict = {}
            for path, g in zip(paths, grads):
                pt.tree_set(out, path, g if g is not None
                            else torch.zeros_like(pt.tree_get(like, path)))
            return out

        @torch.no_grad()
        def _embed_fwd(other, tokens):
            return cm.embed(other["embed"], tokens, cfg)

        @torch.no_grad()
        def _layer_fwd(x, row):
            return block_fn(x, _unflatten(row), _positions(x))

        def _layer_vjp(x, row, dy):
            with torch.enable_grad():
                x_ = x.detach().requires_grad_()
                row_, blk = _grad_row(row, x.device)
                y = block_fn(x_, blk, _positions(x))
                dx, drow = torch.autograd.grad(y, (x_, row_), dy)
            # the bf16 row's cotangent, carried in f32 to the grad tier
            return dx, drow.float()

        def _head(x, other, labels):
            with torch.enable_grad():
                x_ = x.detach().requires_grad_()
                o = _grad_leaves(other)
                h = cm.norm(x_, o["ln_f"], cfg.norm_kind)
                lg = cm.logits(o["embed"], h, cfg)
                # scaled by 1/dp before the cross-rank sum
                loss_s = cm.lm_loss(lg[:, :-1], labels[:, 1:], cfg.vocab_size) / dp
                paths = pt.tree_paths(o)
                grads = torch.autograd.grad(loss_s, [x_] + pt.tree_leaves(o),
                                            allow_unused=True)
            g_other = pt.tree_map(lambda g: _psum(mesh, g), _as_tree(paths, grads[1:], other))
            return _psum(mesh, loss_s.detach()), grads[0], g_other

        @torch.no_grad()
        def _accum_sumsq(acc, g_row):
            # one sum over the ranks per row: the norm stays on the device
            return acc + _psum(mesh, torch.sum(g_row.float() ** 2))

        def _embed_vjp(other, tokens, dx0):
            with torch.enable_grad():
                o = _grad_leaves(other)
                x = cm.embed(o["embed"], tokens, cfg)
                paths = pt.tree_paths(o)
                grads = torch.autograd.grad(x, pt.tree_leaves(o), dx0,
                                            allow_unused=True)
            return pt.tree_map(lambda g: _psum(mesh, g), _as_tree(paths, grads, other))

        @torch.no_grad()
        def _finish(other, other_opt, step, g_head, g_emb, sumsq_flat):
            paths = pt.tree_paths(g_head)
            g_other: dict = {}
            for path in paths:
                pt.tree_set(g_other, path, pt.tree_get(g_head, path)
                            + pt.tree_get(g_emb, path))
            new_step = step + 1
            lr = adam_mod.lr_at(tc, new_step)
            gnorm = torch.sqrt(sumsq_flat + sum(
                torch.sum(g.float() ** 2) for g in pt.tree_leaves(g_other)))
            new_other, new_other_opt = adam_mod.apply_updates(
                g_other, other_opt, tc, params_prev=other)
            return new_other, new_other_opt, new_step, {"grad_norm": gnorm, "lr": lr}

        fns = {"embed_fwd": _embed_fwd, "head": _head,
               "accum_sumsq": _accum_sumsq, "embed_vjp": _embed_vjp,
               "finish": _finish}
        if not self.is_moe:
            fns.update(layer_fwd=_layer_fwd, layer_vjp=_layer_vjp)
            return _trace_wrap_fns(fns)

        # ---- MoE layer pieces: the attention part + fixed-width waves ----
        # A layer materializes as its dense row (ln1 + attn + ln2) plus, per
        # wave, W expert rows as a (W, Pe) buffer (gathered from the ranks'
        # (W, Pe/dp) slices); the waves' outputs summed over a partition of
        # the selected experts are the all-resident moe_ffn (models/moe.py).
        # At dp = 1 every all-gather and psum of the reference's pieces is
        # the identity.
        group = moe_mod.DEFAULT_GROUP
        elayout = self.elayout

        def _experts(erows):
            """(W, Pe) expert rows -> per-expert leaves stacked over W."""
            out: dict = {}
            off = 0
            for path, shape, size in zip(elayout.paths, elayout.shapes, elayout.sizes):
                pt.tree_set(out, path, erows[:, off:off + size].reshape(
                    (erows.shape[0],) + tuple(shape)).to(torch.bfloat16))
                off += size
            return out

        def _xmid_of(x, blk):
            a, _ = cm.attention_block(blk["attn"], cm.norm(x, blk["ln1"], cfg.norm_kind),
                                      _positions(x), cfg, causal=True)
            return x + a

        @torch.no_grad()
        def _xmid(x, row):
            return _xmid_of(x, _unflatten(row))

        @torch.no_grad()
        def _moe_attn(x, row, router_l):
            """x_mid and the layer's routing over the global batch: (E,)
            counts (which rows to page in), the dropped and routed
            assignment counts, each summed over the ranks (one
            all-reduce)."""
            blk = _unflatten(row)
            x_mid = _xmid_of(x, blk)
            xn = cm.norm(x_mid, blk["ln2"], cfg.norm_kind)
            counts = moe_mod.moe_counts(router_l, xn, cfg, group=group)
            cap = moe_mod._capacity(cfg, min(group, x.shape[1]))
            raw = _psum(mesh, moe_mod.routing_counts(counts, cap))
            E = cfg.n_experts
            return x_mid, raw[:E], raw[E], raw[E + 1]

        def _wave_of(x_mid, blk, router_l, erows, sel_ids, sel_mask):
            xn = cm.norm(x_mid, blk["ln2"], cfg.norm_kind)
            if dp > 1:  # the ranks' (W, Pe/dp) slices -> the (W, Pe) wave
                erows = LeafGather.apply(erows, mesh, 1)
            return moe_mod.moe_ffn_selected(router_l, _experts(erows), xn, sel_ids,
                                            sel_mask, cfg, group=group)

        @torch.no_grad()
        def _wave_fwd(x_mid, row, router_l, erows, sel_ids, sel_mask):
            return _wave_of(x_mid, _unflatten(row), router_l, erows, sel_ids, sel_mask)

        def _wave_vjp(x_mid, row, router_l, erows, sel_ids, sel_mask, dy):
            """-> (dx_mid, the dense row's f32 gradient (through ln2), the
            router's f32 gradient summed over the ranks, the (W, Pe/dp) f32
            expert-row gradients: the reduce-scattered slices)."""
            with torch.enable_grad():
                xm = x_mid.detach().requires_grad_()
                row_, blk = _grad_row(row, x_mid.device)
                rt = router_l.detach().requires_grad_()
                er = erows.detach().requires_grad_()
                y = _wave_of(xm, blk, rt, er, sel_ids, sel_mask)
                dxm, drow, drt, der = torch.autograd.grad(y, (xm, row_, rt, er), dy)
            return dxm, drow.float(), _psum(mesh, drt.float()), der.float()

        def _moe_attn_vjp(x, row, dxmid):
            with torch.enable_grad():
                x_ = x.detach().requires_grad_()
                row_, blk = _grad_row(row, x.device)
                y = _xmid_of(x_, blk)
                dx, drow = torch.autograd.grad(y, (x_, row_), dxmid)
            return dx, drow.float()

        fns.update(moe_xmid=_xmid, moe_attn=_moe_attn, moe_wave_fwd=_wave_fwd,
                   moe_wave_vjp=_wave_vjp, moe_attn_vjp=_moe_attn_vjp,
                   accum_sumsq2=_accum_sumsq)
        return _trace_wrap_fns(fns)
