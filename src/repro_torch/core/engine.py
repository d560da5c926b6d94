"""ZeroInfinityEngine: RunConfig -> the family's bundle, its state, and the
GSPMD engine's train step (``repro/core/engine.py``), on one device or on
each rank of a data-parallel mesh.

On one device every sharding of the reference is the identity, so what is
left of its step (``repro/core/engine.py:139-235``) is the loss's value and
gradient over the nested param tree, accumulated over microbatches when
``parallel.grad_accum > 1``, then AdamW over every leaf through the
fused-Adam kernel (``optim/adam.py``), with the host tier's streaming
around both. ``make_train_step(grads_only=True)`` stops at the gradients:
the executor's off-graph optimizer consumes them (``core/executor.py``).
A family with step statistics (MoE: ``moe_dropped_token_fraction``, the
(E,) ``moe_expert_load``) returns them beside loss and grad norm, from the
bundle's ``loss_stats`` in the same gradient pass; on a mesh its routing
counts are summed over the ranks before the ratios are taken, so every
rank reports the global batch's statistics, as the reference's pjit step.

Gradients are bf16, the params' dtype, as the reference's
(``jax.value_and_grad`` over bf16 leaves); a leaf used twice (the tied
embedding) sums its two cotangents in bf16, as autograd accumulates in the
leaf's dtype. Only the accumulation over microbatches and the global norm
run in f32. (The explicit engine's layered epoch carries its row
gradients in f32: its convention, ``core/zero.py``.)

Host tier (``offload.param_tier="host"``, and ``opt_tier="host"`` while
the optimizer is in-graph): on the card those tensors live in page-locked
CPU memory (``PinnedHostTier``, shared with the explicit engine). A step
copies them to the device non-blocking on the current stream before use
and copies the updated values back, non-blocking, into the same pinned
tensors. Every copy rides that one stream, so a pinned tensor is never
written while its read is in flight; a host reader waits for
``host_ready()`` first. On the CPU (``device="cpu"``) the host tier is
the device, as the reference's host tier is on a CPU backend.

On a mesh (``mesh``, a ``launch/mesh.LocalMesh`` of dp > 1 ranks with a
model axis of 1, one process each) the state is what the reference's
shardings give one device. ``partition.make_rules`` lays every leaf out
for each state class (param, grad, opt) at the ZeRO stage: at stage 3 the
``"embed"`` dim of params, gradients and optimizer states is split over
the ranks, at stage 2 gradients and optimizer states, at stage 1 the
optimizer states alone, at stage 0 nothing; a dim that does not split
evenly stays whole. Each rank holds its shard of a split leaf
(``partition.shard_leaf``) and the whole of every other. A step, on the
rank's rows of the global batch (``data/pipeline.rank_batch``):

  1. gathers each split param leaf (``zero.LeafGather``: the all-gather
     of the shards along the split dim);
  2. computes the loss on the rank's rows scaled by 1/dp before the
     backward, exact for equal disjoint slices and for a batch every rank
     holds whole (the reference replicates a batch that does not split);
  3. differentiates: a gathered leaf's cotangent reduce-scatters in bf16
     (``LeafGather``'s backward, XLA's transpose of the gather); a leaf
     whole on every rank has its local gradient reduce-scattered where
     the grad spec splits it and all-reduced where it does not
     (stages 0-2), so each rank holds its grad-spec part of the global
     gradient, in the gradient's dtype;
  4. sums ``loss`` over the ranks; ``grad_norm`` from the split leaves'
     sums of squares summed over the ranks plus the whole leaves' counted
     once (rank 0's);
  5. runs fused Adam on the rank's optimizer shards (a shard of the
     gradient where the grad is whole and the optimizer split, stage 1):
     elementwise, so a shard's update is those elements of the whole
     leaf's;
  6. puts the new params back in their spec: the all-gather of the
     updated shards where params are whole and optimizer states split
     (stages 1-2).

With a model axis (``mesh.model`` = M > 1; rank r at data coordinate
``r // M``, model coordinate ``r % M``, ``launch/mesh.py``) every family
runs tensor or context parallelism, the strategy of
``partition.choose_attn_strategy`` (the reference's
``repro/core/partition.py:144-224``): each rank holds what the reference's spec gives
its device, its leaves cut along both axes (``partition.cut_leaf``), and
the bundle is built with the rank's ``zero.ModelAxis`` (``models/
common.py``'s Megatron-style collectives on the model group). The engine
keeps one set of splits per axis (``splits``: data, one tree a state
class; ``model_splits``: the model axis, the same for every class). A
step then gathers over the data axis only (context parallelism also
gathers the leaves split over model, ``mlp`` and ``vocab``, before the
loss: backward their reduce-scatter), scales the loss by 1/D (every model
rank's tensor-parallel loss is the data row's; a context-parallel rank's
is its chunk's share of it), reduces a gradient that is whole on the rank
over the axes where the ranks' contributions differ (data; and model
where every model rank computes the leaf's gradient from its own part:
every leaf whole over model under context parallelism, the unsplit KV
projections, where the experts split MoE's router and where the
``inner`` channels split mamba2's ``state`` leaves under tensor
parallelism), sums ``loss`` over the data group
(and the model group under context parallelism), and counts a leaf's
squares in ``grad_norm`` on the ranks at coordinate 0 of every axis it is
not split over. MoE's experts stay split under context parallelism too
(``models/moe.py`` sums their partial outputs), as do the SSM's and the
hybrid's ``inner`` leaves (their blocks gather the sequence and
reduce-scatter their partial outputs); MoE's routing counts
are summed over the data group alone: the model ranks of a data row route
the same tokens.

Every rank issues every collective in the same order. The step reports
each rank's state bytes (``param_shard_bytes``, ``grad_shard_bytes``,
``opt_shard_bytes`` in-graph); ``shard_bytes()`` predicts them from the
defs.

Serving on a mesh (``launch/serve.py``) keeps the rank's param shards and
nothing else of the params: ``init_params`` draws them leaf by leaf
(``partition.init_shards``: the one-rank draw's bits, no rank ever holding
the whole model), and ``serve_params`` hands a prefill or decode step a
view in which the unstacked leaves (``embed``, ``ln_f``, the encoder-
decoder's ``ln_enc``) are gathered whole for that call and each stacked
subtree (``blocks``; the hybrid's ``groups`` and ``tail``; the
encoder-decoder's ``enc`` and ``dec``) is a ``LayerShards``, whose
``layer(l)`` gathers layer ``l`` alone (each split leaf along its split
dim less one, no autograd), in one collective, not one a leaf
(``LocalMesh.all_gather_leaves``). The families read a layer through
``transformer.layer_params``, so a rank's peak is its shards, one
layer's whole leaves, the call's unstacked leaves, activations and KV:
the reference's gather once per scanned step (``repro/models/
transformer.py:5-6``). The rules never split a stacked leaf on its layer
dim (``layers`` maps to no mesh axis); the engine refuses one that would.
Under tensor parallelism serving gathers over the data axis alone: the
model shards stay split through the layer, and no param byte crosses the
model axis. Under context parallelism a layer's leaves split over model
(the MLP's columns; MoE's experts and the ``inner`` channels excepted)
and the unstacked vocab rows are gathered over the model axis too, one
collective more a layer, as training gathers them; ``model_gather_bytes`` counts what that brings in.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.config import RunConfig, ShapeConfig
from repro_torch.core import partition as pt
from repro_torch.models import registry
from repro_torch.models.transformer import TensorSpec
from repro_torch.optim import adam


def global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sum of squares over every leaf (tree order)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in pt.tree_leaves(tree)))


class PinnedHostTier:
    """The host tier's copies on the card, shared by both engines: ``pin``
    a tree (or one tensor) into page-locked CPU memory, ``to_device`` it
    non-blocking on the current stream ahead of its use, ``write_back``
    updated values non-blocking into the same pinned tensors, and
    ``ready`` waits for the last write-back before a host reader. Every
    copy rides the one stream, so a pinned tensor is never written while
    its read is in flight."""

    def __init__(self, device: torch.device):
        self.device = device
        self._written: Optional[torch.cuda.Event] = None

    @staticmethod
    def pin(tree):
        return pt.tree_map(lambda t: t.to("cpu").pin_memory(), tree)

    def to_device(self, tree):
        return pt.tree_map(lambda t: t.to(self.device, non_blocking=True), tree)

    def write_back(self, host, dev):
        """Copy ``dev``'s leaves into the pinned ``host`` tensors; returns
        ``host``."""
        for path in pt.tree_paths(host):
            pt.tree_get(host, path).copy_(pt.tree_get(dev, path), non_blocking=True)
        self._written = torch.cuda.Event()
        self._written.record()
        return host

    def ready(self) -> None:
        """Wait for the last write-back (a no-op where nothing was written
        back)."""
        if self._written is not None:
            self._written.synchronize()


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pt.tree_leaves(tree))


STATE_CLASSES = ("param", "grad", "opt")


def _stacked(defs) -> bool:
    """Whether every leaf of a subtree of defs is stacked over ``layers``."""
    return all(d.axes[:1] == ("layers",) for d in pt.tree_leaves(defs))


def _inner_split(defs, model_splits, cfg) -> bool:
    """Whether the recurrent blocks' ``inner`` leaves (the SSM's heads and
    channels, the RG-LRU's channels) split over the model ranks: the
    rules split ``inner`` where it divides, and a block's leaves must all
    split or all stay whole (a rank's channels are its heads')."""
    split = {pt.tree_get(model_splits, p) is not None
             for p, d in zip(pt.tree_paths(defs), pt.tree_leaves(defs)) if "inner" in d.axes}
    if len(split) > 1:
        raise ValueError(f"{cfg.arch}: its inner dims split differently over the model "
                         "ranks; a rank's channels must be its heads'")
    return split == {True}


def _gathered(leaves: dict, mesh, axis: str = "data") -> dict:
    """``{path: (t, dim)}`` -> ``{path: t}`` with each split leaf (dim
    not None) gathered over ``axis`` along ``dim``, all of them in one
    collective (``LocalMesh.all_gather_leaves``)."""
    split = [p for p, (_, d) in leaves.items() if d is not None]
    out = {p: t for p, (t, d) in leaves.items() if d is None}
    out.update(zip(split, mesh.all_gather_leaves([leaves[p] for p in split], axis)))
    return out


def _gather_both(leaves: dict, mesh, counter: Optional[list] = None) -> dict:
    """``{path: (t, data_dim, model_dim)}`` -> ``{path: t}``: each leaf
    gathered over the data axis where it is split there, then over the
    model axis where ``model_dim`` is given (one collective an axis);
    ``counter[0]`` grows by the bytes the model gather brings in."""
    out = _gathered({p: (t, d) for p, (t, d, _) in leaves.items()}, mesh)
    if any(m is not None for _, _, m in leaves.values()):
        model = {p: (out[p], m) for p, (_, _, m) in leaves.items()}
        out = _gathered(model, mesh, "model")
        if counter is not None:
            counter[0] += sum(out[p].numel() * out[p].element_size() - t.numel() * t.element_size()
                              for p, (t, m) in model.items() if m is not None)
    return out


class LayerShards:
    """A stacked subtree of the rank's param shards, read a layer at a
    time (``transformer.layer_params`` calls ``layer``): each leaf's slice
    of layer ``l``, gathered over the data axis along its split dim less
    one where it is split (the layer's split leaves in one collective), as
    it is where it is not. A model shard stays the rank's, but where
    ``model_splits`` names its dim (context parallelism's whole leaves):
    then it is gathered over the model axis too, in one more collective,
    and ``counter[0]`` counts the bytes that brings in. Forward only:
    serving runs under ``no_grad``."""

    def __init__(self, shards: dict, splits: dict, mesh, model_splits=None, counter=None):
        self.shards, self.splits, self.mesh = shards, splits, mesh
        self.model_splits, self.counter = model_splits, counter

    def layer(self, l: int) -> dict:
        leaves = {}
        for path in pt.tree_paths(self.shards):
            dim = pt.tree_get(self.splits, path)
            mdim = None if self.model_splits is None else pt.tree_get(self.model_splits, path)
            leaves[path] = (pt.tree_get(self.shards, path)[l], None if dim is None else dim - 1,
                            None if mdim is None else mdim - 1)
        out: dict = {}
        for path, t in _gather_both(leaves, self.mesh, self.counter).items():
            pt.tree_set(out, path, t)
        return out


class ZeroInfinityEngine:
    def __init__(self, run: RunConfig, device="cuda", mesh=None):
        self.run = run
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        sizes = mesh.axis_sizes() if self.mesh is not None else {"data": 1, "model": 1}
        self.sizes = sizes
        self.coords = self.mesh.coords() if self.mesh is not None else {"data": 0, "model": 0}
        self.dp = sizes["data"]  # the data-parallel ranks
        self.rank = mesh.rank if self.mesh is not None else 0
        self.mp = None  # the rank's model-parallel context (zero.ModelAxis)
        # bytes serve_params' gathers over the model axis brought in (context
        # parallelism's whole leaves), summed over the calls
        self.model_gather_bytes = [0]
        defs = registry.param_defs(run.model)
        # each leaf's split dim over the model axis (None: whole over it; one
        # tree: the rules put the model axis on the same dims for every state
        # class) and over the data axis per state class
        self.model_splits = pt.leaf_splits(defs, run.model, sizes, run.parallel,
                                           "param", axis="model")
        if sizes["model"] > 1:
            from repro_torch.core.zero import ModelAxis  # zero.py imports this module

            self.mp = ModelAxis(self.mesh, self._strategy(run, sizes),
                                inner=_inner_split(defs, self.model_splits, run.model))
        self.bundle = registry.build(run.model, run.parallel, self.mp)
        self.splits = {cls: pt.leaf_splits(defs, run.model, sizes, run.parallel, cls)
                       for cls in STATE_CLASSES}
        for cls in STATE_CLASSES:
            if pt.leaf_splits(defs, run.model, sizes, run.parallel, cls,
                              axis="model") != self.model_splits:
                raise ValueError(f"the rules split the {cls} class over the model axis "
                                 "on other dims than the params")
        # the top-level subtrees stacked over layers (serving reads them a
        # layer at a time); none is split on that dim
        self.stacked = tuple(k for k in sorted(self.bundle.defs) if _stacked(self.bundle.defs[k]))
        for k in self.stacked:
            for path in pt.tree_paths(self.bundle.defs[k]):
                if 0 in (pt.tree_get(self.splits["param"][k], path),
                         pt.tree_get(self.model_splits[k], path)):
                    raise ValueError(f"{(k,) + path}: split over the ranks on its layer dim; "
                                     "serving gathers a layer's slice along another dim")
        # the host tier is page-locked CPU memory on the card, the device
        # itself on the CPU
        pinned = self.device.type == "cuda"
        self.param_host = run.offload.param_tier == "host" and pinned
        self.opt_host = (run.offload.opt_tier == "host" and pinned
                         and not run.opt_offgraph)
        self.host = PinnedHostTier(self.device)

    @staticmethod
    def _strategy(run: RunConfig, sizes: dict) -> str:
        """The reference's attention strategy on this mesh; what the port
        cannot lay out so raises."""
        cfg, par, M = run.model, run.parallel, sizes["model"]
        if par.pure_dp:
            raise NotImplementedError(
                "pure_dp on the GSPMD engine with a model axis (every mesh axis data "
                "parallel) is not ported: --model-mesh folds into dp on --engine zero3")
        strategy = pt.choose_attn_strategy(cfg, sizes, par)
        if strategy == "tp" and cfg.n_heads % M:
            raise ValueError(f"tensor parallelism: {cfg.n_heads} heads do not split over "
                             f"{M} model ranks; attn_strategy 'cp' or 'auto'")
        return strategy

    def _partial_over_model(self, path) -> bool:
        """Whether the model ranks each compute a part of this leaf's
        gradient (their sum the whole): a leaf whole over the model axis
        under context parallelism (each rank its chunk, or, in a recurrent
        block, its ``inner`` channels over the whole sequence), and under
        tensor parallelism a KV projection whose heads do not split (each
        rank its query heads' KV heads), MoE's router where the experts
        split (a rank's gates take cotangents through its experts alone)
        and mamba2's ``state`` leaves (``w_B``, ``w_C``, ``conv_B``,
        ``conv_C``) where its ``inner`` channels split (used after the
        block's entry, each rank's cotangent through its own heads)."""
        if self.mp is None or pt.tree_get(self.model_splits, path) is not None:
            return False
        if not self.mp.tp:
            return True
        if path[-1] == "router":
            return pt.tree_get(self.model_splits, path[:-1] + ("w_in",)) is not None
        axes = pt.tree_get(self.bundle.defs, path).axes
        if "state" in axes:
            return self.mp.inner
        return "kv_heads" in axes

    def _whole_over_model(self, path) -> Optional[int]:
        """The dim along which context parallelism gathers this leaf over
        the model axis before use (None: the rank's shard is used as it
        is): every leaf the rules split there but MoE's experts, whose
        partial outputs are summed instead (``models/moe.py``), and the
        recurrent blocks' ``inner`` leaves, whose blocks gather the
        sequence instead (``models/mamba2.py``, ``models/rglru.py``)."""
        if self.mp is None or self.mp.tp:
            return None
        axes = pt.tree_get(self.bundle.defs, path).axes
        if "experts" in axes or "inner" in axes:
            return None
        return pt.tree_get(self.model_splits, path)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def init_params(self, generator: torch.Generator) -> dict:
        """The params alone on the engine's device, drawn from
        ``generator`` (which must live there) with the reference's
        distributions: what serving needs. On a mesh the rank's ZeRO
        param shards of that draw, cut along both axes
        (``partition.init_shards``)."""
        if self.mesh is None:
            return self.bundle.init(generator, self.device)
        return pt.init_shards(self.bundle.defs, {"data": self.splits["param"],
                                                 "model": self.model_splits},
                              generator, self.device, self.coords, self.sizes)

    def serve_params(self, params: dict) -> dict:
        """What one prefill wave or decode step reads of the rank's
        ``params``: at one rank ``params`` itself; on a mesh the unstacked
        leaves gathered whole (one collective, freed with the view after
        the call) and each stacked subtree a ``LayerShards``. Every rank
        calls it, and the step it feeds, in lockstep."""
        if self.mesh is None:
            return params
        split = self.splits["param"]
        model: dict = {}  # the dims context parallelism gathers over model
        for p in pt.tree_paths(params):
            pt.tree_set(model, p, self._whole_over_model(p))
        count = self.model_gather_bytes
        out = {k: LayerShards(params[k], split[k], self.mesh, model[k], count)
               for k in self.stacked}
        whole = {p: (pt.tree_get(params, p), pt.tree_get(split, p), pt.tree_get(model, p))
                 for p in pt.tree_paths(params) if p[0] not in self.stacked}
        for path, t in _gather_both(whole, self.mesh, count).items():
            pt.tree_set(out, path, t)
        return out

    def init_state(self, generator: torch.Generator) -> dict:
        """``{"params"}`` plus ``{"opt"}`` (an ``AdamState``) unless the
        optimizer is off-graph (``run.opt_offgraph``: its states live in
        the executor's store), params drawn as ``init_params`` does (on a
        mesh the rank's shards alone)."""
        return self.adopt_params(self.init_params(generator), src="param")

    def adopt_params(self, params: dict, step: int = 0, src: Optional[str] = None) -> dict:
        """This engine's state around ``params`` (any device), whole or, with
        ``src``, laid out as that state class: Adam masters the params' f32
        copies, zero moments, the Adam step count ``step`` (a checkpoint's,
        on a tier migration); on a mesh the rank's shards of each."""
        params = pt.tree_map(lambda t: t.to(self.device), params)
        state = {"params": self.respec(params, src, "param")}
        if not self.run.opt_offgraph:
            opt = adam.init_state(self.respec(params, src, "opt"))
            state["opt"] = opt._replace(step=torch.full_like(opt.step, step))
        return self.place_state(state)

    def respec(self, tree: dict, src: Optional[str], dst: Optional[str]) -> dict:
        """``tree`` laid out by state class ``src`` (None: whole leaves)
        -> laid out by ``dst`` (None: whole), axis by axis: the rank's
        shard where only ``dst`` splits a leaf, the all-gather of the
        shards over that axis where only ``src`` does (one collective a
        leaf and axis, in tree order), the leaf itself where both agree.
        The identity at one rank."""
        if self.mesh is None or src == dst:
            return tree

        def dim(cls, axis, path):  # the leaf's split dim over ``axis`` as ``cls``
            if cls is None:
                return None
            return pt.tree_get(self.splits[cls] if axis == "data" else self.model_splits, path)

        out: dict = {}
        for path in pt.tree_paths(tree):
            leaf = pt.tree_get(tree, path)
            for axis in pt.CUT_ORDER:
                da, db = dim(src, axis, path), dim(dst, axis, path)
                if da == db:
                    continue
                if da is None:
                    leaf = pt.shard_leaf(leaf, db, self.coords[axis], self.sizes[axis])
                elif db is None:
                    leaf = self.mesh.all_gather(leaf, da, axis)
                else:
                    raise ValueError(f"{path}: split on dim {da} as {src}, {db} as {dst}")
            pt.tree_set(out, path, leaf)
        return out

    def shard_bytes(self) -> dict:
        """One rank's state bytes from the defs and the splits: its param
        shards in the params' dtypes, its gradient shards likewise (f32,
        the accumulators', under ``grad_accum`` > 1), its f32 master, m and
        v shards (12 bytes an element)."""
        M = self.sizes["model"]

        def count(cls, per_elem=None):
            total = 0
            for path in pt.tree_paths(self.bundle.defs):
                d = pt.tree_get(self.bundle.defs, path)
                n = math.prod(d.shape) // (self.dp if pt.tree_get(self.splits[cls], path)
                                           is not None else 1)
                n //= M if pt.tree_get(self.model_splits, path) is not None else 1
                total += n * (per_elem or d.torch_dtype.itemsize)
            return total

        accum = self.run.parallel.grad_accum > 1
        return {"param_shard_bytes": count("param"),
                "grad_shard_bytes": count("grad", 4 if accum else None),
                "opt_shard_bytes": count("opt", 12)}

    def unsplit_leaves(self, cls: str) -> list:
        """The ``keystr`` names of the leaves every rank holds whole in
        state class ``cls`` (all of them at one rank)."""
        return ["".join(f"[{k!r}]" for k in path) for path in pt.tree_paths(self.bundle.defs)
                if self.mesh is None or (pt.tree_get(self.splits[cls], path) is None
                                         and pt.tree_get(self.model_splits, path) is None)]

    def place_state(self, state: dict) -> dict:
        """``state``'s leaves where this engine keeps them: host-tier
        params, masters and moments in pinned CPU memory on the card,
        everything else (the Adam step count too) on the device."""
        out = {"params": (self.host.pin(state["params"]) if self.param_host
                          else pt.tree_map(lambda t: t.to(self.device), state["params"]))}
        if "opt" in state:
            opt = state["opt"]
            move = self.host.pin if self.opt_host else (
                lambda tree: pt.tree_map(lambda t: t.to(self.device), tree))
            out["opt"] = adam.AdamState(opt.step.to(self.device), *(move(t) for t in opt[1:]))
        return out

    def param_specs(self, whole: bool = False) -> dict:
        """The params' tree of ``TensorSpec`` (shape, dtype): what stands
        in the state for leaves that live in the executor's param store
        (``param_tier="nvme"``), and what their bytes are counted from. On
        a mesh the rank's shards, each leaf cut along both axes by the
        param rules (as ``respec(tree, None, "param")`` cuts it); with
        ``whole`` the global leaves."""
        out: dict = {}
        for path in pt.tree_paths(self.bundle.defs):
            d = pt.tree_get(self.bundle.defs, path)
            shape = list(d.shape)
            if self.mesh is not None and not whole:
                for axis, splits in (("data", self.splits["param"]),
                                     ("model", self.model_splits)):
                    dim = pt.tree_get(splits, path)
                    if dim is not None:
                        shape[dim] //= self.sizes[axis]
            pt.tree_set(out, path, TensorSpec(tuple(shape), d.torch_dtype))
        return out

    def shard_share(self, cls: str) -> float:
        """The rank's elements of state class ``cls`` over the model's: 1
        at one rank, 1 / (data x model) where every leaf splits on both
        axes, more where the rank holds leaves whole (``unsplit_leaves``,
        and the leaves whole over one axis), so the ranks' shares sum past
        1 by those leaves' duplicates."""
        if self.mesh is None:
            return 1.0
        mine = total = 0
        for path in pt.tree_paths(self.bundle.defs):
            n = math.prod(pt.tree_get(self.bundle.defs, path).shape)
            total += n
            for axis, splits in (("data", self.splits[cls]), ("model", self.model_splits)):
                if pt.tree_get(splits, path) is not None:
                    n //= self.sizes[axis]
            mine += n
        return mine / total

    def gather_state(self, state: dict) -> Optional[dict]:
        """The global state of the rank's ``state`` (``{"params"}``, and
        ``{"opt"}`` while the optimizer is in-graph): on rank 0 each leaf
        whole on the CPU, the leaves a one-rank checkpoint of the same
        state holds; None on every other rank. Every rank gathers one leaf
        at a time (``respec(leaf, cls, None)``, on the device) and hands
        it on, so a rank that does not keep it holds at most one whole
        leaf beyond its shards. The identity at one rank."""
        if self.mesh is None:
            return state
        keep = self.rank == 0

        def whole(tree, cls):
            out: dict = {}
            for path in pt.tree_paths(tree):
                sub: dict = {}
                pt.tree_set(sub, path, pt.tree_get(tree, path).to(self.device))
                leaf = pt.tree_get(self.respec(sub, cls, None), path)
                if keep:
                    pt.tree_set(out, path, leaf.to("cpu"))
            return out

        out = {"params": whole(state["params"], "param")}
        if "opt" in state:
            opt = state["opt"]
            out["opt"] = adam.AdamState(opt.step.to("cpu"),
                                        *(whole(t, "opt") for t in opt[1:]))
        return out if keep else None

    def shard_state(self, state: dict) -> dict:
        """A global state (a checkpoint's, written on any mesh) -> the
        rank's shards of it: the params cut by the param rules, the
        masters and moments by the opt rules, the step count as it is (no
        collective). The identity at one rank."""
        out = {"params": self.respec(state["params"], None, "param")}
        if "opt" in state:
            opt = state["opt"]
            out["opt"] = adam.AdamState(opt.step, *(self.respec(t, None, "opt")
                                                    for t in opt[1:]))
        return out

    def host_ready(self) -> None:
        """Wait for the last step's write-backs into the pinned host tier."""
        self.host.ready()

    def input_specs(self, shape: ShapeConfig) -> dict:
        return self.bundle.input_specs(shape)

    def n_params_active(self) -> int:
        """The bundle's count: every parameter, MoE experts discounted by
        top_k / E."""
        return self.bundle.n_params_active()

    # ------------------------------------------------------------------
    # train step
    # ------------------------------------------------------------------

    def make_train_step(self, *, grads_only: bool = False):
        """``step(state, batch)``: with ``grads_only`` ->
        ``(grads, {loss, grad_norm})``; otherwise the Adam update ->
        ``(new_state, {loss, grad_norm, lr})``, ``lr`` the step's own
        (``adam.lr_at`` of the new step count). Metrics are 0-d device
        tensors (and, on a mesh, the rank's state bytes as integers). On a
        mesh ``batch`` is the rank's rows and ``grads`` the rank's part of
        the global gradient in the grad spec."""
        tc = self.run.train
        accum = self.run.parallel.grad_accum
        mesh, dp = self.mesh, self.dp
        # families with step statistics (moe) expose loss_stats: its aux
        # (the routing's drop fraction and expert load, from counts summed
        # over the ranks) rides out of the gradient pass into the step
        # metrics without a second forward
        loss_stats = self.bundle.loss_stats
        if loss_stats is None:
            loss_f = self.bundle.loss
            loss_stats = lambda params, batch, reduce=None: (loss_f(params, batch), {})
        # the model ranks of a data row route the same tokens: the routing
        # counts are summed over the data ranks alone
        reduce = (lambda t: mesh.all_reduce(t, "data")) if mesh is not None else None
        param_host = self.param_host
        opt_host = self.opt_host and not grads_only
        if mesh is not None:
            from repro_torch.core.zero import LeafGather  # zero.py imports this module

        cp = self.mp is not None and not self.mp.tp

        def value_and_grad(params, batch):
            paths = pt.tree_paths(params)
            leaves = [pt.tree_get(params, p).detach().requires_grad_() for p in paths]
            live: dict = {}
            for p, leaf in zip(paths, leaves):
                t = leaf
                if mesh is not None:
                    dim = pt.tree_get(self.splits["param"], p)
                    if dim is not None:
                        t = LeafGather.apply(t, mesh, dim, "data")
                    mdim = self._whole_over_model(p)
                    if mdim is not None:  # context parallel: the whole leaf
                        t = LeafGather.apply(t, mesh, mdim, "model")
                pt.tree_set(live, p, t)
            loss, aux = loss_stats(live, batch, reduce=reduce)
            if mesh is not None:
                loss = loss / dp  # the ranks' sum is the global batch's loss
            grads: dict = {}
            for p, g in zip(paths, torch.autograd.grad(loss, leaves)):
                if mesh is not None and pt.tree_get(self.splits["param"], p) is None:
                    dim = pt.tree_get(self.splits["grad"], p)
                    g = (mesh.all_reduce(g, "data") if dim is None
                         else mesh.reduce_scatter(g, dim, "data"))
                if self._partial_over_model(p):
                    g = mesh.all_reduce(g, "model")
                pt.tree_set(grads, p, g)
            return loss.detach(), grads, aux

        def grads_of(params, batch):
            if accum <= 1:
                return value_and_grad(params, batch)
            # microbatches along the leading batch dim, summed in f32; the
            # aux of each microbatch averaged, as the reference's scan
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                     for k, v in batch.items()}
            loss_acc = torch.zeros((), dtype=torch.float32, device=self.device)
            g_acc = None
            auxs = []
            for i in range(accum):
                loss, g, aux = value_and_grad(params, {k: v[i] for k, v in micro.items()})
                loss_acc = loss_acc + loss
                if g_acc is None:  # shaped like the gradients' spec
                    g_acc = pt.tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                                              device=self.device), g)
                g_acc = _tree_add_f32(g_acc, g)
                auxs.append(aux)
            inv = 1.0 / accum
            aux = {k: torch.stack([a[k] for a in auxs]).mean(dim=0) for k in auxs[0]}
            return loss_acc * inv, pt.tree_map(lambda g: g * inv, g_acc), aux

        def train_step(state, batch):
            params, opt = state["params"], state.get("opt")
            if param_host:  # pinned host -> the device, ahead of the forward
                params = self.host.to_device(params)
            if opt_host:  # pinned host -> the device for the update
                opt = adam.AdamState(opt.step, *(self.host.to_device(t) for t in opt[1:]))
            loss, grads, aux = grads_of(params, batch)
            extra = {}
            if mesh is not None:  # a context-parallel rank's is its chunk's share
                loss = mesh.all_reduce(loss, None if cp else "data")
                extra = {"param_shard_bytes": _nbytes(state["params"]),
                         "grad_shard_bytes": _nbytes(grads)}
            gnorm = self.grad_norm(grads)
            if grads_only:
                return grads, {"loss": loss, "grad_norm": gnorm, **aux, **extra}
            new_params, new_opt = adam.apply_updates(self.respec(grads, "grad", "opt"), opt,
                                                     tc, params_prev=params)
            new_params = self.respec(new_params, "opt", "param")
            if param_host:  # updated bf16 params back to their pinned tensors
                new_params = self.host.write_back(state["params"], new_params)
            if opt_host:  # updated masters and moments back likewise
                host = state["opt"]
                new_opt = adam.AdamState(new_opt.step, *(
                    self.host.write_back(h, d) for h, d in zip(host[1:], new_opt[1:])))
            if mesh is not None:
                extra["opt_shard_bytes"] = sum(_nbytes(t) for t in new_opt[1:])
            metrics = {"loss": loss, "grad_norm": gnorm,
                       "lr": adam.lr_at(tc, new_opt.step), **aux, **extra}
            return {"params": new_params, "opt": new_opt}, metrics

        return train_step

    def grad_norm(self, grads: dict) -> torch.Tensor:
        """The global gradient's norm from this rank's grad-spec part: at
        one rank ``global_norm``; on a mesh the f32 sums of squares of the
        leaves, each counted on the ranks at coordinate 0 of every axis it
        is not split over (so once over the mesh), summed over the ranks in
        one all-reduce (the leaves split on every axis and the others in
        two sums)."""
        if self.mesh is None:
            return global_norm(grads)
        split = torch.zeros((), dtype=torch.float32, device=self.device)
        whole = torch.zeros((), dtype=torch.float32, device=self.device)
        for path in pt.tree_paths(grads):
            sq = torch.sum(torch.square(pt.tree_get(grads, path).float()))
            dims = {"data": pt.tree_get(self.splits["grad"], path),
                    "model": pt.tree_get(self.model_splits, path)}
            unsplit = [a for a, n in self.sizes.items() if n > 1 and dims[a] is None]
            if not unsplit:
                split = split + sq
            elif all(self.coords[a] == 0 for a in unsplit):
                whole = whole + sq
        return torch.sqrt(self.mesh.all_reduce(split + whole))


def _tree_add_f32(acc: dict, g: dict) -> dict:
    return {k: _tree_add_f32(acc[k], g[k]) if isinstance(acc[k], dict)
            else acc[k] + g[k].float() for k in acc}
