"""Parameter definitions, initialization and the flat row layout
(``repro/core/partition.py:33-67``, ``repro/core/zero.py:74-81,152-213``).

A ``ParamDef`` carries shape, dtype, logical axis names and the init rule;
``init_tree`` materializes a nested dict of defs as tensors on one device.
The distributions are the JAX package's (normal * 0.02, zeros, ones,
fan-in scaled, RG-LRU forget-gate), drawn from an explicit
``torch.Generator``: the bits differ from ``jax.random``, so parity tests
load the JAX package's weights through ``repro_torch.bridge`` instead.

``FlatLayout`` / ``flatten_blocks`` / ``unflatten_row`` are the explicit
ZeRO-3 engine's per-layer row: every leaf of one layer flattened and
concatenated in ``jax.tree`` order (sorted dict keys), padded to a multiple
of dp — byte for byte the reference's row, so either package's stores
hold the same rows. Nested dicts stand in for pytrees (``tree_*`` helpers).
``quantized_leaf_plan`` / ``unflatten_wire_row`` read a row that arrives in
the q8 wire layout (``core/qformat.py``): the planned MLP weights stay
quantized (``QWeight``), every other leaf is dequantized.

The GSPMD engine's sharding rules (``repro/core/partition.py:78-230``):
``AxisRules`` maps logical dims to mesh axes, ``make_rules`` builds the
table of a ZeRO stage for one state class (param, grad, opt, act) and
``spec_tree`` lays a tree of defs out by it. A spec is the reference's
``PartitionSpec`` as a tuple (its divisibility guard included: a dim that
does not split evenly stays replicated); the rules read the mesh's axis
sizes, ``{"data": N, "model": M}``, not devices. ``split_axes`` turns a
spec into what one rank holds of the leaf: ``{axis: dim}``, the dim split
over each mesh axis of more than one rank (empty where the leaf is whole
on every rank; ``split_dim`` one axis's entry). A leaf may be cut along
two dims at once: at ZeRO-3 on a (2, 2) mesh ``wq`` splits ``embed`` over
data and ``heads`` over model. ``shard_leaf`` / ``unshard_leaf`` cut a
whole leaf along one dim and put it back together; ``cut_leaf`` /
``join_leaf`` do both axes for a rank at mesh coordinates ``coords``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.core.qformat import BLOCK as QBLOCK, dequant_q8

@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Shape + dtype + logical axis names (one per dim) + init scale."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: str = "bfloat16"
    init: str = "normal"  # normal | zeros | ones | lru_lambda
    init_scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamDef shape {self.shape} vs axes {self.axes}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def initialize(d: ParamDef, generator: torch.Generator, device: torch.device,
               cut: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """One leaf drawn whole from ``generator``; with ``cut`` (a rank's
    ``cut_leaf``) only that part of it is kept, cut from the f32 draw
    before the cast (the cast is elementwise, so the shard's bits are the
    whole leaf's)."""
    dtype = d.torch_dtype
    cut = cut or (lambda t: t)

    if d.init == "zeros":
        return cut(torch.zeros(d.shape, dtype=dtype, device=device))
    if d.init == "ones":
        return cut(torch.ones(d.shape, dtype=dtype, device=device))
    if d.init == "lru_lambda":
        # RG-LRU forget-gate params: a = exp(-8*softplus(L)*r) spans
        # (0.9, 0.999) per the Griffin paper
        u = torch.empty(d.shape, dtype=torch.float32, device=device).uniform_(
            0.9, 0.999, generator=generator)
        lam = torch.log(torch.expm1(-torch.log(u) / 8.0))  # inverse softplus
        return cut(lam).to(dtype)
    fan_in = d.shape[0] if len(d.shape) > 1 else d.shape[-1]
    scale = d.init_scale if d.init == "normal" else 1.0 / math.sqrt(fan_in)
    x = torch.randn(d.shape, dtype=torch.float32, device=device,
                    generator=generator)
    return cut(x.mul_(scale)).to(dtype)  # in place: one f32 leaf at a time


def init_tree(defs, generator: torch.Generator, device) -> dict:
    """Nested dict of ``ParamDef`` -> nested dict of tensors on ``device``
    (leaves drawn in sorted-key order, as ``jax.tree`` flattens dicts)."""
    device = torch.device(device)
    if isinstance(defs, ParamDef):
        return initialize(defs, generator, device)
    return {k: init_tree(defs[k], generator, device) for k in sorted(defs)}


def init_shards(defs, splits: dict, generator: torch.Generator, device, coords: dict,
                sizes: dict) -> dict:
    """``init_tree``'s draw, leaf by leaf in its order, each leaf cut to
    the shard of the rank at mesh ``coords`` (``{axis: coordinate}``, the
    axes' sizes in ``sizes``) along its dim on each axis of ``splits``
    (``{axis: tree shaped like defs}``; None: whole) and the rest freed
    before the next is drawn: the shards are bit for bit ``cut_leaf`` of
    ``init_tree``'s leaves, and no more than one whole leaf is ever held."""
    device = torch.device(device)
    out: dict = {}
    for path in tree_paths(defs):
        dims = {a: tree_get(tree, path) for a, tree in splits.items()}
        tree_set(out, path, initialize(tree_get(defs, path), generator, device,
                                       lambda t: cut_leaf(t, dims, coords, sizes)))
    return out


def tree_map(fn, tree):
    """Apply ``fn`` to every non-dict leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_paths(tree, prefix=()) -> list:
    """Key paths of every non-dict leaf, in ``jax.tree`` order (sorted
    keys at every level)."""
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k in sorted(tree) for p in tree_paths(tree[k], prefix + (k,))]


def tree_leaves(tree) -> list:
    return [tree_get(tree, p) for p in tree_paths(tree)]


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_set(tree: dict, path, value) -> None:
    """Set a leaf, creating the intermediate dicts."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


@dataclasses.dataclass
class FlatLayout:
    """One layer's flat row: leaf paths, per-layer shapes (layer dim
    stripped), def dtypes, sizes, and the padded row length."""

    paths: list
    shapes: list
    dtypes: list
    sizes: list
    padded: int  # per-layer flat length (padded to a dp multiple)


def build_layout(block_defs: dict, dp: int = 1) -> FlatLayout:
    """Layout of the stacked block defs (leading ``layers`` dim)."""
    paths = tree_paths(block_defs)
    defs = [tree_get(block_defs, p) for p in paths]
    shapes = [tuple(d.shape[1:]) for d in defs]
    sizes = [math.prod(s) for s in shapes]
    total = sum(sizes)
    return FlatLayout(paths, shapes, [d.dtype for d in defs], sizes,
                      total + (-total) % dp)


def row_shard(rows: torch.Tensor, rank: int, dp: int, mode: str = "allgather") -> torch.Tensor:
    """Rank ``rank``'s part of the global (L, P) ``rows`` (the flat, its
    f32 master or a moment) among ``dp`` ranks: the columns ``[r * P/dp,
    (r+1) * P/dp)`` of every layer under ``allgather`` (P a multiple of
    dp, ``build_layout`` pads it), the contiguous layers ``[r * L/dp,
    (r+1) * L/dp)`` under ``broadcast``."""
    axis = 1 if mode == "allgather" else 0
    n = rows.shape[axis]
    if n % dp:
        raise ValueError(f"{mode}: {n} rows' {'columns' if axis else 'layers'} do not "
                         f"split over {dp} ranks")
    return rows.narrow(axis, rank * (n // dp), n // dp)


def flatten_blocks(blocks: dict, layout: FlatLayout, dtype: torch.dtype) -> torch.Tensor:
    """Stacked block params (leaves (L, ...)) -> (L, padded) in ``dtype``."""
    leaves = [tree_get(blocks, p) for p in layout.paths]
    L = leaves[0].shape[0]
    flat = torch.cat([t.to(dtype).reshape(L, -1) for t in leaves], dim=1)
    pad = layout.padded - flat.shape[1]
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat


def unflatten_row(row: torch.Tensor, layout: FlatLayout, dtype=None) -> dict:
    """(padded,) one-layer row -> nested dict of leaves (views of the row
    when the dtype already matches), each cast to ``dtype`` (default: the
    def's dtype). Differentiable: the row's gradient is the leaves'
    gradients scattered back, zero in the padding."""
    out: dict = {}
    off = 0
    for path, shape, dt, size in zip(layout.paths, layout.shapes,
                                     layout.dtypes, layout.sizes):
        piece = row[off:off + size].reshape(shape)
        tree_set(out, path, piece.to(dtype or getattr(torch, dt)))
        off += size
    return out


class QWeight(NamedTuple):
    """A (K, N) weight in the q8 wire layout: int8 quants ``q`` (K, N),
    fp16 scales ``s`` (K, N/32), and ``anchor``, a bf16 (K, N) view that
    stands for the weight in autograd (None where nothing differentiates)."""

    q: torch.Tensor
    s: torch.Tensor
    anchor: Optional[torch.Tensor]


def quantized_leaf_plan(layout: FlatLayout, dp: int = 1) -> tuple:
    """Paths of the leaves whose products take the q8 operands in place:
    MLP weights (under ``"mlp"``) that are 2-D (K, N) with N a multiple of
    the quant block and whose blocks are contiguous in the gathered wire
    row (``unflatten_wire_row``), so they tile the leaf as (K, N/32). Each
    rank encodes its (P/dp,) slice in blocks from the slice's first
    element, as the reference's store encodes each rank key: a leaf starts
    on its slice's grid and either lies within the slice or crosses only
    boundaries where P/dp is a multiple of 32 (no padded block between the
    slices: the ranks' grids join into the row's own, as at one rank).
    Decided once per layout and dp."""
    plan, off = [], 0
    per = layout.padded // dp
    seamless = per % QBLOCK == 0
    for path, shape, size in zip(layout.paths, layout.shapes, layout.sizes):
        lo = off % per  # the offset within its rank's slice
        if (path[0] == "mlp" and len(shape) == 2 and shape[1] % QBLOCK == 0
                and lo % QBLOCK == 0 and (seamless or lo + size <= per)):
            plan.append(path)
        off += size
    return tuple(plan)


def unflatten_wire_row(q: torch.Tensor, s: torch.Tensor,
                       anchor_row: Optional[torch.Tensor], layout: FlatLayout,
                       plan: tuple, dp: int = 1) -> dict:
    """A q8 wire row -> nested dict of leaves: a ``QWeight`` of views for
    each leaf in ``plan``, the bf16 values ``(q * s).to(bf16)`` for every
    other leaf (the reference's host decode, bit for bit).

    The row is the concatenation of the ``dp`` ranks' block grids, rank
    order (one rank: the row's own): each rank's (P/dp,) slice encoded in
    blocks of ``QBLOCK`` from its first element, its last block padded, so
    slice r's quants start at ``r * nb * QBLOCK`` and its scales at ``r *
    nb`` (``nb`` blocks a slice). A leaf that spans slices decodes slice by
    slice.

    ``anchor_row`` (the (padded,) bf16 zero row that requires grad, or
    None) carries the gradient: each planned leaf's anchor is its segment,
    and every other leaf adds its (zero) segment, so the row's gradient is
    the leaves' gradients at their offsets, zero in the padding."""
    per = layout.padded // dp
    nb = -(-per // QBLOCK)

    def decode(off, size):
        parts, end = [], off + size
        while off < end:
            r = off // per
            lo, hi = off - r * per, min(end, (r + 1) * per) - r * per
            b0, b1 = lo // QBLOCK, -(-hi // QBLOCK)
            base = r * nb
            vals = dequant_q8(q[(base + b0) * QBLOCK:(base + b1) * QBLOCK], s[base + b0:base + b1])
            parts.append(vals[lo - b0 * QBLOCK:hi - b0 * QBLOCK])
            off = r * per + hi
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    out: dict = {}
    off = 0
    for path, shape, size in zip(layout.paths, layout.shapes, layout.sizes):
        anchor = None if anchor_row is None else anchor_row[off:off + size].view(shape)
        if path in plan:  # contiguous in the grid (quantized_leaf_plan)
            K, N = shape
            r = off // per
            at = r * nb * QBLOCK + off - r * per  # the leaf's first quant
            leaf = QWeight(q[at:at + size].view(K, N),
                           s[at // QBLOCK:(at + size) // QBLOCK].view(K, N // QBLOCK), anchor)
        else:
            leaf = decode(off, size).to(torch.bfloat16).view(shape)
            if anchor is not None:
                leaf = leaf + anchor
        tree_set(out, path, leaf)
        off += size
    return out


# ---------------------------------------------------------------------------
# the GSPMD engine's sharding rules
# ---------------------------------------------------------------------------

MeshAxes = Optional[Tuple[str, ...]]
Spec = Tuple[object, ...]  # a PartitionSpec's entries: None, an axis, or a tuple of axes


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """logical axis name -> mesh axes (or None = replicated)."""

    table: Tuple[Tuple[str, MeshAxes], ...]
    mesh_sizes: Tuple[Tuple[str, int], ...] = ()  # for divisibility guards

    def lookup(self, name: Optional[str]) -> MeshAxes:
        if name is None:
            return None
        for k, v in self.table:
            if k == name:
                return v
        return None

    def degree(self, mesh_axes: Sequence[str]) -> int:
        sizes = dict(self.mesh_sizes)
        return math.prod(sizes.get(a, 1) for a in mesh_axes)

    def spec(self, axes: Sequence[Optional[str]], shape: Sequence[int] = None) -> Spec:
        entries: list = []
        used: set = set()
        for i, name in enumerate(axes):
            mesh_axes = self.lookup(name)
            if mesh_axes is None:
                entries.append(None)
                continue
            # a mesh axis may appear only once per spec
            mesh_axes = tuple(a for a in mesh_axes if a not in used)
            if not mesh_axes:
                entries.append(None)
                continue
            # divisibility guard: drop sharding for non-divisible dims
            if shape is not None and self.mesh_sizes:
                if shape[i] % self.degree(mesh_axes) != 0:
                    entries.append(None)
                    continue
            used.update(mesh_axes)
            entries.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)


def dp_axes(mesh_sizes: Dict[str, int]) -> Tuple[str, ...]:
    """Mesh axes that constitute data parallelism (pod + data)."""
    return tuple(a for a in ("pod", "data") if a in mesh_sizes)


def choose_attn_strategy(cfg: ModelConfig, mesh_sizes: Dict[str, int],
                         parallel: ParallelConfig) -> str:
    """'tp' (shard heads over the model axis) or 'cp' (shard sequence)."""
    if parallel.attn_strategy != "auto":
        return parallel.attn_strategy
    tp = mesh_sizes.get("model", 1)
    if cfg.n_heads and cfg.n_heads % tp == 0:
        return "tp"
    return "cp"


def make_rules(cfg: ModelConfig, mesh_sizes: Dict[str, int], parallel: ParallelConfig,
               *, for_state: str = "param") -> AxisRules:
    """The logical -> mesh mapping of the ZeRO stage (and TP/CP) for one
    state class: "param" / "grad" sharded over dp iff stage >= 3 / >= 2,
    "opt" iff stage >= 1, "act" the activations' batch/seq sharding."""
    if parallel.pure_dp:  # every mesh axis is data parallelism
        dp = tuple(mesh_sizes)
        tp_avail = False
    else:
        dp = dp_axes(mesh_sizes)
        tp_avail = "model" in mesh_sizes
    zero_ax = tuple(a for a in dp if a != "pod") if parallel.zero_scope == "pod" else dp

    def zero_axes(stage: int) -> MeshAxes:
        sharded = {"param": stage >= 3, "grad": stage >= 2, "opt": stage >= 1,
                   "act": False}[for_state]
        return zero_ax if (sharded and zero_ax) else None

    fsdp, fsdp_e = zero_axes(parallel.zero_stage), zero_axes(parallel.moe_zero_stage)
    attn = "dp" if parallel.pure_dp else choose_attn_strategy(cfg, mesh_sizes, parallel)
    tp = mesh_sizes.get("model", 1)
    heads_tp = tp_avail and attn == "tp"
    kv_tp = heads_tp and cfg.n_kv_heads and cfg.n_kv_heads % tp == 0
    model: MeshAxes = ("model",) if tp_avail else None
    table = [
        # ---- parameter storage dims ----
        ("embed", fsdp),  # ZeRO-3 partitioning dim
        ("embed_e", fsdp_e),  # expert weights' ZeRO dim
        ("mlp", model),
        ("heads", ("model",) if heads_tp else None),
        ("kv_heads", ("model",) if kv_tp else None),
        ("head_dim", None),
        ("vocab", model),
        ("experts", model),
        ("inner", model),  # ssm d_inner / lru_width
        ("state", None),
        ("conv", None),
        ("layers", None),
        # ---- activation dims ----
        ("batch", dp if dp else None),
        ("seq", ("model",) if (tp_avail and attn == "cp") else None),
        ("kv_seq", None),
        ("cache_seq", model),
        ("act_embed", None),
        ("act_mlp", model),
        ("act_heads", ("model",) if heads_tp else None),
    ]
    return AxisRules(tuple(table), tuple(sorted(mesh_sizes.items())))


def spec_tree(defs, rules: AxisRules):
    """Nested dict of ``ParamDef`` -> nested dict of specs."""
    return tree_map(lambda d: rules.spec(d.axes, d.shape), defs)


def split_axes(spec: Spec, rules: AxisRules) -> Dict[str, int]:
    """``{axis: dim}``: the dim of a leaf laid out by ``spec`` that each
    mesh axis of more than one rank splits (entries on axes of size 1
    split nothing). An entry on two axes at once (``pure_dp``'s) is not
    ported: no GSPMD run here lays a leaf out so."""
    out: Dict[str, int] = {}
    for i, e in enumerate(spec):
        axes = [a for a in ((e,) if isinstance(e, str) else (e or ()))
                if rules.degree((a,)) > 1]
        if len(axes) > 1:
            raise NotImplementedError(f"spec {spec} splits dim {i} over {axes} at once")
        if axes:
            out[axes[0]] = i
    return out


def split_dim(spec: Spec, rules: AxisRules, axis: str = "data") -> Optional[int]:
    """The dim of a leaf laid out by ``spec`` that the ranks along ``axis``
    each hold a part of, or None where that axis leaves it whole."""
    return split_axes(spec, rules).get(axis)


def leaf_splits(defs, cfg: ModelConfig, mesh_sizes: Dict[str, int],
                parallel: ParallelConfig, for_state: str, axis: str = "data") -> dict:
    """Each leaf's ``split_dim`` along ``axis`` under ``make_rules`` for
    ``for_state``: a tree shaped like ``defs``."""
    rules = make_rules(cfg, mesh_sizes, parallel, for_state=for_state)
    return tree_map(lambda d: split_dim(rules.spec(d.axes, d.shape), rules, axis), defs)


def shard_leaf(t: torch.Tensor, dim: Optional[int], rank: int, parts: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous shard of a whole leaf split in ``parts``
    equal pieces along ``dim``; the leaf itself where ``dim`` is None."""
    if dim is None:
        return t
    n = t.shape[dim]
    if n % parts:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {parts} ranks")
    return t.narrow(dim, rank * (n // parts), n // parts).contiguous()


def unshard_leaf(shards: Sequence[torch.Tensor], dim: Optional[int]) -> torch.Tensor:
    """The whole leaf from its ranks' shards in rank order (rank 0's where
    the leaf is whole on every rank)."""
    return shards[0] if dim is None else torch.cat(list(shards), dim=dim)


# the axes in the order a leaf is cut and joined (an axis splits one dim,
# and two axes never split the same one, so the order is only a convention)
CUT_ORDER = ("data", "model")


def cut_leaf(t: torch.Tensor, dims: Dict[str, Optional[int]], coords: Dict[str, int],
             sizes: Dict[str, int]) -> torch.Tensor:
    """The shard of a whole leaf that the rank at mesh ``coords`` holds:
    cut along ``dims[axis]`` into ``sizes[axis]`` parts for each axis."""
    for axis in CUT_ORDER:
        t = shard_leaf(t, dims.get(axis), coords[axis], sizes[axis])
    return t


def join_leaf(shards: Sequence[torch.Tensor], dims: Dict[str, Optional[int]],
              sizes: Dict[str, int]) -> torch.Tensor:
    """The whole leaf from every rank's shard in rank order (rank r at
    data ``r // model``, model ``r % model``): ``cut_leaf`` undone."""
    D, M = sizes.get("data", 1), sizes.get("model", 1)
    rows = [unshard_leaf(shards[d * M:(d + 1) * M], dims.get("model")) for d in range(D)]
    return unshard_leaf(rows, dims.get("data"))
