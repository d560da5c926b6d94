"""Ranks and their transport (``repro/launch/mesh.py``): one process per
data-parallel rank over ``torch.distributed``, where the reference runs one
program over a mesh of devices.

``maybe_init_distributed`` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), as the reference's
hook reads ``REPRO_COORDINATOR``, and joins the process group.
``make_local_mesh(data, model)`` returns a ``LocalMesh``: the world size
(``data * model``: the explicit engine folds every mesh axis into dp, as
the reference's does), this rank, its device, the process group and the
transport, with the collectives the engines issue (the all-gather and the
reduce-scatter along any dim, for the GSPMD engine's leaves).

Rank r sits at data coordinate ``r // model`` and model coordinate ``r %
model``, the row-major order in which the reference's ``make_local_mesh``
lays out its devices (``repro/launch/mesh.py:26-32``), so rank r holds
what the reference's device r holds. Every rank creates one process group
per model coordinate (the ranks of one data column: the ``"data"`` axis)
and one per data coordinate (the ranks of one model row: ``"model"``), in
the same order; each collective takes the ``axis`` it runs over (None:
every rank, the dp paths' default). An axis of one rank is the identity.

The transport is chosen by a rule, never on failure (``choose_backend``):

  * each rank has a card of its own: NCCL, on the device tensors;
  * ranks share a card (more local ranks than cards, as two ranks on one
    H100) or run on the CPU: gloo (NCCL refuses two ranks on one device).
    gloo takes each collective here on the CUDA tensors themselves
    (``COLLECTIVES``, probed by ``launch/probe_transport.py`` on the
    card), so every call is direct.

A run's device for rank r is ``cuda:{LOCAL_RANK % device_count}``, or the
CPU. A ``--data-mesh N`` run whose world size is not N raises, naming the
launch of the entry point that was run (``launch.train`` or
``launch.serve``) that gives it N ranks. With the tracer on, each collective is a
span (``sys="comm"``, class ``collective``, ``attr="io_wait"``: the
calling thread waits on the other ranks, and on a CUDA tensor on the
kernels that produce it), so a step's attribution carries
``trace_io_wait_collective_s``.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.runtime import trace

# The collectives the engines issue. gloo takes every one of them on CUDA
# tensors, in every dtype the engines hand it (f32, bf16, fp16 and int8: a
# q8 wire row's scales and quants; int64), with the right result: torch
# 2.11 on an H100, two ranks on the card (launch/probe_transport.py). So no collective is staged through host
# memory by the port (gloo copies a CUDA tensor through the host itself).
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")

# torch >= 2.12 renames the two tensor collectives (a FutureWarning on each
# call); the names the card's torch 2.11 has stay in use
warnings.filterwarnings("ignore", message=r".*(all_gather_into_tensor|reduce_scatter_tensor)"
                        r"` is deprecated", category=FutureWarning)

LAUNCH = "torchrun --standalone --nproc-per-node {n} -m repro_torch.launch.{entry} ..."
# a rank that waits longer than this on a collective raises instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


def choose_backend(device_type: str, local_ranks: int) -> str:
    """``nccl`` when each of the ``local_ranks`` ranks on this host has a
    card of its own, ``gloo`` when they share cards or run on the CPU."""
    if device_type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _local_rank() -> int:
    """This process's rank on its host (torchrun's ``LOCAL_RANK``; the
    global rank where no launcher set it)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return _env_int("LOCAL_RANK", rank)


def maybe_init_distributed(device_type: str) -> bool:
    """Join the process group torchrun's environment describes, on the
    backend ``choose_backend`` picks; True if this call created it (its
    caller destroys it), False where a group exists already or the
    environment holds one rank."""
    world = _env_int("WORLD_SIZE", 1)
    if dist.is_initialized() or world == 1:
        return False
    backend = choose_backend(device_type, _env_int("LOCAL_WORLD_SIZE", world))
    if backend == "nccl":
        torch.cuda.set_device(_env_int("LOCAL_RANK", 0))
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    return True


def _rank_device(device) -> torch.device:
    """The rank's device: ``cuda:{LOCAL_RANK % device_count}`` on the card,
    else the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a rank on cuda: CUDA is not available; this run needs a card")
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


AXES = ("data", "model")


@dataclasses.dataclass
class LocalMesh:
    """One rank's view of a ``data x model`` mesh: the explicit engine
    folds it into ``world`` dp ranks, the GSPMD engine reads both axes."""

    data: int
    model: int
    rank: int
    world: int
    device: torch.device
    group: Optional[object]  # the process group; None at one rank
    backend: str  # "nccl" | "gloo" | "none" (one rank)
    # {"data": group, "model": group}: this rank's group along each axis
    # (the world's where the axis spans every rank); empty without a group
    axis_groups: dict = dataclasses.field(default_factory=dict)

    def axis_sizes(self) -> dict:
        """The mesh's axis sizes, what the GSPMD engine's rules read."""
        return {"data": self.data, "model": self.model}

    def coords(self) -> dict:
        """This rank's ``{"data": r // model, "model": r % model}``."""
        return {"data": self.rank // self.model, "model": self.rank % self.model}

    def _axis(self, axis: Optional[str]) -> tuple:
        """(group, size) of a collective over ``axis`` (None: the world)."""
        if axis is None:
            return self.group, self.world
        size = self.axis_sizes()[axis]
        return (self.group if size == self.world else self.axis_groups.get(axis)), size

    def transport(self) -> dict:
        """``{"backend", "device", op: "direct"}``: every collective takes
        the rank's tensors where they are (``COLLECTIVES``)."""
        return {"backend": self.backend, "device": str(self.device),
                **{op: "direct" for op in COLLECTIVES}}

    # -- the collectives ----------------------------------------------------

    @staticmethod
    def _span(op: str, t: torch.Tensor):
        return trace.span(op, sys="comm", cls="collective", attr="io_wait",
                          nbytes=t.numel() * t.element_size())

    def all_gather(self, t: torch.Tensor, dim: int = 0, axis: Optional[str] = None
                   ) -> torch.Tensor:
        """The ranks' ``t`` (any shape) concatenated along ``dim``, in rank
        order along ``axis`` (None: every rank; ``all_gather_into_tensor``,
        which gathers along dim 0: any other dim is moved to the front for
        it and back after)."""
        group, n = self._axis(axis)
        if n == 1:
            return t
        t = t.movedim(dim, 0).contiguous()
        out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
        with self._span("all_gather_into_tensor", t):
            dist.all_gather_into_tensor(out, t, group=group)
        return out if dim == 0 else out.movedim(0, dim).contiguous()

    def all_gather_leaves(self, items: list, axis: Optional[str] = None) -> list:
        """``[(t, dim), ...]`` -> each ``t`` all-gathered along its ``dim``
        over ``axis`` (as ``all_gather``), in ONE collective: every
        tensor's bytes, its dim moved to the front, packed into one int8
        buffer (dtypes may differ), gathered, and cut back apart. Serving
        gathers a layer's leaves so, one collective a layer."""
        n = self._axis(axis)[1]
        if n == 1 or not items:
            return [t for t, _ in items]
        parts = [t.movedim(d, 0).contiguous() for t, d in items]
        flat = torch.cat([p.reshape(-1).view(torch.int8) for p in parts])
        rows = self.all_gather(flat, 0, axis).view(n, -1)
        out, off = [], 0
        for p, (_, d) in zip(parts, items):
            size = p.numel() * p.element_size()
            whole = rows[:, off:off + size].contiguous().view(p.dtype)
            whole = whole.reshape((n * p.shape[0],) + tuple(p.shape[1:]))
            out.append(whole if d == 0 else whole.movedim(0, d).contiguous())
            off += size
        return out

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0, axis: Optional[str] = None
                       ) -> torch.Tensor:
        """This rank's chunk along ``dim`` of the ranks' ``t`` summed over
        ``axis``, in ``t``'s dtype (``reduce_scatter_tensor``, along dim 0
        as ``all_gather``)."""
        group, n = self._axis(axis)
        if n == 1:
            return t
        t = t.movedim(dim, 0).contiguous()
        out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
        with self._span("reduce_scatter_tensor", t):
            dist.reduce_scatter_tensor(out, t, group=group)
        return out if dim == 0 else out.movedim(0, dim).contiguous()

    def all_reduce(self, t: torch.Tensor, axis: Optional[str] = None,
                   op: str = "sum") -> torch.Tensor:
        """The ranks' ``t`` reduced over ``axis`` (``op``: "sum" or
        "max"), in ``t``'s dtype, as a new tensor."""
        group, n = self._axis(axis)
        if n == 1:
            return t
        out = t.detach().clone(memory_format=torch.contiguous_format)
        with self._span("all_reduce", out):
            dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                            group=group)
        return out

    def gather_stack(self, t: torch.Tensor) -> torch.Tensor:
        """``(world, *t.shape)``: every rank's ``t`` in rank order."""
        return self.all_gather(t.reshape((1,) + tuple(t.shape)))

    def sum_over_ranks(self, values: list) -> list:
        """Host integers summed over the ranks (the step's byte counters)."""
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=dev)
        return [int(v) for v in self.all_reduce(t).cpu()]

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj`` in rank order (a serving run's
        per-rank results)."""
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out


def data_mesh(args) -> int:
    """A launch's data-parallel ranks (``launch.train``, ``launch.serve``):
    ``--data-mesh``, or where it is not given the devices a ``--plan`` is
    made for (``--hw-devices``) over ``--model-mesh``, else 1."""
    if args.data_mesh:
        return args.data_mesh
    if args.plan != "manual" and args.hw_devices:
        return max(1, args.hw_devices // getattr(args, "model_mesh", 1))
    return 1


def make_local_mesh(data: int = 1, model: int = 1, device="cpu",
                    entry: str = "train") -> LocalMesh:
    """This rank's mesh of ``data * model`` ranks on ``device`` (its card
    from ``_rank_device``). Raises where the process group holds another
    number of ranks, naming the launch of ``entry`` (``launch.<entry>``,
    the entry point that was run), or chose another backend than
    ``choose_backend``."""
    n = data * model
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(
            f"--data-mesh {data} --model-mesh {model} needs {n} ranks, one process "
            f"each, and this run has {world}: launch it as "
            + LAUNCH.format(n=n, entry=entry) + " --data-mesh ...")
    dev = _rank_device(device)
    if n == 1:
        return LocalMesh(data, model, 0, 1, dev, None, "none")
    backend = dist.get_backend()
    want = choose_backend(dev.type, _env_int("LOCAL_WORLD_SIZE", n))
    if backend != want:
        raise ValueError(f"the process group runs {backend}; ranks on {dev.type} "
                         f"with {torch.cuda.device_count()} card(s) take {want}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # every rank creates every group, in the same order: the data columns
    # (one a model coordinate), then the model rows (one a data coordinate)
    rank, groups = dist.get_rank(), {}
    if 1 < data < n:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                groups["data"] = g
    if 1 < model < n:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                groups["model"] = g
    return LocalMesh(data, model, rank, n, dev, dist.group.WORLD, backend, groups)
