"""The port's side of ``tests/test_torch_dp.py`` (job ``dp``, the explicit
engine) and ``tests/test_torch_gspmd_mesh.py`` (jobs ``gspmd`` and
``plan``, the GSPMD engine): one process per rank over
``torch.distributed`` (gloo on the CPU), spawned by ``spawn`` and run as a
script. Imports torch, numpy and ``repro_torch`` only, never JAX (pytest
does not collect this file).

A rank joins the group through a file store in the spawn's scratch
directory (no TCP port, so parallel test workers cannot collide), runs one
thread, runs its ``JOBS`` entry and saves its results to
``<scratch>/<job>_w<world>.rank<r>.pt``, then leaves the group. ``spawn`` starts the
ranks, joins them under a hard timeout that kills them all, and raises if
any failed.

  python tests/torch_dp_worker.py <job> <rank> <world> <scratch dir>
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

STEPS = 3
B, S = 4, 16  # the global batch: every dp here divides it
LR, WARMUP = 3e-3, 2

# case -> (dp, d_model (None: the smoke width), param, grad, opt tiers,
# grad_compression, partition_mode). The smoke smollm's row at 2 layers has
# P = 24,672 elements, a multiple of 4, so the dp-4 case takes d_model 47:
# P = 24,158 pads to 24,160 (two zeros in rank 3's slice).
CASES = {
    "allgather_dp2": (2, None, "device", "device", "device", "none", "allgather"),
    "allgather_dp4": (4, 47, "device", "device", "device", "none", "allgather"),
    "broadcast_dp2": (2, None, "device", "device", "device", "none", "broadcast"),
    "int8_dp2": (2, None, "device", "device", "device", "int8", "allgather"),
    "offgraph_dp2": (2, None, "device", "nvme", "nvme", "none", "allgather"),
    "layered_dp2": (2, None, "nvme", "nvme", "nvme", "none", "allgather"),
}
# the GSPMD engine's cases: case -> (dp, arch, d_model (None: the smoke
# width), zero stage, param, grad, opt tiers, grad_accum, global batch B).
# smollm is cut to 2 layers, the other families keep their smoke depth; S
# is 16 tokens (seamless: 64 frames, 16 decoder tokens). d_model 47 splits
# over no rank: every leaf stays whole (the divisibility guard), and B = 3
# does not split over 2 ranks: both take the whole batch.
GSPMD_CASES = {
    "stage3_dp2": (2, "smollm-135m", None, 3, "device", "device", "device", 1, 4),
    "stage3_dp4": (4, "smollm-135m", None, 3, "device", "device", "device", 1, 4),
    "stage0_dp2": (2, "smollm-135m", None, 0, "device", "device", "device", 1, 4),
    "stage1_dp2": (2, "smollm-135m", None, 1, "device", "device", "device", 1, 4),
    "stage2_dp2": (2, "smollm-135m", None, 2, "device", "device", "device", 1, 4),
    "host_dp2": (2, "smollm-135m", None, 3, "host", "device", "host", 1, 4),
    "nvme_opt_dp2": (2, "smollm-135m", None, 3, "device", "nvme", "nvme", 1, 4),
    "accum2_dp2": (2, "smollm-135m", None, 3, "device", "device", "device", 2, 4),
    "unsplit_dp2": (2, "smollm-135m", 47, 3, "device", "device", "device", 1, 4),
    "batch3_dp2": (2, "smollm-135m", None, 3, "device", "device", "device", 1, 3),
    "vlm_dp2": (2, "llava-next-34b", None, 3, "device", "device", "device", 1, 4),
    "hybrid_dp2": (2, "recurrentgemma-9b", None, 3, "device", "device", "device", 1, 4),
    "ssm_dp2": (2, "mamba2-370m", None, 3, "device", "device", "device", 1, 4),
    "encdec_dp2": (2, "seamless-m4t-medium", None, 3, "device", "device", "device", 1, 4),
}
GSPMD_STEPS = 2
# the plan job's argv: the planner's hardware pinned (no detected number
# enters the plan), two devices, the smoke smollm
PLAN_ARGV = ["--smoke", "--device", "cpu", "--plan", "auto", "--hw-devices", "2",
             "--hw-device-mem", "4e9", "--hw-host-mem", "64e9", "--hw-nvme", "1e12",
             "--steps", "3", "--batch", "4", "--seq", "16", "--lr", "3e-3",
             "--ckpt-every", "0", "--log-every", "100"]
# the psum_compressed cases: (shape, dtype) over three steps of error feedback
PSUM_CASES = [((49, 7), "float32"), ((300,), "bfloat16"), ((2, 256), "float32")]


def psum_inputs(shape, step: int, world: int) -> np.ndarray:
    """The (world, *shape) f32 inputs of one psum_compressed step, each
    rank's its row (rounded to bf16 by the caller where the case is)."""
    rng = np.random.default_rng([len(shape), step, world])
    return (rng.standard_normal((world,) + tuple(shape))
            * np.array([1.0, 30.0, 1e-3, 7.0][:world]).reshape((world,) + (1,) * len(shape))
            ).astype(np.float32)


def _name(job: str, world: int) -> str:
    return f"{job}_w{world}"


def spawn(job: str, world: int, tmp: str, timeout: float = 120.0) -> list:
    """Run ``job`` on ``world`` ranks, one process each, and return each
    rank's results in rank order; every rank is killed and the call raises
    if one fails or the spawn outlives ``timeout`` seconds."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    os.makedirs(tmp, exist_ok=True)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(r),
                               str(world), tmp], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        outs = []
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise RuntimeError(f"{job}: {world} ranks outlived {timeout} s; killed")
    failed = [(r, out) for r, (p, out) in enumerate(zip(procs, outs)) if p.returncode]
    if failed:
        raise RuntimeError(f"{job}: rank {failed[0][0]} failed:\n{failed[0][1][-4000:]}")
    import torch

    return [torch.load(os.path.join(tmp, f"{_name(job, world)}.rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------


def _runs(case: str, nvme_dir: str):
    from repro_torch import configs
    from repro_torch.config import RunConfig, TrainConfig, make_offload, make_parallel

    dp, d_model, param, grad, opt, compress, mode = CASES[case]
    wide = {} if d_model is None else {"d_model": d_model}
    cfg = dataclasses.replace(configs.smoke("smollm-135m"), n_layers=2, **wide)
    return RunConfig(model=cfg,
                     parallel=make_parallel("zero3", remat="none", grad_compression=compress,
                                            partition_mode=mode),
                     offload=make_offload(param_tier=param, grad_tier=grad, opt_tier=opt,
                                          nvme_dir=nvme_dir),
                     train=TrainConfig(lr=LR, warmup_steps=WARMUP))


def init_path(tmp: str, case: str) -> str:
    """Where the test saves ``case``'s global initial state: the
    reference's tier-independent leaves (``flat`` padded for the case's
    dp, ``other``, ``other_opt``, ``step``) as the port's tensors."""
    dp, d_model = CASES[case][:2]
    return os.path.join(tmp, f"init_{d_model or 'smoke'}_dp{dp}.pt")


def run_case(case: str, tmp: str, mesh) -> dict:
    """``STEPS`` steps of ``case`` on this rank from the global initial
    state at ``init_path`` (its residual, in-graph master and moments
    completed on the rank as the reference's init draws them), on the
    rank's slices of the global batches."""
    import torch

    from repro_torch import bridge
    from repro_torch.config import ShapeConfig
    from repro_torch.core import executor as texec
    from repro_torch.data import pipeline as tpipe

    run = _runs(case, os.path.join(tmp, case, "torch"))
    ex = texec.InfinityExecutor(run, "cpu", mesh=mesh if mesh.world > 1 else None)
    init = torch.load(init_path(tmp, case), weights_only=False)
    state = bridge.shard_zero3_state(init, mesh.rank, mesh.world, run.parallel.partition_mode)
    state = ex.reseed(ex.engine.place_state(ex.engine.complete_state(state)))
    stream = tpipe.SyntheticStream(ex.input_specs(ShapeConfig("t", S, B, "train")),
                                   run.model.vocab_size, seed=0)
    step = ex.make_train_step()
    metrics = []
    for i in range(STEPS):
        batch = tpipe.rank_slice(stream.batch_at(i), mesh.rank, mesh.world)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        metrics.append({k: (float(v) if isinstance(v, torch.Tensor) else v)
                        for k, v in m.items()})
    flat = ex.materialize_flat() if ex.layered else state["flat"]
    out = {"metrics": metrics, "flat": flat.float().clone(),
           "other": state["other"], "step": int(state["step"]),
           "opt_keys": sorted(ex.opt_store.keys()) if ex.opt_store is not None else []}
    for key in ("master", "m", "v", "g_err"):
        if key in state:
            out[key] = state[key]
    ex.close()
    return out


def job_dp(tmp: str, mesh) -> dict:
    """Every case at this world size, then, at 2 ranks, the units: the row
    gather against ``reduce_scatter_tensor`` and ``psum_compressed``."""
    out = {case: run_case(case, tmp, mesh) for case, spec in CASES.items()
           if spec[0] == mesh.world}
    if mesh.world == 2:
        out["row_gather"] = row_gather_unit(mesh)
        out["psum"] = psum_unit(mesh)
    return out


def row_gather_unit(mesh) -> dict:
    """``RowGather`` on this rank's bf16 slice: forward against
    ``all_gather_into_tensor``, the slice's gradient for a per-rank
    cotangent against ``reduce_scatter_tensor`` of that cotangent."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.zero import RowGather

    gen = torch.Generator().manual_seed(10 + mesh.rank)
    piece = torch.randn(96, generator=gen).to(torch.bfloat16).requires_grad_()
    ct = torch.randn(96 * mesh.world, generator=gen).to(torch.bfloat16)
    row = RowGather.apply(piece, mesh)
    (grad,) = torch.autograd.grad(row, piece, ct)
    want_row = torch.empty_like(row)
    dist.all_gather_into_tensor(want_row, piece.detach())
    want_grad = torch.empty_like(piece)
    dist.reduce_scatter_tensor(want_grad, ct)
    return {"row": row.detach(), "want_row": want_row, "grad": grad, "want_grad": want_grad}


def psum_unit(mesh) -> dict:
    """``psum_compressed`` over three steps of error feedback per case, on
    this rank's row of ``psum_inputs``: (reduced, new residual) per step."""
    import torch

    from repro_torch.optim import compression

    out = {}
    for shape, dtype in PSUM_CASES:
        err, steps = torch.zeros(shape), []
        for i in range(3):
            x = torch.from_numpy(psum_inputs(shape, i, mesh.world)[mesh.rank])
            x = x.to(getattr(torch, dtype))
            red, err = compression.psum_compressed(x, err, mesh)
            steps.append((red.float(), err))
        out[(shape, dtype)] = steps
    return out


# ---------------------------------------------------------------------------
# the GSPMD engine on the ranks
# ---------------------------------------------------------------------------


def gspmd_cfg(case: str, package):
    """``case``'s model config from ``package``'s ``configs`` (either
    package: their configs are equal field for field)."""
    _, arch, d_model, *_ = GSPMD_CASES[case]
    cfg = package.smoke(arch)
    cut = {"n_layers": 2} if arch == "smollm-135m" else {}
    if d_model is not None:
        cut["d_model"] = d_model
    return dataclasses.replace(cfg, **cut)


def gspmd_seq(case: str) -> int:
    return 64 if GSPMD_CASES[case][1] == "seamless-m4t-medium" else S


def gspmd_init_path(tmp: str, case: str) -> str:
    """Where the test saves ``case``'s initial params: the reference
    engine's ``init_state`` at one device, as the port's whole tensors."""
    return os.path.join(tmp, f"gspmd_init_{case}.pt")


def _gspmd_run(case: str, nvme_dir: str):
    from repro_torch import configs
    from repro_torch.config import RunConfig, TrainConfig, make_offload, make_parallel

    _, _, _, stage, param, grad, opt, accum, _ = GSPMD_CASES[case]
    return RunConfig(model=gspmd_cfg(case, configs),
                     parallel=make_parallel("pjit", remat="none", zero_stage=stage,
                                            grad_accum=accum),
                     offload=make_offload(param_tier=param, grad_tier=grad, opt_tier=opt,
                                          nvme_dir=nvme_dir),
                     train=TrainConfig(lr=LR, warmup_steps=WARMUP))


def run_gspmd_case(case: str, tmp: str, mesh) -> dict:
    """``GSPMD_STEPS`` steps of ``case`` on this rank from the global
    params at ``gspmd_init_path`` (Adam's masters their f32 copies, zero
    moments, as the reference's init), each rank its shards
    (``bridge.shard_gspmd_state``), on its rows of the global batches
    (``rank_batch``)."""
    import torch

    from repro_torch import bridge
    from repro_torch.config import ShapeConfig
    from repro_torch.core import executor as texec
    from repro_torch.data import pipeline as tpipe
    from repro_torch.optim import adam

    run = _gspmd_run(case, os.path.join(tmp, case, "torch"))
    ex = texec.InfinityExecutor(run, "cpu", mesh=mesh)
    params = torch.load(gspmd_init_path(tmp, case), weights_only=False)
    full = {"params": params}
    if not run.opt_offgraph:
        full["opt"] = adam.init_state(params)
    state = bridge.shard_gspmd_state(full, run, mesh.rank, mesh.world)
    state = ex.reseed(ex.engine.place_state(state))
    B = GSPMD_CASES[case][8]
    stream = tpipe.SyntheticStream(ex.input_specs(ShapeConfig("t", gspmd_seq(case), B, "train")),
                                   run.model.vocab_size, seed=0)
    step = ex.make_train_step()
    metrics = []
    for i in range(GSPMD_STEPS):
        batch = tpipe.rank_batch(stream.batch_at(i), mesh.rank, mesh.world,
                                 run.parallel.grad_accum)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        metrics.append({k: (float(v) if isinstance(v, torch.Tensor) else v)
                        for k, v in m.items()})
    out = {"metrics": metrics, "params": state["params"], "splits": ex.engine.splits,
           "shard_bytes": ex.engine.shard_bytes(),
           "opt_keys": sorted(ex.opt_store.keys()) if ex.opt_store is not None else []}
    if "opt" in state:
        out["opt"] = tuple(state["opt"])
    ex.close()
    return out


def job_gspmd(tmp: str, mesh) -> dict:
    """Every GSPMD case at this world size, then, at 2 ranks, the plan's
    run (``job_plan``)."""
    out = {case: run_gspmd_case(case, tmp, mesh) for case, spec in GSPMD_CASES.items()
           if spec[0] == mesh.world}
    if mesh.world == 2:
        out["plan"] = job_plan(tmp, mesh)
        out["leaf_gather"] = leaf_gather_unit(mesh)
    return out


def leaf_gather_unit(mesh) -> dict:
    """``LeafGather`` on this rank's bf16 (3, 5, 4) shard along dim 1:
    forward against the ranks' shards concatenated there, the shard's
    gradient for a per-rank cotangent against the sum of the ranks'
    cotangents' parts on this rank's columns."""
    import torch

    from repro_torch.core.zero import LeafGather

    def draw(r):
        gen = torch.Generator().manual_seed(20 + r)
        return (torch.randn(3, 5, 4, generator=gen).to(torch.bfloat16),
                torch.randn(3, 5 * mesh.world, 4, generator=gen).to(torch.bfloat16))

    shards, cts = zip(*(draw(r) for r in range(mesh.world)))
    shard = shards[mesh.rank].clone().requires_grad_()
    leaf = LeafGather.apply(shard, mesh, 1)
    (grad,) = torch.autograd.grad(leaf, shard, cts[mesh.rank])
    want_grad = cts[0][:, 5 * mesh.rank:5 * (mesh.rank + 1)]
    for ct in cts[1:]:  # the sum in rank order, rounded to bf16 at each add
        want_grad = want_grad + ct[:, 5 * mesh.rank:5 * (mesh.rank + 1)]
    return {"leaf": leaf.detach(), "want_leaf": torch.cat(shards, dim=1), "grad": grad,
            "want_grad": want_grad}


def job_plan(tmp: str, mesh) -> dict:
    """``launch.train --plan auto --hw-devices 2`` in this rank's group
    (``PLAN_ARGV``): its plan, resolved run and losses."""
    from repro_torch.launch import train

    argv = PLAN_ARGV + ["--nvme-dir", os.path.join(tmp, "plan_nvme"),
                        "--ckpt-dir", os.path.join(tmp, "plan_ck")]
    hist = train.train(train.build_argparser().parse_args(argv), argv)
    return {"plan": hist["plan"].to_json(), "run": dataclasses.asdict(hist["run"]),
            "losses": hist["losses"], "metrics": hist["metrics"]}


JOBS = {"dp": job_dp, "gspmd": job_gspmd}


def main() -> None:
    job, rank, world, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod

    torch.set_num_threads(1)
    name = _name(job, world)
    dist.init_process_group(mesh_mod.choose_backend("cpu", world),
                            init_method=f"file://{os.path.join(tmp, name + '.pg')}",
                            rank=rank, world_size=world, timeout=mesh_mod.TIMEOUT)
    try:
        mesh = mesh_mod.make_local_mesh(world, 1, "cpu")
        torch.save(JOBS[job](tmp, mesh), os.path.join(tmp, f"{name}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
