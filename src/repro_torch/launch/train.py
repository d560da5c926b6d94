"""Training entry point: synthetic data -> InfinityExecutor -> per-step
metrics and checkpoints, with fault injection, restart and straggler
detection — the port of ``repro/launch/train.py``, on one device or on a
data-parallel mesh of ranks:

  * ``--plan auto``: the planner (``repro_torch/plan.py``) derives the
    placement from the detected card (``--hw-*`` override what detection
    reads, ``--objective`` picks the objective), and every legacy flag
    given on the command line becomes a per-field override of the derived
    plan, as in the reference; the plan's ``explain()`` is printed and its
    cross-check fields (``plan_*``) land in the step metrics. ``--plan
    <file.json>`` loads a saved plan.
  * ``--plan manual`` (default): the flags as given. ``--engine pjit``
    (default) runs the GSPMD engine's step and ``--engine zero3`` the
    explicit engine's monolithic step, each with params on the device or
    host tier: in-graph fused Adam with the optimizer on the device or
    host tier, or off-graph (``ChunkedAdamOffload``) with the optimizer on
    NVMe or the gradients drained to host or NVMe (the ZeRO-Offload
    placement); ``--grad-accum`` and ``--remat`` (``full``, ``dots``,
    ``none``) are honoured by the GSPMD engine, ``--remat`` and
    ``--grad-compress int8`` by the explicit one. ``--engine pjit
    --offload-param nvme`` keeps every param leaf in the NVMe param store
    and loads it through the leaf scheduler each step (any optimizer and
    gradient tier; ``--param-quant`` q8/q4 encodes the leaves in the store,
    decoded on read).
    ``--engine zero3 --offload-param nvme`` runs the layered epoch with
    every state class on the slow tiers; ``--param-quant q8`` ships its
    rows as q8 wire bytes into the quantized-matmul kernel, ``q4`` rows
    decode on the host. A MoE model (``--arch granite-moe-1b-a400m``)
    trains under ``--engine pjit`` (all-resident) and the layered epoch,
    where its expert rows page as units of their own (the explicit
    engine's monolithic step refuses MoE, as the reference's); its steps
    carry ``moe_dropped_token_fraction``, the (E,) ``moe_expert_load`` and,
    layered, the ``expert_*`` residency counters, and the run ends with a
    ``moe:`` line of them. The hot-expert budget comes from the plan's
    ``expert_hot_mb`` override, as in the reference (no flag). The
    fixed-state, VLM and encoder-decoder families (``--arch mamba2-370m``,
    ``recurrentgemma-9b``, ``llava-next-34b``, ``seamless-m4t-medium``)
    train under ``--engine pjit``; the explicit engine refuses them, as the
    reference's does. A VLM's ``--seq`` counts its vision positions; an
    encoder-decoder's is the encoder's frames (its decoder takes a
    quarter), and ``--layers`` is refused on it.
  * checkpoints every ``--ckpt-every`` steps into ``--ckpt-dir``
    (``checkpoint/manager.py``, the reference's format), with the data
    cursor as ``{"next_step"}``; ``REPRO_FAIL_AT_STEP`` (and
    ``REPRO_FAIL_MARKER``) inject a failure, ``retry_loop`` restarts the
    run up to ``--max-restarts`` times within ``--recovery-budget``
    seconds, and ``--resume auto`` resumes from the newest intact
    checkpoint: the full state, or on a tier change the tier-independent
    leaves (``portable_like``/``adopt_state``); ``--straggler-factor``
    flags slow steps.

  * ``--data-mesh N``: N data-parallel ranks, one process each, launched
    by torchrun (``launch/mesh.py``), on ``cuda:{LOCAL_RANK %
    device_count}`` (NCCL when each rank has a card, gloo when ranks share
    one) or the CPU (gloo) under ``--device cpu``. ``--engine pjit``: the
    GSPMD engine with each leaf laid out by the reference's rules at
    ``--zero-stage`` (``core/engine.py``: at stage 3 every rank holds its
    shard of params, gradients and optimizer states); ``--engine zero3``:
    the explicit engine over N * M ranks (``--model-mesh M`` folds into
    dp, as the reference's), each holding its shard of the rows. Rank r
    takes its rows of each global batch (``data/pipeline.rank_batch``: the
    whole batch where B does not split). ``--plan auto --hw-devices N``
    plans for N devices and runs on N ranks (``--data-mesh`` defaults to
    the plan's devices over ``--model-mesh``); a plan for another number
    of devices than the run's ranks raises, naming both.
  * ``--engine pjit --data-mesh D --model-mesh M``: the GSPMD engine on D *
    M ranks, rank r at data coordinate r // M and model coordinate r % M
    (the reference's device order), every family under tensor parallelism
    (heads, MLP columns or experts, the recurrent blocks' ``inner``
    channels, and vocab rows over the model
    ranks) or context parallelism (the sequence over them; ``inner`` stays
    split, its blocks gather the sequence; the encoder-decoder's frames and
    decoder tokens both, each a multiple of M) as the reference's
    ``choose_attn_strategy`` picks (``core/engine.py``); the model ranks of
    one data row take the same rows of the batch (an encoder-decoder's
    frames too). Every rank runs ``train`` and returns
    its history; rank 0 prints the step lines, each with the rank's bytes
    (tier bytes; the GSPMD engine's state shards) and their sum over the
    ranks. A run whose world size is not N * M raises, naming the launch.

  * checkpoints and ``--resume auto`` on a mesh: every rank takes part in
    ``checkpoint_state``'s gathers and rank 0 writes the global leaves,
    the file set a one-rank run of the same state writes (the reference's
    format); on a resume rank 0 waits for its persist, picks the newest
    intact step and every rank restores it, cutting its part of the
    global leaves, so a checkpoint written on any mesh (another dp or
    model size, one rank, the reference's host-device mesh) restores on
    any other. ``REPRO_FAIL_MARKER`` is then each rank's own
    (``<marker>.rank<r>``), so every rank fails at the step and restarts.

Runs on the card by default and raises when CUDA is absent; ``--device
cpu`` runs the kernels' plain versions (the tests do). On a mesh the
explicit engine's layered epoch takes MoE's expert rows (each rank its
column slice of every expert row) and ``--param-quant`` q8/q4 rows (each
rank's slice encoded on its own; q8 slices gathered as wire bytes), and
the GSPMD engine takes the MoE family (the routing statistics summed over
the data ranks) and params on NVMe (each rank its shards in its own store,
``--param-quant`` encoding each shard on its own). What is not ported
raises, naming the ROADMAP item that ports it: ``--elastic``/``--chaos``
(item 5, the elastic supervisor). On the layered epoch
``--grad-compress int8`` and ``partition_mode="broadcast"`` raise the
reference's ``ValueError``s. The explicit engine reads neither
``--zero-stage`` nor ``--grad-accum``, as the reference's does not.

Examples (one H100; llava-next-34b at full width cut to 2 layers):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --plan auto --batch 8 --seq 512 --steps 4 --lr 3e-3
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --engine zero3 --offload-opt host --batch 8 --seq 512 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --engine zero3 --offload-param nvme --offload-grad nvme \\
      --offload-opt nvme --batch 8 --seq 512 --steps 8 --lr 3e-3
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --plan auto --batch 8 --seq 512 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch llava-next-34b \\
      --layers 2 --plan auto --batch 1 --seq 4096 --steps 4 --lr 3e-3
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch seamless-m4t-medium --plan auto --batch 8 --seq 2048 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch seamless-m4t-medium --plan auto --objective min_device_mem \\
      --batch 8 --seq 2048 --steps 3 --nvme-dir /path/on/nvme
  REPRO_FAIL_AT_STEP=3 REPRO_FAIL_MARKER=/tmp/m PYTHONPATH=src \\
      python -m repro_torch.launch.train ... --ckpt-every 2 --resume auto
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch smollm-135m --engine zero3 \\
      --data-mesh 2 --offload-param nvme --offload-grad nvme \\
      --offload-opt nvme --batch 8 --seq 512 --steps 4
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch smollm-135m --engine pjit \\
      --data-mesh 2 --zero-stage 3 --batch 8 --seq 512 --steps 4
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch smollm-135m --engine pjit \\
      --data-mesh 2 --offload-param nvme --offload-grad nvme \\
      --offload-opt nvme --param-quant q8 --batch 8 --seq 512 --steps 2 \\
      --nvme-dir /path/on/nvme
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch smollm-135m --plan auto \\
      --hw-devices 2 --batch 8 --seq 512 --steps 4 --ckpt-every 2 \\
      --ckpt-dir /path/ck --resume auto
  PYTHONPATH=src torchrun --standalone --nproc-per-node 3 \\
      -m repro_torch.launch.train --arch smollm-135m --engine pjit \\
      --model-mesh 3 --batch 8 --seq 512 --steps 4
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch import plan as plan_mod
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import (RunConfig, ShapeConfig, TrainConfig,
                                make_offload, make_parallel)
from repro_torch.core.executor import InfinityExecutor
from repro_torch.data.pipeline import PrefetchLoader, SyntheticStream
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import data_mesh
from repro_torch.launch.serve import resolve_device
from repro_torch.runtime import trace
from repro_torch.runtime.elastic import wire_straggler
from repro_torch.runtime.fault import FailureInjector, StragglerMonitor, retry_loop
from repro_torch.runtime.metrics import (MetricsLogger, elastic_step_metrics,
                                         rank_bytes_note)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers at full width "
                         "(0: the config's depth)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu "
                         "(the plain versions)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data-mesh", type=int, default=0,
                    help="data-parallel ranks (launch them with torchrun); "
                         "0: the plan's --hw-devices under --plan, else 1")
    ap.add_argument("--model-mesh", type=int, default=1,
                    help="model-parallel ranks: N * M ranks in all; the GSPMD "
                         "engine runs tensor or context parallelism over them "
                         "(every family), the explicit engine folds "
                         "them into dp, as the reference's")
    ap.add_argument("--engine", default="pjit", choices=["pjit", "zero3"],
                    help="pjit = the GSPMD engine's step (params on the device "
                         "or host tier); zero3 = the explicit engine's "
                         "monolithic step (params on the device or host tier) "
                         "or layered epoch (params on NVMe)")
    ap.add_argument("--zero-stage", type=int, default=3,
                    help="the GSPMD engine's partition rules (the explicit "
                         "engine is ZeRO-3 whatever its value)")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches per step (the GSPMD engine; the "
                         "explicit engine takes one)")
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"],
                    help="activation checkpoint policy of the loss (dots: "
                         "save the products without a batch dim)")
    for cls, what in (("opt", "optimizer-state (fp32 master/m/v)"),
                      ("param", "bf16 compute-parameter"),
                      ("grad", "gradient drain")):
        ap.add_argument(f"--offload-{cls}", default="device",
                        choices=["device", "host", "nvme"], help=f"{what} tier")
    ap.add_argument("--nvme-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_nvme"))
    ap.add_argument("--no-overlap", action="store_true", help="disable store overlap")
    ap.add_argument("--prefetch-layers", type=int, default=0,
                    help="layer-scheduler window (0 = bandwidth-aware auto "
                         "from the paper's model)")
    ap.add_argument("--param-quant", default="none", choices=["none", "q8", "q4"],
                    help="block-quantized wire format for the param rows "
                         "(core/qformat.py): q8 rows feed the quantized-matmul "
                         "kernel as they are, q4 rows decode on the host")
    ap.add_argument("--grad-compress", default="none", choices=["none", "int8"],
                    help="int8 + error-feedback wire format on the zero3 "
                         "monolithic step's replicated-grad reduce "
                         "(optim/compression.py)")
    ap.add_argument("--read-ahead", type=int, default=2,
                    help="slow-tier param reads in flight beyond the window")
    ap.add_argument("--nvme-workers", type=int, default=2,
                    help="worker threads per slow-tier store")
    ap.add_argument("--pinned-buffer-mb", type=int, default=64,
                    help="shared pinned buffer-pool budget (all stores)")
    plan_mod.add_plan_args(ap)
    ap.add_argument("--elastic", action="store_true", help="not ported: raises")
    ap.add_argument("--chaos", default=None, help="not ported: raises")
    ap.add_argument("--straggler-factor", type=float, default=3.0,
                    help="flag a step as a straggler when its wall time "
                         "exceeds this multiple of the running median")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="restart budget for crash recovery")
    ap.add_argument("--recovery-budget", type=float, default=60.0,
                    help="max cumulative recovery wall-clock seconds before "
                         "giving up")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="steps between checkpoints (0: none)")
    ap.add_argument("--resume", default="no", choices=["no", "auto"],
                    help="auto: resume from the newest intact checkpoint")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", nargs="?", const="trace.json", default=None,
                    metavar="OUT.json",
                    help="record spans and write a Chrome/Perfetto trace; "
                         "per-step stall attribution lands in the step "
                         "metrics as trace_* fields")
    return ap


def _unported(args) -> None:
    """Raise for every flag set to something the port cannot run: the
    elastic supervisor's (membership from the process group, chaos
    injection), on one rank or on a mesh."""
    item = "ROADMAP.md Queue 1 item 5: the elastic supervisor"
    for bad, what in ((args.elastic, "--elastic"), (args.chaos is not None, "--chaos")):
        if bad:
            raise NotImplementedError(f"{what} is not ported yet ({item})")


def make_run(args, argv=None):
    """(RunConfig, Optional[InfinityPlan]). With ``--plan auto`` (or a saved
    plan) the planner derives every offload/engine knob and the legacy
    flags given in ``argv`` (default ``sys.argv[1:]``) act only as explicit
    per-field overrides; ``--plan manual`` keeps the flags as given."""
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    cfg = configs.with_layers(cfg, args.layers)
    tc = TrainConfig(lr=args.lr, steps=args.steps, checkpoint_dir=args.ckpt_dir,
                     checkpoint_every=args.ckpt_every, seed=args.seed)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    plan = plan_mod.resolve_plan(args, cfg, shape, nvme_dir=args.nvme_dir, argv=argv)
    if plan is not None:
        run = plan.to_run_config(train=tc, nvme_dir=args.nvme_dir,
                                 overlap=not args.no_overlap)
        # non-plan parallelism knobs stay CLI-driven under --plan auto; int8
        # compression on a pjit plan raises ParallelConfig's ValueError
        par_kw = {"zero_stage": args.zero_stage}
        if args.grad_compress != "none":
            par_kw["grad_compression"] = args.grad_compress
        run = run.replace(parallel=dataclasses.replace(run.parallel, **par_kw))
        return run, plan
    run = RunConfig(
        model=cfg,
        parallel=make_parallel(args.engine, zero_stage=args.zero_stage,
                               grad_accum=args.grad_accum, remat=args.remat,
                               grad_compression=args.grad_compress),
        offload=make_offload(opt_tier=args.offload_opt,
                             param_tier=args.offload_param,
                             grad_tier=args.offload_grad, nvme_dir=args.nvme_dir,
                             overlap=not args.no_overlap,
                             prefetch_layers=args.prefetch_layers,
                             param_quant=args.param_quant,
                             param_read_ahead=args.read_ahead,
                             nvme_workers=args.nvme_workers,
                             pinned_buffer_mb=args.pinned_buffer_mb),
        train=tc,
    )
    return run, None


def _host(v):
    """A step metric as a host number: a 0-d tensor as a float, a vector
    (the MoE (E,) ``moe_expert_load``) as a list of floats."""
    if isinstance(v, torch.Tensor):
        return float(v) if v.dim() == 0 else v.double().tolist()
    return v


def train(args, argv=None, *, init_state=None) -> dict:
    """Run ``args.steps`` steps under ``retry_loop``. Returns ``{"losses",
    "grad_norms", "metrics" (one dict of host numbers per step run, with
    step_time and tokens_per_s; a restarted run repeats the steps it
    redoes), "restarts", "recovery_s", "final_state", "checkpoint" (the
    manager's last bytes and timings), "nvme_stats", "trace_attributions",
    "quantized_leaves" (the MLP weights whose products read the q8 rows in
    place), "plan" (the ``InfinityPlan``, or None in manual mode), "run"
    (the resolved ``RunConfig``), "mesh" (the rank's ``LocalMesh``)}``, on
    every rank of a mesh, with the rank's metrics. ``argv`` is what
    ``make_run`` reads overrides from; ``init_state``, a callable returning
    an engine state (the rank's shard on a mesh), replaces the seeded draw
    (the parity tests pass the reference's). Joins the process group
    torchrun describes where none exists, and leaves it before returning."""
    device = resolve_device(args.device)
    created = mesh_mod.maybe_init_distributed(device.type)
    try:
        mesh = mesh_mod.make_local_mesh(data_mesh(args), args.model_mesh, device)
        _unported(args)
        return _train(args, argv, init_state, mesh)
    finally:
        if created:
            torch.distributed.destroy_process_group()


def _train(args, argv, init_state, mesh) -> dict:
    device = mesh.device
    run, plan = make_run(args, argv)
    executor = InfinityExecutor(run, device, plan=plan, mesh=mesh if mesh.world > 1 else None)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    tokens = shape.global_batch * shape.seq_len
    tc = run.train
    ckpt = CheckpointManager(tc.checkpoint_dir, keep=tc.keep_checkpoints)
    # each rank of a mesh fails at the step, under a marker of its own
    injector = FailureInjector(rank=mesh.rank if mesh.world > 1 else None)
    straggler = wire_straggler(StragglerMonitor(factor=args.straggler_factor))
    retry_stats = {"restarts": 0, "recovery_s": 0.0}
    history = {"losses": [], "grad_norms": [], "metrics": [], "restarts": 0,
               "plan": plan, "run": run, "mesh": mesh}

    def fresh_state(resuming: bool) -> dict:
        # a resume reseeds the stores from the restored state: skip seeding
        # them from the throwaway init
        if init_state is None:
            gen = torch.Generator(device=device).manual_seed(tc.seed)
            return executor.init_state(gen, seed_stores=not resuming)
        state = executor.engine.place_state(init_state())
        return state if resuming else executor.reseed(state)

    def run_once():
        ckpt.wait()  # a save the failure interrupted commits first (rank 0's)
        # with --resume auto rank 0 reads the directory once its persist
        # has committed, and every rank follows its answer (the gather is
        # the ranks' barrier)
        resuming = args.resume == "auto" and mesh.gather_objects(
            mesh.rank == 0 and ckpt.latest_step() is not None)[0]
        state = fresh_state(resuming)
        start_step = 0
        if resuming:
            state, start_step = _resume(ckpt, executor, state, mesh)
            if mesh.rank == 0:
                print(f"resumed from checkpoint at step {start_step}")

        step_fn = executor.make_train_step()
        stream = SyntheticStream(executor.input_specs(shape), run.model.vocab_size,
                                 seed=tc.seed)
        # the explicit engine takes one microbatch whatever grad_accum says
        accum = 1 if executor.explicit else run.parallel.grad_accum
        # the GSPMD engine's model ranks of one data row take its rows; the
        # explicit engine's ranks are all data parallel
        rank, dp = ((mesh.rank, mesh.world) if executor.explicit
                    else (mesh.coords()["data"], mesh.data))
        loader = PrefetchLoader(stream, start_step, tc.steps, device,
                                rank=rank, dp=dp, accum=accum)
        # rank 0 prints the step lines; the MFU counts the cards the ranks
        # run on (ranks beyond the host's cards share them)
        cards = min(mesh.world, torch.cuda.device_count()) if device.type == "cuda" else 1
        logger = MetricsLogger(executor.n_params_active(), n_chips=cards,
                               log_fn=print if mesh.rank == 0 else (lambda _: None))
        for step, batch in loader:
            straggler.start()
            injector.maybe_fail(step)
            state, metrics = step_fn(state, batch)
            rec = {k: _host(v) for k, v in metrics.items()}  # waits for the step
            dt = straggler.stop(step)
            rec.update(step=step, step_time=dt, tokens_per_s=tokens / dt)
            history["losses"].append(rec["loss"])
            history["grad_norms"].append(rec["grad_norm"])
            history["metrics"].append(rec)
            if step % args.log_every == 0:
                extras = elastic_step_metrics(restarts=retry_stats["restarts"],
                                              recovery_s=retry_stats["recovery_s"])
                extras.update(straggler.step_metrics())
                if mesh.world > 1:
                    extras["note"] = rank_bytes_note(rec, mesh.world)
                logger.log(step, rec["loss"], tokens, dt, **extras)
            if tc.checkpoint_every and (step + 1) % tc.checkpoint_every == 0:
                # the layered epoch's rows are materialized from the store;
                # on a mesh every rank gathers, and rank 0 saves
                snapshot = executor.checkpoint_state(state)
                if snapshot is not None:
                    ckpt.save(step + 1, snapshot, {"next_step": step + 1})
        ckpt.wait()
        history["final_state"] = state

    try:
        history["restarts"] = retry_loop(
            run_once, max_restarts=args.max_restarts,
            recovery_budget_s=args.recovery_budget, stats=retry_stats,
            on_restart=lambda n, e: print(f"restart #{n} after: {e}"))
        history["recovery_s"] = retry_stats["recovery_s"]
        if straggler.flagged:
            print(f"straggler steps flagged: {straggler.flagged}")
        executor.wait_host()
        history["checkpoint"] = {"saves": ckpt.save_count, "bytes": ckpt.last_bytes,
                                 "snapshot_s": ckpt.last_snapshot_s,
                                 "persist_s": ckpt.last_persist_s,
                                 "restore_s": ckpt.last_restore_s}
        history["nvme_stats"] = executor.bandwidth_stats()
        history["trace_attributions"] = executor.trace_attributions
        history["quantized_leaves"] = getattr(executor.engine, "quantized_leaves", ())
    finally:
        executor.close()
    return history


def _resume(ckpt, executor, state: dict, mesh) -> tuple:
    """(the restored state, its next step). Rank 0 restores the newest
    intact checkpoint (past a corrupt newest one, ``CheckpointManager
    .restore``); a ``KeyError``, a structure mismatch, is a tier migration:
    the tier-independent leaves are restored and the rest rebuilt
    (``adopt_state``). Every other rank restores the step rank 0 read, the
    same way, and cuts its part of the global leaves; a rank that cannot
    read it raises (it never starts fresh), and where rank 0 could not
    restore at all every rank raises."""
    decision, error = None, None
    if mesh.rank == 0:
        try:
            try:
                restored, extra = ckpt.restore(state)
                how = "full"
            except KeyError:
                restored, extra = ckpt.restore(executor.portable_like(state))
                how = "portable"
            decision = (how, ckpt.last_restore_step)
        except Exception as e:  # every rank raises below
            error = e
    how, step = mesh.gather_objects(decision if error is None else (None, repr(error)))[0]
    if how is None:
        if error is not None:
            raise error
        raise RuntimeError(f"rank 0 could not restore a checkpoint: {step}")
    if mesh.rank != 0:
        restored, extra = ckpt.restore(state if how == "full" else executor.portable_like(state),
                                       step=step)
    start_step = extra["next_step"]
    if how == "full":
        return executor.restore_state(restored, step=start_step), start_step
    return executor.adopt_state(restored, step=start_step), start_step


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    if args.trace:
        trace.enable()
    t0 = time.time()
    hist = train(args, argv)
    if hist["mesh"].rank != 0:  # rank 0 reports the run
        return hist
    losses = hist["losses"]
    print(f"done in {time.time()-t0:.1f}s | first loss {losses[0]:.4f} | "
          f"last loss {losses[-1]:.4f} | restarts {hist['restarts']}")
    last = hist["metrics"][-1]
    if "moe_dropped_token_fraction" in last:
        line = f"moe: dropped {last['moe_dropped_token_fraction']:.4f} of routed assignments"
        if "expert_total_bytes" in last:
            line += (f" | expert rows resident at peak {last['expert_peak_resident_bytes']}"
                     f" of {last['expert_total_bytes']} bytes | hit rate "
                     f"{last['expert_prefetch_hit_rate']:.3f} | evictions "
                     f"{last['expert_evictions']}")
        print(line)
    s = hist["nvme_stats"]
    if s:
        print(f"nvme: read {s['read_gbps']:.2f} GB/s, write {s['write_gbps']:.2f} GB/s, "
              f"pinned peak {s['pinned_peak_bytes']>>20} MiB")
    if args.trace:
        trace.export_chrome(args.trace)
        print(f"trace: wrote {args.trace} ({len(trace.TRACER.events())} spans)")
    return hist


if __name__ == "__main__":
    main()
