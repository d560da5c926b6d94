"""Training entry point: synthetic data -> InfinityExecutor -> per-step
metrics, the port of ``repro/launch/train.py`` for one device:

  * ``--plan auto``: the planner (``repro_torch/plan.py``) derives the
    placement from the detected card (``--hw-*`` override what detection
    reads, ``--objective`` picks the objective), and every legacy flag
    given on the command line becomes a per-field override of the derived
    plan, as in the reference; the plan's ``explain()`` is printed and its
    cross-check fields (``plan_*``) land in the step metrics. ``--plan
    <file.json>`` loads a saved plan.
  * ``--plan manual`` (default): the flags as given. ``--engine pjit``
    (default) runs the GSPMD engine's step with params on the device or
    host tier: in-graph fused Adam with the optimizer on the device or host
    tier, or off-graph (``ChunkedAdamOffload``) with the optimizer on NVMe
    or the gradients drained to host or NVMe (the ZeRO-Offload placement);
    ``--grad-accum`` and the plan's ``remat`` are honoured. ``--engine
    zero3 --offload-param nvme`` runs the layered epoch with every state
    class on the slow tiers; ``--param-quant q8`` ships its rows as q8 wire
    bytes into the quantized-matmul kernel, ``q4`` rows decode on the host.

Runs on the card by default and raises when CUDA is absent; ``--device
cpu`` runs the kernels' plain versions (the tests do). Every flag whose
machinery is not ported raises, naming the ROADMAP item that ports it:
``--engine pjit`` with NVMe params, ``--engine zero3`` with params off
NVMe, more than one device (meshes, ``--hw-devices`` > 1), ``--remat
dots``, ``--grad-accum`` > 1 on the layered epoch, ``--elastic``/
``--chaos``, the fault runtime's flags, ``--grad-compress``, ``--resume
auto`` and checkpoints (``--ckpt-every`` > 0, ``--ckpt-dir``).

Examples (one H100, full smollm-135m):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --plan auto --batch 8 --seq 512 --steps 4 --lr 3e-3
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --engine zero3 --offload-param nvme --offload-grad nvme \\
      --offload-opt nvme --batch 8 --seq 512 --steps 8 --lr 3e-3
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
from repro_torch.config import (RunConfig, ShapeConfig, TrainConfig,
                                make_offload, make_parallel)
from repro_torch.core.executor import InfinityExecutor
from repro_torch.data.pipeline import PrefetchLoader, SyntheticStream
from repro_torch.launch.serve import resolve_device
from repro_torch.runtime import trace
from repro_torch.runtime.metrics import MetricsLogger

# flags whose machinery is not ported: any value given raises
UNPORTED = {
    "chaos": "ROADMAP.md Queue 1 item 5: elastic runtime",
    "straggler_factor": "ROADMAP.md Queue 1 item 5: runtime/fault.py",
    "max_restarts": "ROADMAP.md Queue 1 item 5: runtime/fault.py",
    "recovery_budget": "ROADMAP.md Queue 1 item 5: runtime/fault.py",
    "ckpt_dir": "ROADMAP.md Queue 1 item 5: checkpoint/manager.py",
}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu "
                         "(the plain versions)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--engine", default="pjit", choices=["pjit", "zero3"],
                    help="pjit = the GSPMD engine's step (params on the device "
                         "or host tier); zero3 = the explicit engine's layered "
                         "epoch (params on NVMe)")
    ap.add_argument("--zero-stage", type=int, default=3)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches per step (the GSPMD engine)")
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"],
                    help="activation checkpoint policy of the GSPMD engine's "
                         "loss (dots is not ported: raises)")
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
                    help="int8 gradient reduce (not ported: raises)")
    ap.add_argument("--read-ahead", type=int, default=2,
                    help="slow-tier param reads in flight beyond the window")
    ap.add_argument("--nvme-workers", type=int, default=2,
                    help="worker threads per slow-tier store")
    ap.add_argument("--pinned-buffer-mb", type=int, default=64,
                    help="shared pinned buffer-pool budget (all stores)")
    plan_mod.add_plan_args(ap)
    ap.add_argument("--elastic", action="store_true", help="not ported: raises")
    ap.add_argument("--chaos", default=None)
    ap.add_argument("--straggler-factor", type=float, default=None)
    ap.add_argument("--max-restarts", type=int, default=None)
    ap.add_argument("--recovery-budget", type=float, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoints are not ported: > 0 raises")
    ap.add_argument("--resume", default="no", choices=["no", "auto"])
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", nargs="?", const="trace.json", default=None,
                    metavar="OUT.json",
                    help="record spans and write a Chrome/Perfetto trace; "
                         "per-step stall attribution lands in the step "
                         "metrics as trace_* fields")
    return ap


def _unported(args) -> None:
    """Raise for every flag set to something the port cannot run."""
    for name, item in UNPORTED.items():
        if getattr(args, name) is not None:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not ported yet ({item})")
    checks = [
        (args.elastic, "--elastic", "ROADMAP.md Queue 1 item 5: elastic runtime"),
        (args.resume != "no", f"--resume {args.resume}",
         "ROADMAP.md Queue 1 item 5: checkpoint/manager.py"),
        (args.ckpt_every > 0, f"--ckpt-every {args.ckpt_every}",
         "ROADMAP.md Queue 1 item 5: checkpoint/manager.py"),
        (args.data_mesh * args.model_mesh != 1, "a mesh larger than one device",
         "ROADMAP.md Queue 1 item 8: GSPMD engine and meshes"),
        (args.grad_compress != "none", f"--grad-compress {args.grad_compress}",
         "ROADMAP.md Queue 1 items 8 and 10: the reference compresses "
         "gradients only in the cross-rank reduce and the monolithic step"),
    ]
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet ({item})")


def _unported_run(run: RunConfig) -> None:
    """Raise for what the resolved run (the flags, or the plan with its
    overrides) asks of the layered epoch and it cannot do."""
    pc = run.parallel
    if pc.engine != "zero3":
        return
    if pc.zero_stage != 3:
        raise NotImplementedError(
            f"--zero-stage {pc.zero_stage} is not ported yet (ROADMAP.md Queue "
            "1 item 10: the explicit engine is ZeRO-3)")
    if pc.grad_accum != 1:
        raise NotImplementedError(
            f"--grad-accum {pc.grad_accum} on the layered epoch is not ported "
            "yet (ROADMAP.md Queue 1 item 10: one microbatch per layered step)")


def make_run(args, argv=None):
    """(RunConfig, Optional[InfinityPlan]). With ``--plan auto`` (or a saved
    plan) the planner derives every offload/engine knob and the legacy
    flags given in ``argv`` (default ``sys.argv[1:]``) act only as explicit
    per-field overrides; ``--plan manual`` keeps the flags as given."""
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    tc = TrainConfig(lr=args.lr, steps=args.steps,
                     checkpoint_every=args.ckpt_every, seed=args.seed)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    plan = plan_mod.resolve_plan(args, cfg, shape, nvme_dir=args.nvme_dir, argv=argv)
    if plan is not None:
        run = plan.to_run_config(train=tc, nvme_dir=args.nvme_dir,
                                 overlap=not args.no_overlap)
        # non-plan parallelism knobs stay CLI-driven under --plan auto
        run = run.replace(parallel=dataclasses.replace(
            run.parallel, zero_stage=args.zero_stage))
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
    return float(v) if isinstance(v, torch.Tensor) else v


def train(args, argv=None) -> dict:
    """Run ``args.steps`` steps. Returns ``{"losses", "grad_norms",
    "metrics" (one dict of host numbers per step, with step_time and
    tokens_per_s), "nvme_stats", "trace_attributions", "quantized_leaves"
    (the MLP weights whose products read the q8 rows in place), "plan"
    (the ``InfinityPlan``, or None in manual mode), "run" (the resolved
    ``RunConfig``)}``. ``argv`` is what ``make_run`` reads overrides from."""
    _unported(args)
    device = resolve_device(args.device)
    run, plan = make_run(args, argv)
    _unported_run(run)
    executor = InfinityExecutor(run, device, plan=plan)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    tokens = shape.global_batch * shape.seq_len
    history = {"losses": [], "grad_norms": [], "metrics": [], "plan": plan, "run": run}
    try:
        gen = torch.Generator(device=device).manual_seed(run.train.seed)
        state = executor.init_state(gen)
        step_fn = executor.make_train_step()
        stream = SyntheticStream(executor.input_specs(shape), run.model.vocab_size,
                                 seed=run.train.seed)
        loader = PrefetchLoader(stream, 0, run.train.steps, device)
        logger = MetricsLogger(executor.n_params_active())
        for step, batch in loader:
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            rec = {k: _host(v) for k, v in metrics.items()}  # waits for the step
            dt = time.perf_counter() - t0
            rec.update(step=step, step_time=dt, tokens_per_s=tokens / dt)
            history["losses"].append(rec["loss"])
            history["grad_norms"].append(rec["grad_norm"])
            history["metrics"].append(rec)
            if step % args.log_every == 0:
                logger.log(step, rec["loss"], tokens, dt)
        history["nvme_stats"] = executor.bandwidth_stats()
        history["trace_attributions"] = executor.trace_attributions
        history["quantized_leaves"] = getattr(executor.engine, "quantized_leaves", ())
    finally:
        executor.close()
    return history


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    if args.trace:
        trace.enable()
    t0 = time.time()
    hist = train(args, argv)
    losses = hist["losses"]
    print(f"done in {time.time()-t0:.1f}s | first loss {losses[0]:.4f} | "
          f"last loss {losses[-1]:.4f}")
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
