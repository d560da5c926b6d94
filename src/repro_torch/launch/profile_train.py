"""Where the training time goes: steps of the port on the card under
``torch.profiler`` and the span tracer.

It takes ``launch/train.py``'s flags and checks (the placement — the
explicit engine's monolithic step too, with ``--offload-param device`` or
``host``, and the GSPMD engine's leaf scheduler with ``--engine pjit
--offload-param nvme`` — ``--remat``, ``--plan auto`` with ``--hw-*`` and
``--objective``, ``--param-quant``, shapes), with defaults of its own: the
layered ZeRO-3 step with parameters, gradients and optimizer states on
NVMe, 8 x 512 tokens. Runs ``--warmup`` unprofiled
steps (kernel builds, first launches, pinned buffers), ``--steps``
unprofiled steps for the wall time, then one profiled step, and prints:
the host wall time per step and, where the step reports it, its compute /
io_wait / other split from the tracer and the tier bandwidths; the device
time summed over device-side events, the device busy share (the union of
those events' intervals over the step's wall time), and the device time of
each kernel per step with its launches (``profile_serve._report``; fused
Adam is the ``fused_adam`` kernel's row). A MoE model's steps add the
routing's dropped fraction and, layered, the expert rows' hit rate and
residency. Weights are random from ``--seed``. On a mesh (torchrun,
``--data-mesh N``, or ``--plan auto --hw-devices N``: ``launch/train.py``'s
ranks and refusals) each rank profiles its own device on its rows of each
global batch, and rank 0 prints its lines.

  PYTHONPATH=src python -m repro_torch.launch.profile_train \\
      --arch smollm-135m --nvme-dir build/profile_nvme [--param-quant q8]
  PYTHONPATH=src python -m repro_torch.launch.profile_train \\
      --arch smollm-135m --plan auto [--hw-device-mem 3e9]
  PYTHONPATH=src python -m repro_torch.launch.profile_train \\
      --arch granite-moe-1b-a400m --plan auto
  PYTHONPATH=src python -m repro_torch.launch.profile_train \\
      --arch seamless-m4t-medium --plan auto --objective min_device_mem \\
      --batch 8 --seq 2048 --steps 1
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.profile_train --arch smollm-135m --engine pjit \\
      --offload-param device --offload-grad device --offload-opt device --data-mesh 2
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.config import ShapeConfig
from repro_torch.core.executor import InfinityExecutor
from repro_torch.data.pipeline import SyntheticStream, rank_batch
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train
from repro_torch.launch.profile_serve import _report
from repro_torch.runtime import trace


def _parse(argv=None):
    ap = train.build_argparser()
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--top", type=int, default=12)
    # no checkpoints: a profile saves none (and a mesh refuses them)
    ap.set_defaults(engine="zero3", offload_param="nvme", offload_grad="nvme",
                    offload_opt="nvme", batch=8, seq=512, steps=2, lr=3e-3, ckpt_every=0,
                    nvme_dir=os.path.join(tempfile.gettempdir(), "repro_torch_profile"))
    return ap.parse_args(argv)


def main(argv=None) -> None:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = _parse(argv)
    created = mesh_mod.maybe_init_distributed("cuda")
    try:
        # the world size is checked first: a mismatch raises, naming the launch
        mesh = mesh_mod.make_local_mesh(train.data_mesh(args), args.model_mesh, "cuda")
        _profile(args, argv, mesh)
    finally:
        if created:
            torch.distributed.destroy_process_group()


def _profile(args, argv, mesh) -> None:
    dev = mesh.device
    say = print if mesh.rank == 0 else (lambda *a: None)
    # each rank clears only the stores it writes (<nvme_dir>/rank<r> on a mesh)
    shutil.rmtree(args.nvme_dir if mesh.world == 1
                  else os.path.join(args.nvme_dir, f"rank{mesh.rank}"), ignore_errors=True)
    train._unported(args, mesh.world)
    run, plan = train.make_run(args, argv)
    ex = InfinityExecutor(run, dev, plan=plan, mesh=mesh if mesh.world > 1 else None)
    accum = 1 if ex.explicit else run.parallel.grad_accum
    try:
        state = ex.init_state(torch.Generator(device=dev).manual_seed(args.seed))
        stream = SyntheticStream(ex.input_specs(ShapeConfig("p", args.seq, args.batch,
                                                            "train")),
                                 run.model.vocab_size, seed=args.seed)
        step_fn = ex.make_train_step()
        it = iter(range(args.warmup + args.steps + 1))

        def step():
            nonlocal state
            batch = rank_batch(stream.batch_at(next(it)), mesh.rank, mesh.world, accum)
            batch = {k: torch.from_numpy(a).to(dev) for k, a in batch.items()}
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            return time.perf_counter() - t0, m

        for _ in range(args.warmup):
            step()
        trace.enable()
        for _ in range(args.steps):
            wall, m = step()
            line = f"train step: unprofiled wall {wall * 1e3:.1f} ms"
            if "trace_wall_s" in m:
                w = m["trace_wall_s"]
                line += (f" | compute {m['trace_compute_s'] / w:.3f} io_wait "
                         f"{m['trace_io_wait_s'] / w:.3f} other "
                         f"{m['trace_other_s'] / w:.3f} of the traced wall")
            for key in ("param_in_gbps", "opt_read_gbps", "opt_write_gbps", "grad_out_gbps",
                        "moe_dropped_token_fraction", "expert_prefetch_hit_rate"):
                if key in m:
                    line += f" | {key} {float(m[key]):.3f}"
            for key in ("expert_peak_resident_bytes", "expert_total_bytes", "expert_evictions",
                        "param_shard_bytes", "grad_shard_bytes", "opt_shard_bytes"):
                if key in m:
                    line += f" | {key} {m[key]}"
            say(line)
        trace.disable()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall, _ = step()
        if mesh.rank == 0:
            _report("train step" + (f" (rank 0 of {mesh.world})" if mesh.world > 1 else ""),
                    prof, wall, 1, args.top)
    finally:
        ex.close()


if __name__ == "__main__":
    main()
