"""Where the training time goes: layered ZeRO-3 steps of the port on the
card, parameters, gradients and optimizer states on NVMe, under
``torch.profiler`` and the span tracer.

Runs ``--warmup`` unprofiled steps (kernel builds, first launches, pinned
buffers), ``--steps`` unprofiled steps for the wall time, then one profiled
step, and prints: the host wall time per step and its compute / io_wait /
other split from the tracer; the device time summed over device-side
events, the device busy share (the union of those events' intervals over
the step's wall time), and the device time of each kernel per step with its
launches (``profile_serve._report``). Weights are random from ``--seed``.

  PYTHONPATH=src python -m repro_torch.launch.profile_train \\
      --arch smollm-135m --batch 8 --seq 512 --nvme-dir build/profile_nvme \\
      [--param-quant q8]
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.config import (RunConfig, ShapeConfig, TrainConfig,
                                make_offload, make_parallel)
from repro_torch.core.executor import InfinityExecutor
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.launch.profile_serve import _report
from repro_torch.runtime import trace


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--nvme-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_profile"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--param-quant", default="none", choices=["none", "q8", "q4"],
                    help="wire format of the param rows (launch/train.py's flag)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = _parse(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: CUDA is not available; this profile runs on the card")
    dev = torch.device("cuda")
    shutil.rmtree(args.nvme_dir, ignore_errors=True)
    cfg = configs.get(args.arch)
    run = RunConfig(model=cfg, parallel=make_parallel("zero3"),
                    offload=make_offload(opt_tier="nvme", param_tier="nvme",
                                         grad_tier="nvme", nvme_dir=args.nvme_dir,
                                         param_quant=args.param_quant),
                    train=TrainConfig(lr=3e-3, seed=args.seed))
    ex = InfinityExecutor(run, dev)
    try:
        state = ex.init_state(torch.Generator(device=dev).manual_seed(args.seed))
        stream = SyntheticStream(ex.input_specs(ShapeConfig("p", args.seq, args.batch,
                                                            "train")),
                                 cfg.vocab_size, seed=args.seed)
        step_fn = ex.make_train_step()
        it = iter(range(args.warmup + args.steps + 1))

        def step():
            nonlocal state
            batch = {k: torch.from_numpy(a).to(dev)
                     for k, a in stream.batch_at(next(it)).items()}
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
            w = m["trace_wall_s"]
            print(f"train step: unprofiled wall {wall * 1e3:.1f} ms | compute "
                  f"{m['trace_compute_s'] / w:.3f} io_wait {m['trace_io_wait_s'] / w:.3f} "
                  f"other {m['trace_other_s'] / w:.3f} of the traced wall | "
                  f"param in {m['param_in_gbps']:.2f} GB/s, opt read "
                  f"{m['opt_read_gbps']:.2f} GB/s, opt write {m['opt_write_gbps']:.2f} GB/s")
        trace.disable()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall, _ = step()
        _report("train step", prof, wall, 1, args.top)
    finally:
        ex.close()


if __name__ == "__main__":
    main()
