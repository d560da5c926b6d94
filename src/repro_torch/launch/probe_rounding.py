"""How far rounding alone moves the GSPMD step's loss and grad norm: the
facts behind reading a card-against-CPU difference in ``chip_smoke.py``'s
numerics phases. The same function (``--arch`` at full width cut to
``--layers``, ``--batch`` x ``--seq`` tokens, two steps all on the device,
weights drawn from each ``--seeds`` on the CPU as ``chip_smoke.py`` draws
them) runs on the CPU at each of ``--threads``: a thread count changes
only the order of the CPU kernels' sums, so what differs between two
counts is rounding. One JSON line per (seed, threads) with the trajectory,
and one per seed with each step's largest difference against the
``TRAIN_TOL``-style bound (atol 2e-3 + rtol 2e-3 of the value). A probe,
not a path; CPU only.

  PYTHONPATH=src python -m repro_torch.launch.probe_rounding \\
      --arch mamba2-370m --layers 2 --seeds 0 1 --threads 8 1
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch import configs
from repro_torch.config import RunConfig, ShapeConfig, TrainConfig, make_parallel
from repro_torch.core.executor import InfinityExecutor
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.models import registry


def trajectory(arch: str, layers: int, seed: int, batch: int, seq: int, steps: int = 2) -> list:
    """``(loss, grad_norm)`` of each step from the weights of ``seed``."""
    cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
    params = registry.build(cfg).init(torch.Generator().manual_seed(seed), torch.device("cpu"))
    run = RunConfig(model=cfg, parallel=make_parallel("pjit", remat="none"),
                    train=TrainConfig(lr=3e-3, steps=steps, seed=0))
    ex = InfinityExecutor(run, "cpu")
    state = ex.reseed(ex.engine.adopt_params(params))
    stream = SyntheticStream(ex.input_specs(ShapeConfig("p", seq, batch, "train")),
                             cfg.vocab_size, seed=0)
    step, out = ex.make_train_step(), []
    for i in range(steps):
        state, m = step(state, {k: torch.from_numpy(a) for k, a in stream.batch_at(i).items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    ex.close()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--threads", type=int, nargs="+", default=[8, 1])
    args = ap.parse_args(argv)
    for seed in args.seeds:
        runs = []
        for threads in args.threads:
            torch.set_num_threads(threads)
            runs.append(trajectory(args.arch, args.layers, seed, args.batch, args.seq))
            print(json.dumps({"seed": seed, "threads": threads, "loss_grad_norm": runs[-1]}))
        worst = []
        for i, first in enumerate(runs[0]):
            diffs = [max(abs(r[i][k] - first[k]) / (2e-3 + 2e-3 * abs(first[k]))
                         for r in runs[1:]) for k in (0, 1)]
            worst.append({"step": i, "loss_diff_over_bound": diffs[0],
                          "grad_norm_diff_over_bound": diffs[1]})
        print(json.dumps({"seed": seed, "arch": args.arch, "threads": args.threads,
                          "worst": worst}))


if __name__ == "__main__":
    main()
