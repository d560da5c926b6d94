"""Which collectives the gloo backend takes on CUDA tensors, on this card
and this torch: the facts behind ``launch/mesh.py``'s ``COLLECTIVES``
table. Two ranks on one card (the case that selects gloo) run each
collective the explicit engine issues (``all_reduce``, ``all_gather``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``) on CUDA tensors in
every dtype the engines hand them (f32, bf16, fp16, int8, int64: a q8
wire row's scales are fp16), and each rank prints
one JSON line per (collective, dtype): ``accepted`` (the call returned),
``correct`` (its result equals the sum or concatenation computed on the
host) and the error's first line where it raised. A probe, not a path: the
port never catches a collective's error to pick a transport.

  python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.probe_transport
"""
from __future__ import annotations

import argparse
import datetime
import json
import os

import torch
import torch.distributed as dist

DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8, torch.int64)


def _value(rank: int, n: int, dtype) -> torch.Tensor:
    return (torch.arange(n) % 5 + rank + 1).to(dtype)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda, or cpu to check the probe")
    args = ap.parse_args()
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=60))
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cpu")
    if args.device == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    n = 8 * world
    if rank == 0:
        print("probe:", json.dumps({"torch": torch.__version__, "all_gather_single":
                                    hasattr(dist, "all_gather_single")}), flush=True)
    for dtype in DTYPES:
        mine = [_value(r, n, dtype) for r in range(world)]
        total = sum(t.double() for t in mine)
        cases = {
            "all_reduce": (lambda: _all_reduce(mine[rank].to(dev, copy=True)), total),
            "all_gather": (lambda: _all_gather(mine[rank].to(dev, copy=True), world), torch.cat(mine).double()),
            "all_gather_into_tensor": (lambda: _gather_into(mine[rank].to(dev, copy=True), world),
                                       torch.cat(mine).double()),
            "reduce_scatter_tensor": (lambda: _reduce_scatter(mine[rank].to(dev, copy=True), world),
                                      total.chunk(world)[rank]),
        }
        for op, (fn, want) in cases.items():
            rec = {"rank": rank, "op": op, "dtype": str(dtype).removeprefix("torch."),
                   "torch": torch.__version__}
            try:
                got = fn()
                rec.update(accepted=True, device=str(got.device),
                           correct=bool(torch.equal(got.double().cpu(), want)))
            except Exception as e:  # the probe records what gloo refuses
                rec.update(accepted=False, error=str(e).splitlines()[0][:200])
            print("probe:", json.dumps(rec), flush=True)
            dist.barrier()
    dist.destroy_process_group()


def _all_reduce(t):
    dist.all_reduce(t)
    return t


def _all_gather(t, world):
    out = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(out, t)
    return torch.cat(out)


def _gather_into(t, world):
    out = t.new_empty(world * t.numel())
    dist.all_gather_into_tensor(out, t)
    return out


def _reduce_scatter(t, world):
    out = t.new_empty(t.numel() // world)
    dist.reduce_scatter_tensor(out, t)
    return out


if __name__ == "__main__":
    main()
