"""Where the serving time goes: one prefill wave and a few decode steps of
the port's bundle (any family) under ``torch.profiler``, on the card.

Prints, for prefill and for decode separately, the host wall time per
call, the device time summed over device-side events (kernels, copies),
the device busy share (the union of those events' intervals over wall
time), the top device events and the top operators by host time. Weights
are random from ``--seed``.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch smollm-135m --slots 4 --prompt-len 512 --decode-steps 8
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch granite-moe-1b-a400m
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch recurrentgemma-9b --prompt-len 2560 [--layers 5]
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch llava-next-34b --prompt-len 3072 --layers 8
  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      --arch seamless-m4t-medium --prompt-len 2048
"""
from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.config import ShapeConfig
from repro_torch.core import kvcache
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.runtime import trace


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers at full width "
                         "(0: the config's depth)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    return ap.parse_args(argv)


def _report(tag: str, prof, wall_s: float, calls: int, top: int) -> None:
    # Device time comes from the device-side events alone (kernels, copies,
    # sets): an aten row's device time repeats that of the kernels it
    # launched, so summing every row would count those twice.
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    dev_us = sum(e - s for s, e in spans)
    busy_us = trace._total(trace._merge(spans))
    print(f"{tag}: wall {wall_s / calls * 1e3:.3f} ms/call | device "
          f"{dev_us / calls / 1e3:.3f} ms/call over {len(kernels) / calls:.1f} "
          f"device events/call | device busy {busy_us / 1e6 / max(wall_s, 1e-12):.3f} "
          "of wall")
    by_name = defaultdict(lambda: [0.0, 0])
    for e, (s, t) in zip(kernels, spans):
        by_name[e.name][0] += t - s
        by_name[e.name][1] += 1
    print(f"{tag} top device events (ms per call, share of device time, "
          "launches per call):")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {us / calls / 1e3:9.4f}  {us / max(dev_us, 1e-12):6.3f}  "
              f"{n / calls:7.1f}  {name[:90]}")
    evs = prof.key_averages()
    print(f"{tag} top by host time (ms per call):")
    for e in sorted(evs, key=lambda e: e.self_cpu_time_total, reverse=True)[:top]:
        print(f"  {e.self_cpu_time_total / calls / 1e3:9.4f}  {e.count / calls:7.1f}  {e.key[:90]}")


def main(argv=None) -> None:
    args = _parse(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: CUDA is not available; this profile runs on the card")
    dev = torch.device("cuda")
    cfg = configs.with_layers(configs.get(args.arch), args.layers)
    bundle = registry.build(cfg)
    params = bundle.init(torch.Generator(device=dev).manual_seed(args.seed), dev)
    # the family's prefill inputs (token ids, a VLM's vision embeddings or an
    # enc-dec model's frames), drawn as the serve driver draws them
    specs = bundle.input_specs(ShapeConfig("profile", args.prompt_len, args.slots, "prefill"))
    batch = {name: t.to(dev) for name, t in
             serve.draw_inputs(specs, args.slots, cfg.vocab_size, args.seed).items()}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    bundle.prefill(params, batch)  # warm-up: build, load, first launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle.prefill(params, batch)
    torch.cuda.synchronize()
    print(f"prefill: unprofiled wall {(time.perf_counter() - t0) * 1e3:.3f} ms/call")
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, cache = bundle.prefill(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report("prefill", prof, wall, 1, args.top)

    # room for a warm-up step, the unprofiled steps and the profiled steps;
    # each slot continues at the prefill's length (a VLM's counts its vision
    # positions, an enc-dec model's is its decoder's)
    prefill_len = int(cache["len"])
    cache = kvcache.grow_cache(cache, 2 * args.decode_steps + 1, cfg.family)
    cache["len"] = torch.full((args.slots,), prefill_len, dtype=torch.int32, device=dev)

    def decode(n, cache, cur):
        """n greedy steps; returns the wall seconds, the cache and the tokens."""
        t0 = time.perf_counter()
        for _ in range(n):
            lg, cache = bundle.decode_step(params, cache, {"tokens": cur})
            cur = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, cache, cur

    _, cache, cur = decode(1, cache, batch["tokens"][:, -1:])  # warm-up
    wall, cache, cur = decode(args.decode_steps, cache, cur)
    print(f"decode: unprofiled wall {wall / args.decode_steps * 1e3:.3f} ms/call")
    with profile(activities=acts) as prof:
        wall, cache, cur = decode(args.decode_steps, cache, cur)
    _report("decode", prof, wall, args.decode_steps, args.top)


if __name__ == "__main__":
    main()
