"""Where a flash-attention call's device time goes, kernel by kernel, on the
card: the forward and the backward (delta, dK/dV, dQ) on the route
``kernels/flash_attention.py:route`` picks, at the shapes of the paths that
run them, under ``torch.profiler``. Prints one JSON line per shape with the
device ms per call of each kernel, the whole forward and backward timed
with CUDA events behind a spin kernel, and the wgmma plan (grids, slabs,
the longest block's steps).

Inputs are unit-variance bf16 from ``--seed``, as ``chip_smoke.py`` draws
them: (B,S,H,D) storage handed over as (B,H,S,D) views, causal.

  PYTHONPATH=src python -m repro_torch.launch.profile_flash [--iters 5]
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import flash_attention as tfa
from repro_torch.runtime.metrics import device_ms

# ((B, H, KV, Sq, Sk, D), window): recurrentgemma-9b's local attention in the
# hybrid training cell, gemma-7b's and nemotron-4-340b's heads, smollm-135m's
# training shape
SHAPES = [((1, 16, 1, 4096, 4096, 256), 2048), ((1, 16, 16, 512, 512, 256), 0),
          ((1, 96, 8, 256, 256, 192), 0), ((8, 9, 3, 512, 512, 64), 0)]


def kernel_ms(fn, iters: int) -> dict:
    """Device ms per call of ``fn``, summed by kernel name (up to its
    template arguments)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            span_ms = (ev.time_range.end - ev.time_range.start) / 1e3
            out[ev.name.split("(")[0].removeprefix("void ")] += span_ms / iters
    return {k: round(v, 5) for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


def run(shape, window: int, iters: int, gen: torch.Generator) -> dict:
    B, H, KV, Sq, Sk, D = shape

    def draw(S, heads):
        return torch.randn(B, S, heads, D, device="cuda", generator=gen).to(
            torch.bfloat16).transpose(1, 2)

    q, k, v, do = draw(Sq, H), draw(Sk, KV), draw(Sk, KV), draw(Sq, H)
    o, lse = tfa.flash_attention_cuda(q, k, v, window=window, with_lse=True)

    def fwd():
        return tfa.flash_attention_cuda(q, k, v, window=window)

    def bwd():
        return tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, window=window)

    p = tfa.plan(B, H, KV, Sq, Sk, sms=torch.cuda.get_device_properties(0).multi_processor_count,
                 window=window, D=D)
    return {"shape": list(shape), "window": window, "route": tfa.route(q, k, v, do),
            "fwd_ms": device_ms(fwd), "bwd_ms": device_ms(bwd),
            "fwd_kernels": kernel_ms(fwd, iters), "bwd_kernels": kernel_ms(bwd, iters),
            "plan": {kern: {key: p[kern][key] for key in ("tile", "slab", "blocks")
                            if key in p[kern]} | {"max_steps": max(p[kern]["steps"])}
                     for kern in p}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_flash: needs an NVIDIA card")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    print(torch.cuda.get_device_name(0), flush=True)
    for shape, window in SHAPES:
        print(json.dumps(run(shape, window, args.iters, gen)), flush=True)


if __name__ == "__main__":
    main()
