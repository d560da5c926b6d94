"""Times the tiled matmul's tensor-core kernel at every tile width and K
split it offers, at the serving and training paths' bf16 shapes of full
smollm-135m, on the card: the data behind ``kernels/tiled_matmul.py:plan``.

Each choice is launched straight through the C entry (no wrapper), checked
against the plain version, and timed with CUDA events over calls enqueued
behind a spin kernel, so the reading is device time alone; ``torch.matmul``
is timed beside it as the yardstick, and the choice ``plan`` makes is
marked. Prints one JSON line per shape.

  PYTHONPATH=src python -m repro_torch.launch.tune_tiled [--iters 50]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import tiled_matmul as tmm
from repro_torch.runtime.metrics import device_ms

# (M, K, N, operands given as transposed views): training (4096 tokens)
# forward, dX and dW of the three MLP projections; a prefill wave of 4 x 512
# tokens; decode at 4 slots
SHAPES = [(4096, 576, 1536, ""), (4096, 1536, 576, ""), (4096, 1536, 576, "w"),
          (4096, 576, 1536, "w"), (576, 4096, 1536, "x"), (1536, 4096, 576, "x"),
          (2048, 576, 1536, ""), (2048, 1536, 576, ""), (4, 576, 1536, "")]
TILES = (128, 64)
SPLITS = (1, 2, 3, 4)


def tune(case, iters: int, gen: torch.Generator) -> dict:
    M, K, N, trans = case
    x = torch.randn((K, M) if "x" in trans else (M, K), device="cuda", generator=gen) * 0.1
    w = torch.randn((N, K) if "w" in trans else (K, N), device="cuda", generator=gen) * 0.1
    x = (x.T if "x" in trans else x).to(torch.bfloat16)
    w = (w.T if "w" in trans else w).to(torch.bfloat16)
    (xm, xld), (wm, wld) = tmm.tma_layout(x), tmm.tma_layout(w)
    want = ref.matmul_ref(x, w).float()
    y = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
    ws = torch.empty(max(SPLITS) * M * N, dtype=torch.float32, device="cuda")
    lib = tmm._lib()
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = tmm.plan(M, N, K, sms)
    rec = {"shape": [M, K, N], "transposed": trans,
           "plan": [chosen["tile"][1], chosen["split"]], "choices": {}}
    for bn in TILES:
        for split in SPLITS:
            if split > -(-K // tmm.BK) // 2:
                continue

            def call():
                return lib.tiled_matmul_wgmma(
                    x.data_ptr(), w.data_ptr(), y.data_ptr(), ws.data_ptr(), M, N, K,
                    int(xm == "row"), xld, int(wm == "col"), wld, bn, split, stream)

            if call() != 0:
                raise SystemExit(f"tune_tiled: launch failed at {case} tile {bn} split {split}")
            torch.cuda.synchronize()
            err = (y.float() - want).abs().max().item()
            rec["choices"][f"{bn}x{split}"] = {"ms": device_ms(call, iters), "max_abs_err": err}
    rec["torch_matmul_ms"] = device_ms(lambda: torch.matmul(x, w), iters)
    best = min(rec["choices"], key=lambda c: rec["choices"][c]["ms"])
    rec["best"] = best
    rec["plan_ms"] = rec["choices"][f"{chosen['tile'][1]}x{chosen['split']}"]["ms"]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_tiled: needs the card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for case in SHAPES:
        print(json.dumps(tune(case, args.iters, gen)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
