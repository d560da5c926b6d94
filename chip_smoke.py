"""Chip smoke for the PyTorch/Hopper port: builds the CUDA kernels, holds
each against its plain PyTorch version on the card, serves full-width
smollm-135m through ``repro_torch.launch.serve`` (host and NVMe KV tiers),
checks the outputs, and prints one JSON line per the contract below.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from ``src/repro_torch/csrc`` (one nvcc each, in
     parallel);
  3. each kernel against its plain version at the serve shapes and at one
     ragged shape, in bf16 and f32, element by element (``TOL``), with
     timings of the bf16 serve shapes (kernel, plain, library yardstick)
     and the least time the card could take (bound);
  4. end-to-end numerics: a 2-layer full-width smollm-135m on the card
     (kernels) against the same weights on the CPU (plain versions),
     teacher-forced prefill + decode logits;
  5. the main path: ``run_serve`` on full smollm-135m (30 layers) with 8
     sequences through 4 device slots, waiting KV on the host tier; launch
     counters are zeroed just before and read just after;
  6. the NVMe KV tier: 3 sequences through 1 slot (counters read again);
  7. the kernels JSON line, then the device JSON line last.

Needs no network and exactly one card; exits non-zero without CUDA.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import kvcache  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no sparsity
SEED = 0

# serve shapes of full smollm-135m at --kv-slots 4 --prompt-len 512
FLASH_SERVE = (4, 9, 3, 512, 512, 64)  # B, H, KV, Sq, Sk, D
TILED_SERVE = [(2048, 576, 1536), (2048, 1536, 576), (4, 576, 1536)]  # M, K, N
FLASH_RAGGED = (1, 6, 2, 100, 132, 64)  # Sq < Sk, not a multiple of the tiles
TILED_RAGGED = (300, 200, 100)
# Each element must satisfy |kernel - plain| <= rtol*|plain| + mtol*mag + atol,
# where mag is the plain version on absolute values (softmax weights on |v|,
# |x| @ |w|): the size that rounding errors inside the sums scale with.
# f32: sums differ only in order, so an absolute 1e-4 at outputs of O(1).
# bf16: the two outputs may round one ulp apart (<= 2^-7 |out|); attention
# also rounds p to bf16 against the running max in the kernel and against
# the row's total in the plain version, <= 2^-8 relative each, so 2^-7 of
# sum p|v|; the matmul's f32 sums in another order stay under K*2^-24 of
# |x| @ |w| (2^-13 at K <= 1536, taken as 2^-12).
TOL = {("flash_attention", torch.bfloat16): {"rtol": 2**-7, "mtol": 2**-7, "atol": 0.0},
       ("tiled_matmul", torch.bfloat16): {"rtol": 2**-7, "mtol": 2**-12, "atol": 0.0},
       ("flash_attention", torch.float32): {"rtol": 0.0, "mtol": 0.0, "atol": 1e-4},
       ("tiled_matmul", torch.float32): {"rtol": 0.0, "mtol": 0.0, "atol": 1e-4}}
E2E_REL_TOL = 5e-2  # 2 bf16 layers, CPU vs card rounding, relative to max |logit|


def say(*a) -> None:
    print(*a, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters`` calls
    after a warm-up (inputs stay in the 50 MB L2 at these shapes)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def randn(shape, dtype, gen, scale):
    return (torch.randn(shape, device="cuda", generator=gen) * scale).to(dtype)


def compare(name, shape, dtype, out, plain, mag) -> dict:
    """Hold a kernel's output against its plain version by ``TOL``; raise
    on any element outside it or any non-finite value."""
    tol = TOL[(name, dtype)]
    err = (out.float() - plain.float()).abs()
    allowed = tol["rtol"] * plain.float().abs() + tol["mtol"] * mag.float() + tol["atol"]
    worst = (err / allowed).max().item()
    rec = {"shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
           "max_abs_err": err.max().item(), "tol": tol, "worst_err_over_tol": worst}
    if not worst <= 1.0 or not torch.isfinite(out).all():
        raise SystemExit(f"FAIL {name} {shape} {dtype}: an element is "
                         f"{worst:.3g}x its tolerance {tol} (max abs err "
                         f"{rec['max_abs_err']})")
    return rec


def check_flash(shape, dtype, gen, timed: bool) -> dict:
    B, H, KV, Sq, Sk, D = shape
    # unit-variance q and k give scores of unit variance (peaked softmax) and
    # outputs of O(1); (B,S,H,D) storage passed as strided (B,H,S,D) views,
    # as the model's attention_block does
    q = randn((B, Sq, H, D), dtype, gen, 1.0).transpose(1, 2)
    k = randn((B, Sk, KV, D), dtype, gen, 1.0).transpose(1, 2)
    v = randn((B, Sk, KV, D), dtype, gen, 1.0).transpose(1, 2)
    out = ops.flash_attention(q, k, v, causal=True)
    plain = ref.attention_ref(q, k, v, causal=True)
    mag = ref.attention_ref(q, k, v.abs(), causal=True)
    torch.cuda.synchronize()
    rec = compare("flash_attention", shape, dtype, out, plain, mag)
    if timed:
        # causal: query i needs keys j <= i + (Sk - Sq), the work this run does
        pairs = sum(min(Sk, i + (Sk - Sq) + 1) for i in range(Sq)) * B * H
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4.0 * D * pairs, dtype)
        rec["ms"] = time_ms(lambda: ops.flash_attention(q, k, v, causal=True))
        rec["plain_ms"] = time_ms(lambda: ref.attention_ref(q, k, v, causal=True))
        rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    return rec


def check_tiled(shape, dtype, gen, timed: bool) -> dict:
    M, K, N = shape
    x = randn((M, K), dtype, gen, 0.1)
    w = randn((K, N), dtype, gen, 0.1)
    out = ops.tiled_matmul(x, w)
    plain = ref.matmul_ref(x, w)
    mag = ref.matmul_ref(x.abs(), w.abs())
    torch.cuda.synchronize()
    rec = compare("tiled_matmul", shape, dtype, out, plain, mag)
    if timed:
        nbytes = (M * K + K * N + M * N) * x.element_size()
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2.0 * M * N * K, dtype)
        rec["ms"] = time_ms(lambda: ops.tiled_matmul(x, w))
        rec["plain_ms"] = time_ms(lambda: ref.matmul_ref(x, w))
        rec["library_ms"] = time_ms(lambda: torch.matmul(x, w))
    return rec


def phase_kernels() -> dict:
    """Every kernel at every serve shape and one ragged shape, in bf16 (the
    path's type; timed at the serve shapes) and in f32 (tight tolerance)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    flash = [check_flash(FLASH_SERVE, bf16, gen, timed=True)]
    flash += [check_flash(FLASH_SERVE, f32, gen, timed=False)]
    flash += [check_flash(FLASH_RAGGED, dt, gen, timed=False) for dt in (bf16, f32)]
    tiled = [check_tiled(s, bf16, gen, timed=True) for s in TILED_SERVE]
    tiled += [check_tiled(s, f32, gen, timed=False) for s in TILED_SERVE]
    tiled += [check_tiled(TILED_RAGGED, dt, gen, timed=False) for dt in (bf16, f32)]
    for rec in flash + tiled:
        say("kernel check:", json.dumps(rec))
    return {"flash_attention": flash, "tiled_matmul": tiled}


def phase_e2e() -> dict:
    """Full-width smollm-135m cut to 2 layers: the card (kernels) against
    the CPU (plain versions) from the same weights, teacher-forced."""
    cfg = dataclasses.replace(configs.get("smollm-135m"), n_layers=2)
    bundle = registry.build(cfg)
    params_cpu = bundle.init(torch.Generator().manual_seed(SEED), "cpu")
    params_gpu = _to(params_cpu, "cuda")
    rng = np.random.default_rng(SEED)
    B, S, n_dec = 2, 64, 4
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + n_dec),
                                         dtype=np.int32))
    out = {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        t = toks.to(dev)
        lg, cache = bundle.prefill(params, {"tokens": t[:, :S]})
        cache = kvcache.grow_cache(cache, n_dec, cfg.family)
        cache["len"] = torch.full((B,), S, dtype=torch.int32, device=dev)
        lgs = [lg.float().cpu()]
        for i in range(n_dec):
            lg, cache = bundle.decode_step(params, cache,
                                           {"tokens": t[:, S + i:S + i + 1]})
            lgs.append(lg.float().cpu())
        out[dev] = torch.cat(lgs, dim=1)
    a, b = out["cpu"], out["cuda"]
    if not torch.isfinite(b).all() or a.shape != b.shape:
        raise SystemExit(f"FAIL e2e: card logits {tuple(b.shape)} not finite "
                         f"or not {tuple(a.shape)}")
    worst = (a - b).abs().max().item() / max(a.abs().max().item(), 1e-30)
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    rec = {"layers": cfg.n_layers, "d_model": cfg.d_model, "batch": B,
           "prompt": S, "decode_steps": n_dec, "max_rel_err": worst,
           "tol": E2E_REL_TOL, "argmax_agree": agree}
    say("e2e check:", json.dumps(rec))
    if worst > E2E_REL_TOL:
        raise SystemExit(f"FAIL e2e: card vs CPU logits rel err {worst} > "
                         f"{E2E_REL_TOL}")
    return rec


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def run_serve(argv) -> tuple:
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.run_serve(serve._parse(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, ops.launch_counts(), wall


def summarize(tag, argv, out, launches, wall) -> dict:
    n = len(out["generated"])
    t = out["timings"]
    dec_toks = sum(len(g) for g in out["generated"]) - n
    waves = -(-n // out["slots"])
    rec = {"run": tag, "argv": " ".join(argv), "wall_s": wall,
           "prefill_waves": waves, "decode_steps": out["steps"],
           "admissions": out["admissions"],
           "prefill_tok_s": n * int(argv[argv.index("--prompt-len") + 1])
           / max(t["prefill_s"], 1e-9),
           "decode_tok_s": dec_toks / max(t["decode_s"], 1e-9),
           "ttft_p50_s": out["latency"]["ttft"]["p50"],
           "ttft_p99_s": out["latency"]["ttft"]["p99"],
           "decode_token_p50_s": out["latency"]["decode_token"]["p50"],
           "kv_in_bytes": out["kv"]["in_bytes"],
           "kv_out_bytes": out["kv"]["out_bytes"], "launches": launches}
    say("serve:", json.dumps(rec))
    if not all(out["done"]):
        raise SystemExit(f"FAIL {tag}: not every sequence finished")
    if out["admissions"] <= 0:
        raise SystemExit(f"FAIL {tag}: no sequence was admitted from the KV tier")
    if out["kv"]["in_bytes"] <= 0 or out["kv"]["out_bytes"] <= 0:
        raise SystemExit(f"FAIL {tag}: no KV bytes moved through the tier")
    L = configs.get("smollm-135m").n_layers
    if launches["flash_attention"] < L * waves:
        raise SystemExit(f"FAIL {tag}: flash_attention launched "
                         f"{launches['flash_attention']} < {L} x {waves} waves")
    if launches["tiled_matmul"] < 3 * L * (waves + out["steps"]):
        raise SystemExit(f"FAIL {tag}: tiled_matmul launched "
                         f"{launches['tiled_matmul']} < 90 x "
                         f"({waves} waves + {out['steps']} steps)")
    for g in out["generated"]:
        if any(not 0 <= tok < configs.get("smollm-135m").padded_vocab() for tok in g):
            raise SystemExit(f"FAIL {tag}: token outside the padded vocab: {g}")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build_all()
    say(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, rec in built.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")

    checks = phase_kernels()
    e2e = phase_e2e()

    kv_dir = os.path.join(ROOT, "build", "chip_smoke_kv")
    shutil.rmtree(kv_dir, ignore_errors=True)
    main_argv = ["--arch", "smollm-135m", "--batch", "8", "--kv-slots", "4",
                 "--kv-tier", "host", "--prompt-len", "512", "--new-tokens", "32"]
    out, launches, wall = run_serve(main_argv)
    main_rec = summarize("host", main_argv, out, launches, wall)

    nvme_argv = ["--arch", "smollm-135m", "--batch", "3", "--kv-slots", "1",
                 "--kv-tier", "nvme", "--kv-dir", kv_dir, "--prompt-len", "128",
                 "--new-tokens", "8"]
    out, nvme_launches, wall = run_serve(nvme_argv)
    summarize("nvme", nvme_argv, out, nvme_launches, wall)

    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:65"),
               "tiled_matmul": ("src/repro_torch/csrc/tiled_matmul.cu",
                                "src/repro/kernels/tiled_matmul.py:60")}
    kernels = []
    for name, recs in checks.items():
        head = recs[0]  # the serve shape that dominates the kernel's time
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "tol": head["tol"], "nvme_run_launches": nvme_launches[name],
            "shapes": recs})
    say(f"total: {time.perf_counter() - t_start:.1f} s "
        f"(e2e rel err {e2e['max_rel_err']:.3g}, main-path tok/s "
        f"{main_rec['decode_tok_s']:.0f} decode)")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
