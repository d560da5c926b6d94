"""Chip smoke for the PyTorch/Hopper port: builds the CUDA kernels, holds
each against its plain PyTorch version on the card, serves full-width
smollm-135m through ``repro_torch.launch.serve`` (host and NVMe KV tiers),
trains full smollm-135m through ``repro_torch.launch.train`` with
parameters, gradients and optimizer states on NVMe, in bf16 rows and in q8
wire rows (``--param-quant q8``, through the quantized-matmul kernel),
checks the outputs, and prints one JSON line per the contract below.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from ``src/repro_torch/csrc`` (one nvcc each, in
     parallel), and count the warpgroup MMA (HGMMA) instructions in the
     tiled matmul's library (none fails);
  3. each kernel against its plain version at the serve shapes and at one
     ragged shape, in bf16 and f32, element by element (``TOL``), with
     timings of the bf16 serve shapes (kernel, plain, library yardstick)
     and the least time the card could take (bound); the tiled matmul's
     route held (bf16 on the tensor cores, f32 and the ragged shape on the
     CUDA cores) and its tensor-core kernel timed against the CUDA-core one
     (``simt_ms``, at least ``WGMMA_MIN_SPEEDUP`` faster but at decode);
  4. end-to-end numerics: a 2-layer full-width smollm-135m on the card
     (kernels) against the same weights on the CPU (plain versions),
     teacher-forced prefill + decode logits;
  5. the main path: ``run_serve`` on full smollm-135m (30 layers) with 8
     sequences through 4 device slots, waiting KV on the host tier; launch
     counters are zeroed just before and read just after;
  6. the NVMe KV tier: 3 sequences through 1 slot, once with bf16 KV
     blocks and once with q8 ones (``--kv-quant q8``), counters read again
     for each;
  7. the training kernels against their plain versions: fused Adam at the
     embedding, ``ln_f`` and 100,001 elements; the flash backward (dq, dk,
     dv), the tiled matmul's gradient products on transposed views (all
     four major-ness combinations, a ragged shape on the tensor cores), and
     the quantized matmul forward and in its dX orientation, at the training
     shapes and a ragged one, bf16 and f32 (``TOL``), timed in bf16 at the
     training shapes;
  8. training numerics: a 2-layer full-width smollm-135m, 2 layered steps
     on the card (kernels) against the CPU (plain versions) from the same
     weights and batches: loss, grad norm, and the rows read back from the
     param store; once with bf16 rows, once with q8 wire rows;
  9. the training main path: ``launch.train`` on full smollm-135m (30
     layers), zero3 with params, grads and optimizer states on NVMe, 8
     steps of 8 x 512 tokens, tracer on; launch counters zeroed just before
     and read just after;
  10. the q8 training path: the same run with ``--param-quant q8`` (rows
      cross the tier as q8 frames and the MLP projections run the
      quantized-matmul kernel on them), counters zeroed and read again;
  11. the kernels JSON line, then the device JSON line last.

In every main path (5, 6, 9, 10) each tiled-matmul launch must be on the
tensor-core route (``tiled_matmul_wgmma``), none on ``simt``.

Needs no network and exactly one card; exits non-zero without CUDA.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
from repro_torch.config import (RunConfig, ShapeConfig, TrainConfig,  # noqa: E402
                                make_offload, make_parallel)
from repro_torch.core import kvcache, qformat  # noqa: E402
from repro_torch.core.executor import InfinityExecutor  # noqa: E402
from repro_torch.data.pipeline import SyntheticStream  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import quantized_matmul as tqm  # noqa: E402
from repro_torch.kernels import tiled_matmul as tmm  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402
from repro_torch.runtime.metrics import device_ms as time_ms  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no sparsity
SEED = 0

# serve shapes of full smollm-135m at --kv-slots 4 --prompt-len 512
FLASH_SERVE = (4, 9, 3, 512, 512, 64)  # B, H, KV, Sq, Sk, D
TILED_SERVE = [(2048, 576, 1536), (2048, 1536, 576), (4, 576, 1536)]  # M, K, N
FLASH_RAGGED = (1, 6, 2, 100, 132, 64)  # Sq < Sk, not a multiple of the tiles
TILED_RAGGED = (300, 200, 100)  # w's rows 200 bytes apart: TMA cannot read it
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

# training shapes of full smollm-135m at --batch 8 --seq 512 (4096 tokens)
FLASH_TRAIN = (8, 9, 3, 512, 512, 64)
# the MLP's products per layer: (M, K, N, which operand is a transposed view)
# forward x@W_in|gate and h@W_out, then per projection dX = dY @ W^T and
# dW = X^T @ dY, read in place
TILED_TRAIN = [(4096, 576, 1536, ""), (4096, 1536, 576, ""),
               (4096, 1536, 576, "w"), (576, 4096, 1536, "x"),
               (4096, 576, 1536, "w"), (1536, 4096, 576, "x")]
TILED_TRAIN_RAGGED = [(300, 200, 100, "x"), (300, 200, 100, "w")]
# the tensor-core route at the fourth major-ness (x M-major, w K-major, which
# no main path hands it) at K = 4096, and at a shape that is a multiple of
# no tile (ragged M, N and K), plain and with each operand transposed
TILED_WGMMA = [(1536, 4096, 576, "xw")] + [(296, 200, 104, t) for t in ("", "x", "w", "xw")]
# the tensor-core kernel must beat the CUDA-core one by this at every timed
# bf16 training and prefill shape (not decode, M = 4)
WGMMA_MIN_SPEEDUP = 4.0
ADAM_SIZES = [(49152 * 576, "embed.tok"), (576, "ln_f.scale"), (100_001, "ragged")]
# the quantized matmul on q8 weights q (K, N): (M, K, N, dX orientation);
# forward x (M,K) @ W_in|gate (576,1536) and h (M,1536) @ W_out (1536,576),
# dX = dY (M,1536) @ W_in|gate^T and dY (M,576) @ W_out^T
QMM_TRAIN = [(4096, 576, 1536, False), (4096, 1536, 576, False),
             (4096, 576, 1536, True), (4096, 1536, 576, True)]
QMM_RAGGED = [(100, 96, 64, False), (100, 96, 64, True)]
# The flash backward's bf16 gradients: one output ulp (2^-7 |plain|) plus,
# inside dV, the rare p rounded to bf16 one ulp apart in kernel and plain
# version (lse and the f32 scores differ in the last bits): 2^-9 of the
# gradient's largest element (mag = max |plain|). f32: sums of <= 512
# products in another order, 1e-4 of the largest element. The matmul's bf16
# bound is K * 2^-24 of |x| @ |w|, taken as 2^-11 at K = 4096. Fused Adam
# repeats the plain version's f32 operations in order with no FMA
# contraction, so it must agree bit for bit.
TOL.update({
    ("flash_attention_bwd", torch.bfloat16): {"rtol": 2**-7, "mtol": 2**-9, "atol": 0.0},
    ("flash_attention_bwd", torch.float32): {"rtol": 0.0, "mtol": 1e-4, "atol": 0.0},
    ("tiled_matmul_k4096", torch.bfloat16): {"rtol": 2**-7, "mtol": 2**-11, "atol": 0.0},
    ("tiled_matmul_k4096", torch.float32): {"rtol": 0.0, "mtol": 0.0, "atol": 1e-4},
    ("fused_adam", torch.float32): {"rtol": 0.0, "mtol": 0.0, "atol": 0.0},
    ("fused_adam", torch.bfloat16): {"rtol": 0.0, "mtol": 0.0, "atol": 0.0},
})
# The quantized matmul: both versions dequantize each weight element by the
# same single f32 product q * s, so they differ as the tiled matmul's do —
# one output ulp in bf16 and f32 sums of <= 1536 terms in another order
# (K * 2^-24 of |x| @ |W|, taken as 2^-12); f32: 1e-4 at outputs of O(1).
TOL.update({
    ("quantized_matmul", torch.bfloat16): {"rtol": 2**-7, "mtol": 2**-12, "atol": 0.0},
    ("quantized_matmul", torch.float32): {"rtol": 0.0, "mtol": 0.0, "atol": 1e-4},
})
# Training numerics, card vs CPU: the per-step loss and grad norm by the
# reference's cross-tier tolerance (rtol = atol = 2e-3; bf16 activations
# rounded at other places, averaged down in a mean and a norm). Rows after
# the last step: AdamW's normalized update is bounded whatever the
# gradient, so two runs differ by at most ``adam.parity_bound`` (~2 *
# sum(lr): a tiny gradient may flip sign between them) plus the stored
# row's bf16 rounding; in the bulk, gradients rounded to bf16 apart (2^-8)
# move Adam's ratio by a few 2^-8 of lr: mean |diff| <= 2^-5 * sum(lr).
# With q8 rows each side re-encodes its updated rows: a value may land one
# quant step (its block's absmax/127) from the other side's, so each
# element's bound adds two steps; the mean bound holds as it is (the flips
# average to the values' own drift; measured on the CPU against the
# reference at 0.27 of it).
TRAIN_TOL = {"rtol": 2e-3, "atol": 2e-3}


def say(*a) -> None:
    print(*a, flush=True)


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
    # an exact tolerance (allowed 0) admits only err 0
    worst = torch.where(err == 0, 0.0, err / allowed).max().item()
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
    out, rec_route = routed_matmul(x, w)
    plain = ref.matmul_ref(x, w)
    mag = ref.matmul_ref(x.abs(), w.abs())
    torch.cuda.synchronize()
    rec = compare("tiled_matmul", shape, dtype, out, plain, mag)
    rec.update(rec_route)
    if timed:
        time_tiled(rec, x, w)
    return rec


def routed_matmul(x, w) -> tuple:
    """``ops.tiled_matmul`` with the route its launch counters say it took,
    which must be the one ``tiled_matmul.route`` names, and the plan of a
    tensor-core launch."""
    before = ops.launch_counts()
    out = ops.tiled_matmul(x, w)
    after = ops.launch_counts()
    took = [r for r in tmm.ROUTES if after[f"tiled_matmul_{r}"] == before[f"tiled_matmul_{r}"] + 1]
    if took != [tmm.route(x, w)] or after["tiled_matmul"] != before["tiled_matmul"] + 1:
        raise SystemExit(f"FAIL tiled_matmul: launch counters {before} -> {after} for route "
                         f"{tmm.route(x, w)}")
    rec = {"route": took[0]}
    if took[0] == "wgmma":
        M, K = x.shape
        rec["plan"] = tmm.plan(M, w.shape[1], K, torch.cuda.get_device_properties(0)
                               .multi_processor_count)
    return out, rec


def time_tiled(rec, x, w) -> None:
    """Times of one product on its route (ms), on the CUDA-core kernel as the
    previous design (simt_ms), the plain version and ``torch.matmul``."""
    M, K = x.shape
    N = w.shape[1]
    nbytes = (M * K + K * N + M * N) * x.element_size()
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2.0 * M * N * K, x.dtype)
    rec["ms"] = time_ms(lambda: ops.tiled_matmul(x, w))
    rec["call_ms"] = time_ms(lambda: ops.tiled_matmul(x, w), queued=False)
    rec["simt_ms"] = time_ms(lambda: tmm.tiled_matmul_cuda(x, w, simt=True))
    rec["plain_ms"] = time_ms(lambda: ref.matmul_ref(x, w))
    rec["library_ms"] = time_ms(lambda: torch.matmul(x, w))
    if rec["route"] == "wgmma" and M > 4 and not rec["ms"] * WGMMA_MIN_SPEEDUP <= rec["simt_ms"]:
        raise SystemExit(f"FAIL tiled_matmul {(M, K, N)}: wgmma {rec['ms']} ms is not "
                         f"{WGMMA_MIN_SPEEDUP}x faster than simt {rec['simt_ms']} ms")


def check_routes(recs) -> None:
    """Every bf16 product of the serve and training shapes, the fourth
    major-ness and the TMA-readable ragged shape take the tensor cores; f32
    and the ragged (300,200,100) the CUDA cores."""
    for r in recs:
        shape = tuple(r["shape"])
        want = "simt" if r["dtype"] == "float32" or shape == TILED_RAGGED else "wgmma"
        if r.get("transposed") and shape == TILED_RAGGED:
            continue  # TILED_TRAIN_RAGGED: held only against the plain version
        if r["route"] != want:
            raise SystemExit(f"FAIL tiled_matmul {shape} {r['dtype']} "
                             f"{r.get('transposed', '')!r}: took {r['route']}, want {want}")


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
    check_routes(tiled)
    for rec in flash + tiled:
        say("kernel check:", json.dumps(rec))
    return {"flash_attention": flash, "tiled_matmul": tiled}


def check_tiled_t(case, dtype, gen, timed: bool) -> dict:
    """One product with operands as transposed views (``trans`` holds "x"
    and/or "w"), as the gradient products read the saved tensors."""
    M, K, N, trans = case
    x = randn((K, M) if "x" in trans else (M, K), dtype, gen, 0.1)
    w = randn((N, K) if "w" in trans else (K, N), dtype, gen, 0.1)
    x = x.T if "x" in trans else x
    w = w.T if "w" in trans else w
    out, rec_route = routed_matmul(x, w)
    plain = ref.matmul_ref(x, w)
    mag = ref.matmul_ref(x.abs(), w.abs())
    torch.cuda.synchronize()
    name = "tiled_matmul" if K <= 1536 else "tiled_matmul_k4096"
    rec = compare(name, (M, K, N), dtype, out, plain, mag)
    rec["transposed"] = trans
    rec.update(rec_route)
    if timed:
        time_tiled(rec, x, w)
    return rec


def check_flash_bwd(shape, dtype, gen, timed: bool) -> dict:
    """dq, dk, dv of the kernel against ``ref.attention_bwd_ref`` from the
    same saved o and lse (the kernel forward's), strided (B,S,H,D) views."""
    B, H, KV, Sq, Sk, D = shape
    q, do = (randn((B, Sq, H, D), dtype, gen, 1.0).transpose(1, 2) for _ in range(2))
    k, v = (randn((B, Sk, KV, D), dtype, gen, 1.0).transpose(1, 2) for _ in range(2))
    o, lse = tfa.flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    got = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    recs = [compare("flash_attention_bwd", shape, dtype, g, w, w.float().abs().max())
            for g, w in zip(got, want)]
    rec = {"shape": list(shape), "dtype": recs[0]["dtype"], "tol": recs[0]["tol"],
           "max_abs_err": max(r["max_abs_err"] for r in recs),
           "worst_err_over_tol": max(r["worst_err_over_tol"] for r in recs)}
    if timed:
        pairs = sum(min(Sk, i + (Sk - Sq) + 1) for i in range(Sq)) * B * H
        nbytes = ((3 * q.numel() + 4 * k.numel()) * q.element_size()  # q o dO dq; k v dk dv
                  + lse.numel() * 4)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 10.0 * D * pairs, dtype)
        rec["ms"] = time_ms(lambda: tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do))
        rec["plain_ms"] = time_ms(lambda: ref.attention_bwd_ref(q, k, v, o, lse, do))
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        rec["library_ms"] = time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True))
    return rec


def check_adam(n, label, gen, timed: bool) -> dict:
    """The kernel against the plain version on copies of the same state,
    all four outputs; timed at the embedding with the library's fused
    AdamW (``torch._fused_adamw_``, no bf16 copy) as the yardstick."""
    p, g, m = (randn((n,), torch.float32, gen, 1.0) for _ in range(3))
    v = randn((n,), torch.float32, gen, 0.01).abs()
    scal = ops.adam_scalars(3e-3, 0.9, 0.95, 1e-8, 0.1, 1 - 0.9, 1 - 0.95, "cuda")
    pr, mr, vr = p.clone(), m.clone(), v.clone()
    pbf = ops.fused_adam(p, g, m, v, scal)
    pad = (-n) % 128
    rows = lambda t: F.pad(t, (0, pad)).view(-1, 128)
    prr, mrr, vrr = rows(pr), rows(mr), rows(vr)
    pbf_ref = ref.adam_ref(prr, rows(g), mrr, vrr, scal).reshape(-1)[:n]
    torch.cuda.synchronize()
    recs = [compare("fused_adam", (n,), torch.float32, got, want.reshape(-1)[:n],
                    want.reshape(-1)[:n]) for got, want in ((p, prr), (m, mrr), (v, vrr))]
    recs.append(compare("fused_adam", (n,), torch.bfloat16, pbf, pbf_ref, pbf_ref))
    rec = {"shape": [-(-n // 128), 128], "elements": n, "leaf": label, "dtype": "float32",
           "tol": recs[0]["tol"], "max_abs_err": max(r["max_abs_err"] for r in recs),
           "worst_err_over_tol": max(r["worst_err_over_tol"] for r in recs)}
    if timed:
        rec["bound_ms"], rec["bound_by"] = bound(30.0 * n, 15.0 * n, torch.float32)
        rec["ms"] = time_ms(lambda: ops.fused_adam(p, g, m, v, scal))
        rec["plain_ms"] = time_ms(lambda: ref.adam_ref(prr, rows(g), mrr, vrr, scal))
        step = [torch.tensor(1.0, device="cuda")]
        rec["library_ms"] = time_ms(lambda: torch._fused_adamw_(
            [pr], [g], [mr], [vr], [], step, lr=3e-3, beta1=0.9, beta2=0.95,
            weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False))
    return rec


def check_qmm(case, dtype, gen, timed: bool) -> dict:
    """The quantized matmul on the q8 operands of a random bf16 weight (the
    port's encoder), forward or in its dX orientation, against
    ``ref.quantized_matmul_ref``. No single PyTorch call computes this
    function (library_ms null); ``torch.matmul`` on the weight already
    dequantized to bf16 is timed beside it as a labelled yardstick."""
    M, K, N, trans = case
    q, s, _ = qformat.wire_matmul_operands(
        qformat.encode_array(randn((K, N), torch.bfloat16, gen, 0.1), "q8"))
    q, s = q.cuda(), s.cuda()
    x = randn((M, N if trans else K), dtype, gen, 0.1)
    out = tqm.quantized_matmul_cuda(x, q, s, transpose=trans)
    plain = ref.quantized_matmul_ref(x, q, s, transpose=trans)
    w_abs = qformat.dequant_q8(q, s).abs()
    mag = x.float().abs() @ (w_abs.T if trans else w_abs)
    torch.cuda.synchronize()
    rec = compare("quantized_matmul", (M, K, N), dtype, out, plain, mag)
    rec["transposed"] = trans
    if timed:
        n_out = K if trans else N
        nbytes = (x.numel() + M * n_out) * x.element_size() + q.numel() + s.numel() * 2
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2.0 * M * N * K, dtype)
        rec["ms"] = time_ms(lambda: tqm.quantized_matmul_cuda(x, q, s, transpose=trans))
        rec["plain_ms"] = time_ms(lambda: ref.quantized_matmul_ref(x, q, s, transpose=trans))
        rec["library_ms"] = None
        w = qformat.dequant_q8(q, s).to(dtype)
        w = w.T if trans else w
        rec["yardstick"] = "torch.matmul on the weight dequantized to bf16"
        rec["yardstick_ms"] = time_ms(lambda: torch.matmul(x, w))
    return rec


def phase_train_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    bf16, f32 = torch.bfloat16, torch.float32
    adam = [check_adam(n, label, gen, timed=(i == 0)) for i, (n, label) in enumerate(ADAM_SIZES)]
    fwd = [check_flash(FLASH_TRAIN, bf16, gen, timed=True)]
    bwd = [check_flash_bwd(FLASH_TRAIN, bf16, gen, timed=True)]
    bwd += [check_flash_bwd(FLASH_TRAIN, f32, gen, timed=False)]
    bwd += [check_flash_bwd(FLASH_RAGGED, dt, gen, timed=False) for dt in (bf16, f32)]
    tiled = [check_tiled_t(c, bf16, gen, timed=True) for c in TILED_TRAIN]
    tiled += [check_tiled_t(c, f32, gen, timed=False) for c in TILED_TRAIN]
    tiled += [check_tiled_t(c, dt, gen, timed=False) for c in TILED_TRAIN_RAGGED
              for dt in (bf16, f32)]
    tiled += [check_tiled_t(c, bf16, gen, timed=False) for c in TILED_WGMMA]
    check_routes(tiled)
    qmm = [check_qmm(c, bf16, gen, timed=True) for c in QMM_TRAIN]
    qmm += [check_qmm(c, f32, gen, timed=False) for c in QMM_TRAIN]
    qmm += [check_qmm(c, dt, gen, timed=False) for c in QMM_RAGGED for dt in (bf16, f32)]
    for rec in adam + fwd + bwd + tiled + qmm:
        say("train kernel check:", json.dumps(rec))
    return {"fused_adam": adam, "flash_attention": fwd, "flash_attention_bwd": bwd,
            "tiled_matmul": tiled,
            "quantized_matmul": [r for r in qmm if not r["transposed"]],
            "quantized_matmul_dx": [r for r in qmm if r["transposed"]]}


def _train_run(cfg, dev, nvme_dir, steps, quant="none") -> RunConfig:
    shutil.rmtree(nvme_dir, ignore_errors=True)
    return RunConfig(
        model=cfg, parallel=make_parallel("zero3", remat="none"),
        offload=make_offload(opt_tier="nvme", param_tier="nvme", grad_tier="nvme",
                             nvme_dir=nvme_dir, param_quant=quant),
        train=TrainConfig(lr=3e-3, steps=steps, seed=SEED))


def _q8_step(rows: torch.Tensor) -> torch.Tensor:
    """Each element's q8 quant step: its block's scale (absmax / 127) as
    the q8 encoder stores it."""
    P = rows.shape[1]
    scales = torch.stack([qformat.q8_encode(r)[1] for r in rows])
    return scales.float().repeat_interleave(qformat.BLOCK, dim=1)[:, :P]


def phase_train_numerics(quant: str = "none") -> dict:
    """Full-width smollm-135m cut to 2 layers: 2 layered steps on the card
    (kernels) and on the CPU (plain versions), same weights and batches;
    ``quant`` is ``--param-quant``."""
    cfg = dataclasses.replace(configs.get("smollm-135m"), n_layers=2)
    B, S, steps = 4, 256, 2
    base = os.path.join(ROOT, "build", f"chip_smoke_train_numerics_{quant}")
    state0 = None
    out = {}
    for dev in ("cpu", "cuda"):
        ex = InfinityExecutor(_train_run(cfg, dev, os.path.join(base, dev), steps, quant),
                              dev)
        if state0 is None:
            state0 = ex.engine.init_state(torch.Generator().manual_seed(SEED))
        state = ex.reseed(_to(state0, dev))
        stream = SyntheticStream(ex.input_specs(ShapeConfig("n", S, B, "train")),
                                 cfg.vocab_size, seed=SEED)
        step = ex.make_train_step()
        traj = []
        for i in range(steps):
            batch = {k: torch.from_numpy(a).to(dev) for k, a in stream.batch_at(i).items()}
            state, m = step(state, batch)
            traj.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
        out[dev] = (traj, ex.materialize_flat().float())
        ex.close()
    (tc, rows_c), (tg, rows_g) = out["cpu"], out["cuda"]
    lrs = [t["lr"] for t in tc]
    drift = adam.parity_bound(TrainConfig(), lrs)
    diff = (rows_g - rows_c).abs()
    allowed = drift + 2**-8 * rows_c.abs()
    if quant == "q8":
        allowed = allowed + 2 * _q8_step(rows_c)
    rec = {"param_quant": quant, "layers": 2, "d_model": cfg.d_model, "batch": B,
           "seq": S, "steps": steps, "cpu": tc, "card": tg, "tol": TRAIN_TOL,
           "rows_max_abs_diff": diff.max().item(), "rows_mean_abs_diff": diff.mean().item(),
           "rows_worst_diff_over_bound": (diff / allowed).max().item(),
           "rows_max_bound": drift, "rows_mean_bound": 2**-5 * sum(lrs)}
    say("train numerics:", json.dumps(rec))
    for c, g in zip(tc, tg):
        for key in ("loss", "grad_norm"):
            if not abs(g[key] - c[key]) <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(c[key]):
                raise SystemExit(f"FAIL train numerics ({quant}): card {key} {g[key]} "
                                 f"vs CPU {c[key]}")
    if not bool((diff <= allowed).all()) \
            or not rec["rows_mean_abs_diff"] <= rec["rows_mean_bound"]:
        raise SystemExit(f"FAIL train numerics ({quant}): rows differ beyond the bound: {rec}")
    return rec


def phase_train_main(quant: str = "none") -> tuple:
    """The training main path through ``launch.train`` on full smollm-135m;
    ``quant`` is ``--param-quant`` (q8: the quantized-matmul path)."""
    L, steps = configs.get("smollm-135m").n_layers, 8
    nvme = os.path.join(ROOT, "build", f"chip_smoke_nvme_{quant}")
    shutil.rmtree(nvme, ignore_errors=True)
    argv = ["--arch", "smollm-135m", "--engine", "zero3", "--offload-param", "nvme",
            "--offload-grad", "nvme", "--offload-opt", "nvme", "--batch", "8",
            "--seq", "512", "--steps", str(steps), "--lr", "3e-3", "--nvme-dir", nvme,
            "--log-every", "1", "--param-quant", quant]
    tag = "train" if quant == "none" else f"train {quant}"
    trace.enable()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = train.train(train.build_argparser().parse_args(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    # host time encoding rows to q8 frames (the seed's rows and each step's
    # write-back), from the tracer's wire_encode spans
    encodes = [ev[6] - ev[5] for ev in trace.TRACER.events() if ev[0] == "wire_encode"]
    trace.disable()
    trace.clear()
    tiers = ("param_in", "param_out", "grad_out", "opt_read", "opt_write")
    for m in hist["metrics"]:
        w = max(m["trace_wall_s"], 1e-12)
        say(f"{tag} step:", json.dumps({
            "step": m["step"], "loss": m["loss"], "grad_norm": m["grad_norm"],
            "step_s": m["step_time"], "tokens_per_s": m["tokens_per_s"],
            "compute_frac": m["trace_compute_s"] / w, "io_wait_frac": m["trace_io_wait_s"] / w,
            "other_frac": m["trace_other_s"] / w,
            **{f"{t}_bytes": m[f"{t}_bytes"] for t in tiers},
            **{f"{t}_gbps": m[f"{t}_gbps"] for t in tiers},
            "peak_resident_param_bytes": m["peak_resident_param_bytes"],
            "prefetch_hit_rate": m["prefetch_hit_rate"],
            "param_in_wire_bytes": m["param_in_wire_bytes"],
            "param_out_wire_bytes": m["param_out_wire_bytes"]}))
    losses = hist["losses"]
    rec = {"argv": " ".join(argv), "wall_s": wall, "launches": launches,
           "first_loss": losses[0], "last_loss": losses[-1],
           "param_total_bytes": hist["metrics"][0]["param_total_bytes"],
           "quantized_leaves": ["/".join(p) for p in hist["quantized_leaves"]],
           "wire_encode_rows": len(encodes), "wire_encode_s": sum(encodes),
           "nvme": hist["nvme_stats"]}
    say(f"{tag}:", json.dumps(rec))
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"FAIL {tag}: losses not finite or not falling: {losses}")
    for m in hist["metrics"]:
        if not all(m[f"{t}_bytes"] > 0 for t in tiers):
            raise SystemExit(f"FAIL {tag}: a tier moved no bytes at step {m['step']}")
        if not m["peak_resident_param_bytes"] < m["param_total_bytes"]:
            raise SystemExit(f"FAIL {tag}: every param row was resident at once")
        # q8: 34 wire bytes per 32 bf16 elements (64 bytes), plus a header
        if quant == "q8" and not m["param_in_wire_bytes"] <= 0.54 * m["param_in_bytes"]:
            raise SystemExit(f"FAIL {tag}: param rows crossed as {m['param_in_wire_bytes']} "
                             f"wire bytes for {m['param_in_bytes']} logical")
    # per step: flash forward in every layer's forward and again in its
    # recompute; one flash backward per layer; three MLP projections
    # forward, three in the recompute and two gradient products each (q8:
    # the projections and their dX on the quantized kernel, dW on the tiled
    # matmul); fused Adam once per 'other' leaf (embedding, final norm)
    want = {"flash_attention": 2 * L * steps, "flash_attention_bwd": L * steps,
            "fused_adam": 2 * steps}
    if quant == "q8":
        want.update(quantized_matmul=6 * L * steps, quantized_matmul_dx=3 * L * steps,
                    tiled_matmul=3 * L * steps)
        if rec["quantized_leaves"] != ["mlp/w_gate", "mlp/w_in", "mlp/w_out"]:
            raise SystemExit(f"FAIL {tag}: the q8 plan leaves MLP weights out: "
                             f"{rec['quantized_leaves']}")
    else:
        want["tiled_matmul"] = (3 + 3 + 6) * L * steps
    for name, n in want.items():
        if launches[name] < n:
            raise SystemExit(f"FAIL {tag}: {name} launched {launches[name]} < {n}")
    check_main_path_routes(tag, launches)
    return rec, launches


def check_main_path_routes(tag, launches) -> None:
    """Every tiled-matmul launch of a main path is a tensor-core one."""
    if launches["tiled_matmul_simt"] or launches["tiled_matmul_wgmma"] != launches["tiled_matmul"]:
        raise SystemExit(f"FAIL {tag}: tiled_matmul launched {launches['tiled_matmul']} times, "
                         f"{launches['tiled_matmul_wgmma']} on wgmma and "
                         f"{launches['tiled_matmul_simt']} on simt; want all on wgmma")


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
    """A copy of a nested dict / tuple of tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_to(v, dev) for v in tree))
    return tree.to(dev, copy=True)


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
           "kv_out_bytes": out["kv"]["out_bytes"],
           "kv_in_wire_bytes": out["kv"]["in_wire_bytes"],
           "kv_out_wire_bytes": out["kv"]["out_wire_bytes"], "launches": launches}
    say("serve:", json.dumps(rec))
    if not all(out["done"]):
        raise SystemExit(f"FAIL {tag}: not every sequence finished")
    if out["admissions"] <= 0:
        raise SystemExit(f"FAIL {tag}: no sequence was admitted from the KV tier")
    if out["kv"]["in_bytes"] <= 0 or out["kv"]["out_bytes"] <= 0:
        raise SystemExit(f"FAIL {tag}: no KV bytes moved through the tier")
    if "--kv-quant" in argv and not (0 < out["kv"]["out_wire_bytes"]
                                     <= 0.54 * out["kv"]["out_bytes"]):
        raise SystemExit(f"FAIL {tag}: q8 KV parked {out['kv']['out_wire_bytes']} wire "
                         f"bytes for {out['kv']['out_bytes']} logical")
    L = configs.get("smollm-135m").n_layers
    if launches["flash_attention"] < L * waves:
        raise SystemExit(f"FAIL {tag}: flash_attention launched "
                         f"{launches['flash_attention']} < {L} x {waves} waves")
    if launches["tiled_matmul"] < 3 * L * (waves + out["steps"]):
        raise SystemExit(f"FAIL {tag}: tiled_matmul launched "
                         f"{launches['tiled_matmul']} < 90 x "
                         f"({waves} waves + {out['steps']} steps)")
    check_main_path_routes(tag, launches)
    for g in out["generated"]:
        if any(not 0 <= tok < configs.get("smollm-135m").padded_vocab() for tok in g):
            raise SystemExit(f"FAIL {tag}: token outside the padded vocab: {g}")
    return rec


def count_hgmma() -> int:
    """Warpgroup MMA instructions (HGMMA) in the built tiled-matmul library,
    read with the toolkit's cuobjdump; fails when there are none."""
    lib = _build.lib_path("tiled_matmul")
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    n = sum("HGMMA" in line for line in sass.splitlines())
    say(f"tiled_matmul: {n} HGMMA instructions in {lib.name}")
    if n == 0:
        raise SystemExit("FAIL tiled_matmul: the built library has no HGMMA instruction")
    return n


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
    hgmma = count_hgmma()

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
    shutil.rmtree(kv_dir, ignore_errors=True)
    q8kv_argv = nvme_argv + ["--kv-quant", "q8"]
    out, q8kv_launches, wall = run_serve(q8kv_argv)
    summarize("nvme q8", q8kv_argv, out, q8kv_launches, wall)

    train_checks = phase_train_kernels()
    numerics = phase_train_numerics()
    phase_train_numerics("q8")
    train_rec, train_launches = phase_train_main()
    q8_rec, q8_launches = phase_train_main("q8")

    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:65"),
               "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention.cu",
                                       "none: the TPU kernel has no backward "
                                       "(src/repro/kernels/flash_attention.py:65)"),
               "tiled_matmul": ("src/repro_torch/csrc/tiled_matmul.cu",
                                "src/repro/kernels/tiled_matmul.py:60"),
               "fused_adam": ("src/repro_torch/csrc/fused_adam.cu",
                              "src/repro/kernels/fused_adam.py:47"),
               "quantized_matmul": ("src/repro_torch/csrc/quantized_matmul.cu",
                                    "src/repro/kernels/tiled_matmul.py:92"),
               "quantized_matmul_dx": ("src/repro_torch/csrc/quantized_matmul.cu",
                                       "none: the TPU kernel has no dX orientation "
                                       "(src/repro/kernels/tiled_matmul.py:92)")}
    serve_launches = {"flash_attention": launches, "tiled_matmul": launches}
    # each kernel's main path: the q8 training run for the quantized kernel,
    # the bf16 training run for the others
    main_launches = {**train_launches, "quantized_matmul": q8_launches["quantized_matmul"],
                     "quantized_matmul_dx": q8_launches["quantized_matmul_dx"]}
    kernels = []
    for name in sources:
        recs = checks.get(name, []) + train_checks.get(name, [])
        # the training path's first timed shape; every other shape beside it
        head = next(r for r in train_checks[name] if "ms" in r)
        src, replaces = sources[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": main_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "tol": head["tol"], "q8_run_launches": q8_launches[name], "shapes": recs}
        if "yardstick_ms" in head:
            entry["yardstick"], entry["yardstick_ms"] = head["yardstick"], head["yardstick_ms"]
        if name == "tiled_matmul":
            entry["simt_ms"] = head["simt_ms"]
            entry["routes"] = {run: {r: c[f"tiled_matmul_{r}"] for r in tmm.ROUTES}
                               for run, c in (("train", train_launches), ("train_q8", q8_launches),
                                              ("serve_host", launches),
                                              ("serve_nvme", nvme_launches),
                                              ("serve_nvme_q8", q8kv_launches))}
            entry["hgmma_instructions"] = hgmma
        if name in serve_launches:
            entry["serve_launches"] = serve_launches[name][name]
            entry["nvme_run_launches"] = nvme_launches[name]
            entry["nvme_q8_run_launches"] = q8kv_launches[name]
        kernels.append(entry)
    say(f"total: {time.perf_counter() - t_start:.1f} s "
        f"(e2e rel err {e2e['max_rel_err']:.3g}, main-path tok/s "
        f"{main_rec['decode_tok_s']:.0f} decode; train "
        f"{train_rec['first_loss']:.4f} -> {train_rec['last_loss']:.4f}, q8 "
        f"{q8_rec['first_loss']:.4f} -> {q8_rec['last_loss']:.4f}, "
        f"numerics loss {numerics['card'][-1]['loss']:.5f} card vs "
        f"{numerics['cpu'][-1]['loss']:.5f} CPU)")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
