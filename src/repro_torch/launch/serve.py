"""Continuous-batching serving driver with tier-paged KV blocks — the
PyTorch port of ``repro/launch/serve.py``.

A fixed batch of device decode slots advances in lockstep: per-slot
lengths and EOS are tracked, a slot whose sequence finishes (EOS or token
budget) is refilled from the waiting queue, and idle slots keep decoding
into padding that is masked out of the returned text. Sequences beyond the
device KV budget wait in the host (or NVMe) tier as fixed-size
per-sequence KV blocks (``core/kvcache.py``) and stream back when admitted.
On the card, prefill attention and every MLP projection run the port's
hand-written CUDA kernels (``kernels/ops.py``).

With ``--plan auto`` the KV tier, slot count, block size and read-ahead
come from the planner (``repro_torch/plan.py``: the same Sec. 3 byte
arithmetic that places training state), ``--kv-*`` flags override per
field, and the smoke check holds the measured device KV to the plan's
``kv_resident_bytes``.

Runs on the card by default and raises when CUDA is absent; ``--device
cpu`` runs the plain versions (the tests do). ``--kv-quant q8|q4`` parks
waiting KV blocks as block-quantized wire bytes (``core/qformat.py``),
decoded on the host when fetched.

On data-parallel ranks (``--data-mesh D``, or ``--plan auto --hw-devices
D``; one process a rank under torchrun, as ``launch/mesh.py`` describes)
each rank holds its ZeRO-3 param shards (the reference's sharding rules,
``partition.make_rules``) and gathers one layer's leaves at a time in
every prefill wave and decode step (``ZeroInfinityEngine.serve_params``):
the reference's gather once per scanned step. The global ``slots`` (the
flags' or the plan's) split over the ranks where they divide: rank r owns
global slots ``[r*S/D, (r+1)*S/D)`` and those rows of every prefill wave,
parks the waiting ones in its own KV store (NVMe: ``<kv-dir>/rank<r>``)
and admits them into its own slots. Where they do not divide, every rank
serves every slot (the reference replicates such a batch) and rank 0's
counters are the run's. The ranks step in lockstep until none has an
active slot (one all-reduce of an int a step); every rank returns the
run: the sequences' tokens and latencies gathered from their ranks,
``admissions`` and ``kv`` summed (``kv_ranks`` beside), each rank's
``param_shard_bytes`` and peak allocated bytes.

With a model axis (``--model-mesh M``: D * M ranks, rank r at data
coordinate r // M and model coordinate r % M) every family serves under
the reference's attention strategy. Where
the heads split over M, tensor parallelism (``models/common.py``): each rank holds
its heads, MLP columns (MoE: its experts) and vocab rows, gathers a layer
over the data axis alone (the model shards stay split: no param byte
crosses the model axis) and joins the row-parallel products with an
all-reduce over its model group. The slots split over the data
coordinate; the model ranks of a data row serve the same rows, each
parking its own KV heads in its own store, so the ``kv`` bytes summed over
the ranks are the reference's where the KV heads split over the model
ranks; where they do not, each rank parks the KV heads its query heads
read (``transformer.local_kv_heads``). The logits stay vocab-sharded: a
token is the global argmax over the ranks' shards, the first index on ties
as ``jnp.argmax`` takes it.

Where the heads do not split, context parallelism: a prompt that splits
over the M ranks is prefilled a chunk a rank (else whole on each), the
MLP's columns and the vocab rows are gathered whole a layer at a time
(the bytes a decode step moves so are printed; MoE's experts stay split),
and the decode cache is the reference's ``cache_seq`` on ``model``: where
the capacity C (prompt + new tokens) divides by M, rank m holds positions
``[m * C/M, (m+1) * C/M)`` of every slot (``kvcache.seq_split``), they
move to their owners once after prefill (``kvcache.decode_positions``), a
decode token is written by its position's owner, and attention combines
the ranks' partial softmaxes (flash-decode). Each rank parks and fetches
its own positions of a waiting sequence, so the ``kv`` bytes summed over
the ranks are the reference's and each holds 1/M of the resident K/V.
Where C does not divide, every model rank holds the whole cache, and
model rank 0's ``kv`` counters are the data row's. The SSM and the
hybrid serve there too, each rank its ``inner`` channels of every
recurrent block (``models/mamba2.py``, ``models/rglru.py``): their fixed
caches hold the rank's channels of the conv tails and states, and mamba2's
``conv_B`` / ``conv_C`` and the hybrid's window rings whole on every model
rank, so each rank parks its own; nothing of them splits by position. The
encoder-decoder serves under both (``models/encdec.py``): under tensor
parallelism each rank parks its KV heads of the decoder's K/V and of the
cross-attention's ``xk`` / ``xv``; under context parallelism a wave's
frames and tokens are prefilled a chunk a rank where both split over M,
and ``xk`` / ``xv`` split by the memory's positions with ``k`` / ``v``
where the capacity and the frames both divide by M (each rank parks its
range of both), else every rank holds the whole cache.

Every family serves: dense, MoE (``--arch granite-moe-1b-a400m``: the
routed experts run in prefill and in every decode step, with the same
paged KV as a dense model), the VLM (``--arch llava-next-34b``: the prompt
holds the ``vision_len`` vision positions, so ``--prompt-len`` must exceed
them; decode continues after them), the encoder-decoder (``--arch
seamless-m4t-medium``: ``--prompt-len`` frames into the encoder, a quarter
as many decoder tokens; its cross-attention keys park whole beside the
paged decoder K/V; ``--layers`` is refused, as its depth is two stacks),
and the fixed-state families
(``--arch mamba2-370m``: conv tails and the SSD state;
``--arch recurrentgemma-9b``: LRU states and window-bounded K/V rings):
their caches do not grow with the context, each slot keeps its own
length, and a waiting sequence's cache parks whole (no token blocks).

Examples (one H100: full smollm-135m, llava-next-34b at full width cut to
8 layers, full seamless-m4t-medium; 8 sequences through 4 device slots;
then two ranks on the CPU, and full llava-next-34b on four cards, each
rank a quarter of its params):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --batch 8 --kv-slots 4 --kv-tier host --prompt-len 512 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-34b \
      --layers 8 --batch 8 --kv-slots 4 --kv-tier host --prompt-len 3072 \
      --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch seamless-m4t-medium --batch 8 --kv-slots 4 --kv-tier host \
      --prompt-len 2048 --new-tokens 32
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.serve --smoke --device cpu --data-mesh 2 \
      --batch 5 --kv-slots 2 --kv-tier host --prompt-len 16 --new-tokens 8
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
      -m repro_torch.launch.serve --arch llava-next-34b --data-mesh 4 \
      --batch 8 --kv-slots 4 --kv-tier host --prompt-len 3072 --new-tokens 16
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
      -m repro_torch.launch.serve --arch llava-next-34b --model-mesh 4 \
      --batch 8 --kv-slots 4 --kv-tier host --prompt-len 3072 --new-tokens 16
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.serve --arch smollm-135m --model-mesh 2 \
      --batch 8 --kv-slots 4 --kv-tier host --prompt-len 512 --new-tokens 8
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.serve --arch granite-moe-1b-a400m --model-mesh 2 \
      --batch 8 --kv-slots 4 --kv-tier host --prompt-len 512 --new-tokens 32

(the last two: context parallelism, smollm-135m's 9 heads over 2 ranks,
and granite's 32 experts split over 2 ranks under tensor parallelism)
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch import plan as plan_mod
from repro_torch.config import ParallelConfig, RunConfig, ShapeConfig
from repro_torch.core import kvcache, qformat
from repro_torch.core import partition as pt
from repro_torch.core.engine import ZeroInfinityEngine
from repro_torch.core.offload import HostArrayStore, NvmeStore, PinnedBufferPool
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import common as cm
from repro_torch.runtime import metrics as metrics_mod
from repro_torch.runtime import trace


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers at full width "
                         "(0: the config's depth)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu "
                         "(the plain versions)")
    ap.add_argument("--batch", type=int, default=4,
                    help="total sequences to serve; those beyond --kv-slots "
                         "wait on the KV tier as paged blocks")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16,
                    help="per-sequence token budget (includes the EOS token)")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="EOS token id; a slot emitting it finishes early "
                         "(-1: budget-only)")
    ap.add_argument("--kv-slots", type=int, default=0,
                    help="device decode slots (0 = all sequences resident)")
    ap.add_argument("--kv-tier", default="device",
                    choices=["device", "host", "nvme"],
                    help="tier for waiting sequences' KV blocks ('device' "
                         "stages any overflow through host DRAM)")
    ap.add_argument("--kv-block-tokens", type=int, default=0,
                    help="tokens per paged KV block (0 = auto)")
    ap.add_argument("--kv-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_kv"),
                    help="directory backing the NVMe KV tier")
    ap.add_argument("--kv-quant", default="none", choices=["none", "q8", "q4"],
                    help="block-quantized wire format for parked KV "
                         "blocks (core/qformat.py): waiting KV costs "
                         "0.53x (q8) / 0.31x (q4) of bf16 on the tier")
    ap.add_argument("--data-mesh", type=int, default=0,
                    help="data-parallel ranks, one process each (torchrun); 0: "
                         "the devices a --plan is made for (--hw-devices), else 1")
    ap.add_argument("--model-mesh", type=int, default=1,
                    help="model-parallel ranks (tensor or context parallelism, every "
                         "family): --data-mesh x --model-mesh ranks in all")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", nargs="?", const="trace.json", default=None,
                    metavar="OUT.json",
                    help="record spans and write a Chrome/Perfetto trace")
    plan_mod.add_plan_args(ap)
    return ap.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """The run's device; raises when CUDA is asked for and absent."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available here; pass "
                           "--device cpu to serve with the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: want cuda or cpu")
    return dev


def global_argmax(logits: torch.Tensor, mesh, sharded: bool) -> torch.Tensor:
    """The argmax over the last dim of ``logits`` (..., V); with
    ``sharded`` they are the model rank's vocab columns ``[m * V, (m+1) *
    V)`` and the argmax is the global one over the model ranks' shards:
    each rank's (max, first index) gathered over the model axis, the
    first rank holding the max wins, so ties go to the smallest global
    index, as ``jnp.argmax`` breaks them."""
    if not sharded:
        return logits.argmax(-1)
    n = logits.shape[-1]
    val, idx = logits.float().max(-1)  # the first index of the max
    idx = idx + mesh.coords()["model"] * n
    vals = mesh.all_gather(val[None], 0, "model")
    idxs = mesh.all_gather(idx[None], 0, "model")
    return torch.gather(idxs, 0, vals.argmax(0, keepdim=True))[0]


def _percentiles(xs) -> dict:
    """p50/p95/p99 of a latency sample, in seconds (zeros when empty)."""
    if not xs:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    a = np.asarray(xs, np.float64)
    return {f"p{q}": float(np.percentile(a, q)) for q in (50, 95, 99)}


def draw_inputs(specs: dict, n_seqs: int, vocab_size: int, seed: int) -> dict:
    """Every sequence's prefill inputs (``specs``' leaves with ``n_seqs``
    rows), drawn from ``seed`` in the specs' order as the reference's
    driver draws them: token ids uniform over the vocab; float inputs (a
    VLM's vision embeddings, an enc-dec model's frames) unit-normal * 0.1,
    cast f64 -> f32 -> the spec's dtype, which gives the bits of the
    reference's f64 -> bf16 cast."""
    rng = np.random.default_rng(seed)
    full = {}
    for k, v in specs.items():
        shp = (n_seqs,) + tuple(v.shape[1:])
        if v.dtype.is_floating_point:
            full[k] = torch.from_numpy(
                (rng.standard_normal(shp) * 0.1).astype(np.float32)).to(v.dtype)
        else:
            full[k] = torch.from_numpy(
                rng.integers(0, vocab_size, shp, dtype=np.int32)).to(v.dtype)
    return full


def _insert(slot_cache: dict, single: dict, b: int, length: int) -> dict:
    """Admission: write one fetched sequence (nested as the cache is) into
    decode slot ``b`` of the device slot cache IN PLACE (the reference's
    donated functional update). The parked ``len`` placeholder is not
    consulted: the slot's length is ``length``, the sequence's."""
    for path in pt.tree_paths(single):
        if path == ("len",):
            continue
        dst = pt.tree_get(slot_cache, path)
        dst[:, b] = pt.tree_get(single, path)[:, 0].to(device=dst.device, dtype=dst.dtype)
    slot_cache["len"][b] = length
    return slot_cache


def run_serve(args, argv=None, cfg=None, attn_strategy: str = "auto") -> dict:
    """The serving run; returns per-sequence tokens + timings + KV metrics
    (the test surface — ``main`` just prints). ``argv`` (default
    ``sys.argv[1:]``) says which legacy flags were given: under ``--plan
    auto`` those become overrides of the derived plan. ``cfg`` serves
    that model config in place of ``--arch``'s (a cut the flags cannot
    name: ``--layers`` cuts one stack, an encoder-decoder has two), and
    ``attn_strategy`` is the model axis' attention strategy the run's
    config forces (``ParallelConfig.attn_strategy``; the CLI's is "auto").
    Joins the process group torchrun describes where none exists (and
    leaves it before returning); on a mesh every rank returns the run's
    numbers, gathered from the ranks (``_serve``)."""
    device = resolve_device(args.device)
    created = mesh_mod.maybe_init_distributed(device.type)
    try:
        mesh = mesh_mod.make_local_mesh(mesh_mod.data_mesh(args), args.model_mesh, device,
                                        entry="serve")
        return _serve(args, argv, mesh, cfg, attn_strategy)
    finally:
        if created:
            torch.distributed.destroy_process_group()


def _serve(args, argv, mesh, cfg, attn_strategy) -> dict:
    device = mesh.device
    if cfg is None:
        cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    cfg = configs.with_layers(cfg, args.layers)
    n_seqs, P, N = args.batch, args.prompt_len, args.new_tokens
    eos = args.eos_id
    plan = plan_mod.resolve_plan(
        args, cfg, ShapeConfig("serve-plan", P + N, n_seqs, "decode"),
        argv=argv)
    if plan is not None and plan.hardware.n_devices != mesh.world:
        n = plan.hardware.n_devices
        raise ValueError(
            f"a plan for {n} device(s) serves on as many ranks, and this run has "
            f"{mesh.world}: plan for {mesh.world} (--hw-devices {mesh.world}) or launch "
            f"{n} ranks (torchrun --standalone --nproc-per-node {n} ... --hw-devices {n})")
    if plan is not None:
        run = plan.to_run_config()
        kv_tier = plan.kv_tier
        slots = plan.kv_slots or n_seqs
        block_tokens = plan.kv_block_tokens
        kv_prefetch = plan.kv_prefetch_blocks
    else:
        run = RunConfig(model=cfg, parallel=ParallelConfig(remat="none"))
        kv_tier = args.kv_tier
        slots = args.kv_slots or n_seqs
        block_tokens = args.kv_block_tokens
        kv_prefetch = 2
    run = dataclasses.replace(run, parallel=dataclasses.replace(run.parallel,
                                                                attn_strategy=attn_strategy))
    slots = max(1, min(int(slots), n_seqs))
    block_tokens = int(block_tokens) or kvcache.default_block_tokens(P + N)
    # the rank's slots: global slots [lo, lo + local) where they divide over
    # the data ranks, else every slot (the batch replicated, as the
    # reference's rule replicates a batch dim that does not divide); the
    # model ranks of a data row serve the same slots
    D, M, coord = mesh.data, mesh.model, mesh.coords()
    split = slots % D == 0
    local = slots // D if split else slots
    lo = coord["data"] * local if split else 0
    if device.type == "cuda":  # the run's peak, from here (its allocator up first)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    eng = ZeroInfinityEngine(run, device, mesh=mesh)
    params = eng.init_params(torch.Generator(device=device).manual_seed(args.seed))
    bundle = eng.bundle
    cp = eng.mp is not None and not eng.mp.tp  # context parallelism
    # the logits of a rank whose vocab rows are its own are that shard
    sharded = eng.mp is not None and cm.vocab_sharded(params["embed"], cfg, eng.mp)

    def next_tokens(logits):
        return global_argmax(logits[:, -1], mesh, sharded).to(torch.int32).cpu().numpy()

    def own_len(cache):
        """``cache`` as this rank parks and counts it: the ``len`` leaf (a
        parked placeholder no fetch reads, and the slots' lengths) is one
        a data row, model rank 0's, so the ranks' summed bytes count it
        once, as the reference's one cache does."""
        return cache if coord["model"] == 0 else {k: v for k, v in cache.items()
                                                   if k != "len"}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # the slow tier for waiting sequences (unused when every slot fits);
    # on a mesh each rank's own store (NVMe: <kv-dir>/rank<r>/kv)
    pool = PinnedBufferPool(run.offload.pinned_buffer_mb << 20,
                            pin=device.type == "cuda")
    if kv_tier == "nvme":
        root = args.kv_dir if mesh.world == 1 else os.path.join(args.kv_dir, f"rank{mesh.rank}")
        store = NvmeStore(os.path.join(root, "kv"), pool=pool,
                          workers=run.offload.nvme_workers)
    else:
        store = HostArrayStore(pool=pool, workers=2)
    store.trace_cls = "kv"
    store = qformat.maybe_wrap_store(store, args.kv_quant)
    seq_names = ("k", "v") if cfg.family in kvcache.SEQ_CACHE_FAMILIES else ()
    kv = kvcache.PagedKVCache(store, block_tokens=block_tokens,
                              seq_axis_names=seq_names,
                              prefetch_blocks=kv_prefetch)

    # ---- prompts for every sequence (waves of `slots` rows, the rank's
    # `local` of them) ----
    full = draw_inputs(bundle.input_specs(ShapeConfig("serve", P, slots, "prefill")),
                       n_seqs, cfg.vocab_size, args.seed)

    def wave_rows(w):
        """The rank's rows of wave ``w`` (sequence ids, padded with 0) and
        how many of them are real sequences."""
        base = w * slots + lo
        idx = list(range(base, min(base + local, n_seqs)))
        valid = len(idx)
        while len(idx) < local:
            idx.append(0)  # padding rows; results discarded
        return idx, valid

    def wave_batch(idx):
        return {k: a[idx].to(device) for k, a in full.items()}

    n_waves = -(-n_seqs // slots)
    gen = [[] for _ in range(n_seqs)]
    done = [False] * n_seqs
    owned = []  # the sequences this rank prefilled
    waiting: collections.deque = collections.deque()

    pc = time.perf_counter
    with torch.no_grad():
        # untimed warm-up (kernel build and load, first launches): the
        # throughput below is steady-state compute
        t0 = pc()
        bundle.prefill(eng.serve_params(params), wave_batch(wave_rows(0)[0]))
        sync()
        t_compile_prefill = pc() - t0

        t_prefill = 0.0
        wave0 = None
        ttft = [0.0] * n_seqs  # time to first token, from serve start
        t_serve = pc()
        for w in range(n_waves):
            idx, valid = wave_rows(w)
            t0 = pc()
            with trace.span("prefill", sys="serve", attr="compute", unit=w):
                logits, cache = bundle.prefill(eng.serve_params(params), wave_batch(idx))
                sync()
            t_prefill += pc() - t0
            first = next_tokens(logits)
            prefill_len = int(cache["len"])
            # the positions this rank keeps of a sequence (under context
            # parallelism where the capacity splits, its range of them)
            cache, own, local_cap, split_seq = kvcache.decode_positions(
                cache, eng.mp, prefill_len + N)
            t_first = pc() - t_serve
            for j in range(valid):
                s = idx[j]
                owned.append(s)
                ttft[s] = t_first
                gen[s].append(int(first[j]))
                if int(first[j]) == eos or N <= 1:
                    done[s] = True  # finished at birth: EOS-masked already
            if w == 0:
                wave0 = (cache, idx, valid)
            else:
                for j in range(valid):
                    s = idx[j]
                    if not done[s]:
                        kv.park(f"seq{s}", own_len(kvcache.slice_sequence(cache, j)), own)
                        waiting.append(s)
        kv.flush()

        # ---- device slot cache: wave 0 grown to decode capacity, with a
        # per-slot length vector in place of the scalar prefill length ----
        cache0, idx0, valid0 = wave0
        slot_cache = kvcache.grow_cache(cache0, local_cap - own, cfg.family)
        slot_cache = {**slot_cache,
                      "len": torch.full((local,), prefill_len,
                                        dtype=torch.int32, device=device)}
        resident = kvcache.device_kv_bytes(own_len(slot_cache))
        decode = (functools.partial(bundle.decode_step, seq_split=True) if split_seq
                  else bundle.decode_step)

        slot_seq = [idx0[j] if j < valid0 else None for j in range(local)]
        active = [j < valid0 and not done[idx0[j]] for j in range(local)]
        cur = np.zeros((local,), np.int32)
        for j in range(valid0):
            cur[j] = gen[idx0[j]][-1]

        # untimed decode warm-up on a copy (decode writes its cache in place)
        t0 = pc()
        decode(eng.serve_params(params), pt.tree_map(torch.clone, slot_cache),
               {"tokens": torch.zeros((local, 1), dtype=torch.int32, device=device)})
        sync()
        t_compile_decode = pc() - t0
        gathered0 = eng.model_gather_bytes[0]

        # ---- continuous-batching decode loop ----
        # Admission fetches are issued AHEAD of need (kv.start_fetch) so the
        # block reads overlap decode steps; a freed slot pays only the
        # uncovered remainder, reported as admit_stall_s. On a mesh a
        # waiting sequence is admitted into a slot of the rank that parked
        # it; the ranks step in lockstep (every step gathers each layer)
        # until no rank has an active slot, which a waiting sequence would
        # have taken.
        history = []
        tok_lat = []  # per-token decode latency (one entry per token)
        t_decode = t_admit = t_admit_stall = 0.0
        steps = admissions = 0
        prefetched: collections.deque = collections.deque()

        def top_up_admissions():
            while waiting and len(prefetched) < local:
                s = waiting.popleft()
                prefetched.append((s, kv.start_fetch(f"seq{s}", local_cap)))

        top_up_admissions()  # first admissions overlap the first decodes
        while True:
            m = kv.mark()
            for b in range(local):
                if active[b] or not prefetched:
                    continue
                s, handle = prefetched.popleft()
                ta = pc()
                with trace.span("admit_wait", sys="serve", attr="io_wait",
                                cls="kv", unit=s):
                    single, _ = handle.result()
                t_admit_stall += pc() - ta
                with trace.span("admit_insert", sys="serve", attr="compute",
                                cls="kv", unit=s):
                    # every sequence waited at its prompt's length (a
                    # context-parallel rank parked its positions alone)
                    _insert(slot_cache, single, b, prefill_len)
                t_admit += pc() - ta
                kv.drop(f"seq{s}")
                slot_seq[b], active[b] = s, True
                cur[b] = gen[s][-1]
                admissions += 1
            top_up_admissions()
            for _, handle in prefetched:
                handle.poll()  # keep windows full without blocking
            if not mesh.sum_over_ranks([sum(active)])[0]:
                break
            t0 = pc()
            with trace.span("decode_step", sys="serve", attr="compute",
                            unit=steps):
                logits, slot_cache = decode(
                    eng.serve_params(params), slot_cache,
                    {"tokens": torch.from_numpy(cur[:, None].copy()).to(device)})
                toks = next_tokens(logits)
            step_dt = pc() - t0
            t_decode += step_dt
            steps += 1
            history.append(
                metrics_mod.kv_step_metrics(kv.delta_since(m), resident))
            for b in range(local):
                if not active[b]:
                    continue  # idle slot: padding decode, masked out
                s = slot_seq[b]
                tok_lat.append(step_dt)
                gen[s].append(int(toks[b]))
                cur[b] = toks[b]
                if int(toks[b]) == eos or len(gen[s]) >= N:
                    done[s], active[b], slot_seq[b] = True, False, None
                    cur[b] = 0

    stats = store.bandwidth_stats()
    store.close()
    kv_rank = {
        "resident_bytes": resident,
        "in_bytes": int(stats["logical_bytes_read"]),
        "out_bytes": int(stats["logical_bytes_written"]),
        "in_wire_bytes": int(stats["bytes_read"]),
        "out_wire_bytes": int(stats["bytes_written"]),
        "parked_peak_bytes": kv.parked_bytes(),
        "pinned_peak_bytes": int(pool.peak_resident),
        "pinned_budget_bytes": int(run.offload.pinned_buffer_mb) << 20,
    }
    gathered = eng.model_gather_bytes[0] - gathered0
    mine = {"seqs": {s: (gen[s], done[s], ttft[s]) for s in owned}, "tok_lat": tok_lat,
            "admissions": admissions, "kv": kv_rank,
            "param_shard_bytes": sum(t.numel() * t.element_size()
                                     for t in pt.tree_leaves(params)),
            "peak_allocated_bytes": (torch.cuda.max_memory_allocated(device)
                                     if device.type == "cuda" else 0)}
    ranks = mesh.gather_objects(mine)
    # the run's numbers: the sequences of every data row's model rank 0 and
    # every rank's counters summed where the slots split; data row 0's
    # where every data row served every slot
    serving = ranks if split else ranks[:M]
    # a cache whole on every model rank (context parallelism whose capacity
    # does not split, and no recurrent family's inner channels split) is
    # counted once a data row: model rank 0's
    counted = serving if not cp or split_seq or eng.mp.inner else serving[::M]
    tok_lat = []
    for r in serving[::M]:
        for s, (g, d, t) in r["seqs"].items():
            gen[s], done[s], ttft[s] = g, d, t
        tok_lat += r["tok_lat"]
    return {
        "generated": gen,
        "done": done,
        "slots": slots,
        "kv_tier": kv_tier,
        "block_tokens": block_tokens,
        "steps": steps,
        "admissions": sum(r["admissions"] for r in serving[::M]),
        "plan": plan,
        "history": history,
        "latency": {
            "ttft_s": list(ttft),
            "decode_token_s": list(tok_lat),
            "ttft": _percentiles(ttft),
            "decode_token": _percentiles(tok_lat),
        },
        "kv": {k: sum(r["kv"][k] for r in counted) for k in kv_rank},
        "mesh": {"world": mesh.world, "rank": mesh.rank, "backend": mesh.backend,
                 "data": D, "model": M, "strategy": eng.mp.strategy if eng.mp else None,
                 "slots_split": split, "local_slots": local, "cache_seq_split": split_seq,
                 "local_cache_len": local_cap,
                 # the param bytes a decode step gathers over the model axis
                 # (context parallelism's whole leaves), this rank's
                 "model_gather_bytes_per_step": gathered // max(steps, 1)},
        "kv_ranks": [r["kv"] for r in ranks],
        "admissions_ranks": [r["admissions"] for r in ranks],
        "param_shard_bytes": [r["param_shard_bytes"] for r in ranks],
        "peak_allocated_bytes": [r["peak_allocated_bytes"] for r in ranks],
        "timings": {
            "compile_prefill_s": t_compile_prefill,
            "compile_decode_s": t_compile_decode,
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "admit_s": t_admit,
            "admit_stall_s": t_admit_stall,
        },
    }


def main(argv=None) -> None:
    args = _parse(argv)
    if args.trace:
        trace.enable()
    out = run_serve(args, argv)
    if out["mesh"]["rank"] != 0:  # rank 0 prints the run
        return
    t = out["timings"]
    gen, slots = out["generated"], out["slots"]
    n_seqs, P = args.batch, args.prompt_len
    dec_toks = sum(len(g) for g in gen) - n_seqs  # prefill emits token 1
    print(f"warm-up: prefill {t['compile_prefill_s']*1e3:.1f} ms | "
          f"decode {t['compile_decode_s']*1e3:.1f} ms (untimed; kernel build "
          f"and first launches, excluded from throughput)")
    print(f"prefill: {n_seqs}x{P} tokens in {t['prefill_s']*1e3:.1f} ms "
          f"({n_seqs * P / max(t['prefill_s'], 1e-9):.0f} tok/s, "
          f"{slots} slots/wave)")
    print(f"decode: {dec_toks} tokens over {out['steps']} steps in "
          f"{t['decode_s']*1e3:.1f} ms "
          f"({dec_toks / max(t['decode_s'], 1e-9):.0f} tok/s) | "
          f"{out['admissions']} admissions (+{t['admit_s']*1e3:.1f} ms "
          f"KV streaming, of which {t['admit_stall_s']*1e3:.1f} ms stalled "
          f"waiting on reads the decode overlap did not cover)")
    kvm = out["kv"]
    print(f"kv[{out['kv_tier']}]: resident {kvm['resident_bytes']} B | "
          f"in {kvm['in_bytes']} B | out {kvm['out_bytes']} B | "
          f"pinned peak {kvm['pinned_peak_bytes']} B "
          f"(budget {kvm['pinned_budget_bytes']} B)")
    msh = out["mesh"]
    if msh["world"] > 1:
        print(f"mesh: {msh['world']} ranks ({msh['data']} x {msh['model']}, "
              f"{msh['backend']}, {msh['strategy'] or 'dp'}), "
              + (f"{msh['local_slots']} slots a data rank" if msh["slots_split"] else
                 f"{slots} slots do not divide: every data rank serves all, data row 0's "
                 "counters")
              + f" | param_shard_bytes {out['param_shard_bytes']} | peak allocated "
              f"{out['peak_allocated_bytes']} B | decode step "
              f"{t['decode_s'] / max(out['steps'], 1) * 1e3:.1f} ms")
        if msh["strategy"] == "cp":
            print(f"cp: decode cache "
                  + (f"split, {msh['local_cache_len']} positions a rank"
                     if msh["cache_seq_split"] else
                     f"whole on every rank ({msh['local_cache_len']} positions do not split)")
                  + f" | {msh['model_gather_bytes_per_step']} param bytes gathered over the "
                  "model axis a decode step a rank")
        for r, kr in enumerate(out["kv_ranks"]):
            print(f"kv rank {r}: in {kr['in_bytes']} B | out {kr['out_bytes']} B | "
                  f"resident {kr['resident_bytes']} B | "
                  f"{out['admissions_ranks'][r]} admissions")
    lat = out["latency"]
    ttft_p, tok_p = lat["ttft"], lat["decode_token"]
    print(f"latency: TTFT p50/p95/p99 = {ttft_p['p50']*1e3:.1f}/"
          f"{ttft_p['p95']*1e3:.1f}/{ttft_p['p99']*1e3:.1f} ms | "
          f"decode tok p50/p95/p99 = {tok_p['p50']*1e3:.2f}/"
          f"{tok_p['p95']*1e3:.2f}/{tok_p['p99']*1e3:.2f} ms "
          f"({len(lat['decode_token_s'])} tokens)")
    print(f"kernels: launches {ops.launch_counts()}")
    if args.trace:
        trace.export_chrome(args.trace)
        print(f"trace: wrote {args.trace} "
              f"({len(trace.TRACER.events())} spans)")
    for s in range(min(n_seqs, 4)):
        print(f"slot {s}: {gen[s][:16]}")

    if args.smoke:
        if not all(out["done"]):
            raise SystemExit("SERVE SMOKE FAIL: decode did not complete "
                             f"(done={out['done']})")
        for s, g in enumerate(gen):
            if args.eos_id in g and g.index(args.eos_id) != len(g) - 1:
                raise SystemExit(
                    f"SERVE SMOKE FAIL: seq {s} has tokens after EOS: {g}")
            if len(g) > args.new_tokens:
                raise SystemExit(
                    f"SERVE SMOKE FAIL: seq {s} exceeded the "
                    f"{args.new_tokens}-token budget: {len(g)}")
        plan = out["plan"]
        if plan is not None and "kv_resident_bytes" in plan.predictions:
            pred = plan.predictions["kv_resident_bytes"]
            if kvm["resident_bytes"] > pred:
                raise SystemExit(
                    f"SERVE SMOKE FAIL: measured device KV "
                    f"{kvm['resident_bytes']} B > planned {pred:.0f} B")
        for r, kr in enumerate(out["kv_ranks"]):
            if kr["pinned_peak_bytes"] > kr["pinned_budget_bytes"]:
                raise SystemExit(
                    f"SERVE SMOKE FAIL: rank {r}'s pinned staging "
                    f"{kr['pinned_peak_bytes']} B exceeded the "
                    f"{kr['pinned_budget_bytes']} B budget")
        for which in ("ttft", "decode_token"):
            p = lat[which]
            if p["p50"] > p["p99"]:
                raise SystemExit(
                    f"SERVE SMOKE FAIL: {which} latency percentiles "
                    f"inverted: p50 {p['p50']*1e3:.2f} ms > "
                    f"p99 {p['p99']*1e3:.2f} ms")
        print(f"SERVE SMOKE OK: {n_seqs} seqs through {slots} "
              f"{out['kv_tier']}-tier slots, {out['steps']} steps, "
              f"{out['admissions']} admissions, EOS-masked, "
              + ("KV residency within plan, " if out["plan"] is not None else "")
              + f"latency percentiles sane (decode tok p50 {tok_p['p50']*1e3:.2f} ms)")


if __name__ == "__main__":
    main()
