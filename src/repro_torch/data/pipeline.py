"""Deterministic synthetic data pipeline with prefetch (``repro/data/pipeline.py``).

``batch(step)`` is a pure function of (seed, step, specs), drawn with
numpy exactly as the reference draws it, so both packages train on the
same batches bit for bit. A background thread builds the next batches
while the device computes; the loader places each on the run's device.
With ``dp`` data-parallel ranks the loader hands rank r its rows of each
global batch (``rank_batch``), the reference's batch placement: the rows
``[r * B/dp, (r+1) * B/dp)`` (``rank_slice``, ``P(axis, None)``) where B
splits over the ranks, the whole batch on every rank where it does not
(the reference's divisibility guard, ``repro/core/engine.py:106-121``);
under ``accum`` microbatches, the rank's rows of each microbatch in turn,
so its local microbatch i is its part of the global microbatch i.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch


class SyntheticStream:
    """Shape-driven synthetic batches from ``specs`` (name -> ``TensorSpec``):
    int leaves are token ids, float leaves unit-normal * 0.1 embeddings."""

    def __init__(self, specs: Dict[str, object], vocab_size: int, seed: int = 0):
        self.specs = specs
        self.vocab = max(vocab_size, 2)
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        out = {}
        for i, (k, v) in enumerate(sorted(self.specs.items())):
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, i]))
            if not v.dtype.is_floating_point:
                # learnable synthetic language: per-row linear-congruential
                # sequences (the next token is a function of the current one)
                B = v.shape[0]
                T = int(np.prod(v.shape[1:])) if len(v.shape) > 1 else 1
                V = min(self.vocab, 997)
                start = rng.integers(0, V, (B, 1))
                stride = rng.integers(1, 7, (B, 1))
                seqs = (start + stride * np.arange(T)[None, :]) % V
                out[k] = seqs.reshape(v.shape).astype(np.int32)
            else:
                out[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        if "labels" in out and "tokens" in out and out["labels"].shape == out["tokens"].shape:
            out["labels"] = out["tokens"]  # the LM objective: the loss shifts
        return out


def rank_slice(batch: Dict[str, np.ndarray], rank: int, dp: int) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s rows ``[r * B/dp, (r+1) * B/dp)`` of every leaf of a
    global batch (B a multiple of dp, as the reference's sharding needs)."""
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % dp:
            raise ValueError(f"batch {k}: {B} rows do not split over {dp} ranks")
        out[k] = v[rank * (B // dp):(rank + 1) * (B // dp)]
    return out


def rank_batch(batch: Dict[str, np.ndarray], rank: int, dp: int,
               accum: int = 1) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s rows of a global batch among ``dp`` ranks: with
    B a multiple of ``dp * accum``, its ``rank_slice`` of each of the
    ``accum`` microbatches (the global batch's rows in ``accum``
    consecutive runs), concatenated in microbatch order; otherwise the
    whole batch, which every rank then holds (the engines scale their
    loss by 1/dp, exact either way)."""
    B = next(iter(batch.values())).shape[0]
    if dp == 1 or B % (dp * accum):
        return batch
    out = {}
    for k, v in batch.items():
        micro = v.reshape((accum, B // accum) + v.shape[1:])
        mine = rank_slice({k: np.swapaxes(micro, 0, 1)}, rank, dp)[k]
        out[k] = np.ascontiguousarray(np.swapaxes(mine, 0, 1)).reshape(
            (B // dp,) + v.shape[1:])
    return out


class PrefetchLoader:
    """Iterates ``(step, batch)`` for steps [start, end) with a
    ``depth``-deep background prefetch; each batch's tensors land on
    ``device`` in their spec's dtype, rank ``rank``'s rows of it among
    ``dp`` ranks (``rank_batch`` over ``accum`` microbatches)."""

    def __init__(self, stream: SyntheticStream, start_step: int, end_step: int,
                 device="cpu", depth: int = 2, rank: int = 0, dp: int = 1,
                 accum: int = 1):
        self.stream = stream
        self.rank, self.dp, self.accum = rank, dp, accum
        self.start, self.end = start_step, end_step
        self.device = torch.device(device)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        for step in range(self.start, self.end):
            batch = self.stream.batch_at(step)
            self.q.put((step, rank_batch(batch, self.rank, self.dp, self.accum)))
        self.q.put(None)

    def __iter__(self) -> Iterator:
        while True:
            item = self.q.get()
            if item is None:
                return
            step, batch = item
            yield step, {k: torch.from_numpy(v).to(self.device, self.stream.specs[k].dtype)
                         for k, v in batch.items()}
