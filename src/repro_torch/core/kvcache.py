"""Paged KV-cache blocks through the tier hierarchy, ported from
``repro/core/kvcache.py`` (serving-side paper Secs. 3-4).

  * ``pad_seq_caches`` / ``grow_cache`` — grow dense-style K/V leaves along
    the sequence axis to decode capacity, leaving everything else alone.
  * ``sequence_kv_bytes`` — one sequence's cache bytes from the family's
    ``cache_defs`` (the planner's KV arithmetic).
  * ``PagedKVCache`` — per-sequence KV state parked in an ``ArrayStore``
    tier (host DRAM or NVMe) as fixed-size token blocks along the cache's
    sequence axis; only ``ceil(len/block)`` blocks of live tokens move, and
    fetching streams them back through a bounded read-ahead window.

A cache is a nested dict of tensors with a top-level ``len``: flat for
the dense, VLM, MoE, enc-dec and SSM families (``k``/``v``, enc-dec's
``xk``/``xv`` beside them, or mamba2's conv tails and ``state``), nested
for the hybrid (``groups/rec1/h``, ``groups/attn/k``, ``tail/rec/conv``,
...). The reference walks a pytree by path; here a leaf's name is its key
path joined by ``/``. A pageable leaf is a 5-dim ``(layers, batch, seq,
kv_heads, head_dim)`` tensor whose last key is in ``seq_axis_names``
(``k``/``v``); every other leaf (enc-dec's cross-attention ``xk``/``xv``,
an SSM state, a conv tail, a window-bounded K/V ring) is parked whole and
never grows: the cross keys' length is the encoder's, and zero-padded
ones would get attention weight. The batch axis of every non-scalar leaf
is axis 1. On data-parallel ranks each rank keeps its own
``PagedKVCache`` over its own store (``launch/serve.py``), so its byte
counters are the rank's. Under context parallelism a model rank keeps and
parks its own range of each sequence's positions (``seq_split``,
``decode_positions``), so the ranks' counters sum to one cache's. A
fixed-state cache on a model axis (the SSM, the hybrid) is the rank's
``inner`` channels and the leaves every model rank holds whole: each rank
parks its own, so the ranks' counters hold the whole leaves once a rank.
"""
from __future__ import annotations

import collections
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import partition as pt
from repro_torch.core.offload import ArrayStore
from repro_torch.runtime import trace

SEQ_AXIS = 2  # (layers, batch, seq, kv_heads, head_dim)
BATCH_AXIS = 1

# families whose decode cache grows along a sequence axis
SEQ_CACHE_FAMILIES = ("dense", "moe", "vlm", "encdec")
# the encoder-decoder's cross-attention keys and values: the memory's
# positions, parked whole, never grown
CROSS_NAMES = ("xk", "xv")


def _is_seq_leaf(name: str, leaf, seq_axis_names) -> bool:
    return name in seq_axis_names and isinstance(leaf, torch.Tensor) and leaf.dim() == 5


def pad_seq_caches(cache: dict, extra: int,
                   seq_axis_names: Tuple[str, ...] = ("k", "v")) -> dict:
    """Grow 5-dim ``k``/``v`` leaves by ``extra`` zero slots along the seq
    axis (new tensors); other leaves (enc-dec's ``xk``/``xv`` among them)
    pass through."""
    if extra <= 0:
        return cache
    return {name: (F.pad(leaf, (0, 0, 0, 0, 0, extra))
                   if _is_seq_leaf(name, leaf, seq_axis_names) else leaf)
            for name, leaf in cache.items()}


def grow_cache(cache: dict, extra: int, family: str) -> dict:
    """Serve-driver growth: seq-cache families pad K/V to decode capacity;
    fixed-state families pass through unchanged."""
    if family in SEQ_CACHE_FAMILIES:
        return pad_seq_caches(cache, extra)
    return cache


def seq_split(capacity: int, model: int) -> bool:
    """Whether a decode cache of ``capacity`` positions splits over
    ``model`` context-parallel ranks, each holding ``capacity / model``:
    the reference's divisibility guard on ``cache_seq``."""
    return model > 1 and capacity % model == 0


def decode_positions(cache: dict, mp, capacity: int) -> Tuple[dict, int, int, bool]:
    """A prefill's cache -> ``(the cache of the prompt positions this rank
    keeps for decode, how many, the rank's cache capacity, whether the
    positions split over the model ranks)``: the serving driver's slot
    cache is it grown by ``capacity - how many`` (``grow_cache``), and a
    waiting sequence parks those positions. Under context parallelism
    (``mp`` not tensor-parallel; its cache's ``k`` / ``v`` the rank's chunk
    of the prompt's ``len`` positions, or all of them) the positions are
    the rank's range ``[m * C/M, (m+1) * C/M)`` of the ``capacity`` C where
    it splits (``seq_split``), else every one; a chunked prefill's are
    all-gathered over the model ranks first (one collective), so they move
    to their owners once. The encoder-decoder's cross-attention keys and
    values (``xk`` / ``xv``, the reference's ``cache_seq`` on ``model``
    too) split with them: where C and the memory's E positions both
    divide by M, rank m keeps the memory's ``[m * E/M, (m+1) * E/M)`` (a
    chunked prefill's own chunk) and decode combines the ranks' partial
    softmaxes over it; where either does not, every rank keeps the whole
    cache, ``xk`` / ``xv`` gathered with ``k`` / ``v``. Elsewhere the
    cache is every rank's as it is, and so is a cache without top-level
    ``k`` / ``v`` (the SSM's and the hybrid's fixed state: their ``inner``
    leaves are the rank's already, the rest whole on every model rank)."""
    P = int(cache["len"])
    if mp is None or mp.tp or "k" not in cache:
        return cache, P, capacity, False
    M = mp.size
    chunked = cache["k"].shape[SEQ_AXIS] < P
    cross = [n for n in CROSS_NAMES if n in cache]
    E = cache[cross[0]].shape[SEQ_AXIS] * (M if chunked else 1) if cross else 0
    split = seq_split(capacity, M) and E % M == 0
    out = dict(cache)
    gather = (["k", "v"] + ([] if split else cross)) if chunked else []
    if gather:
        leaves = mp.mesh.all_gather_leaves([(cache[n], SEQ_AXIS) for n in gather], "model")
        out.update(zip(gather, leaves))
    if split:
        capacity //= M
        lo = mp.rank * capacity
        for n in ("k", "v"):
            out[n] = out[n][:, :, lo:max(lo, min(lo + capacity, P))]
        if not chunked:
            n = E // M
            out.update({c: out[c][:, :, mp.rank * n:(mp.rank + 1) * n].contiguous()
                        for c in cross})
    return out, out["k"].shape[SEQ_AXIS], capacity, split


def sequence_kv_bytes(model, cache_len: int, cache_defs=None) -> int:
    """Bytes of ONE sequence's decode cache at ``cache_len`` context,
    summed over the family's ``cache_defs`` leaves (``cache_defs``: a
    bundle's, e.g. a model rank's; default the whole model's)."""
    from repro_torch.models import registry

    defs = (cache_defs or registry.build(model).cache_defs)(1, cache_len)
    return sum(math.prod(d.shape) * d.torch_dtype.itemsize
               for d in pt.tree_leaves(defs))


def device_kv_bytes(cache: dict) -> int:
    """Resident bytes of a live cache (every tensor leaf, ``len`` included)."""
    return int(sum(t.numel() * t.element_size() for t in pt.tree_leaves(cache)
                   if isinstance(t, torch.Tensor)))


def default_block_tokens(cache_len: int) -> int:
    """~1/8 of the context rounded up to a power of two, in [16, 1024]."""
    if cache_len <= 16:
        return 16
    target = max(16, cache_len // 8)
    return int(min(1024, 1 << math.ceil(math.log2(target))))


class PagedKVCache:
    """Per-sequence KV state parked as fixed-size blocks in an ArrayStore.

    ``park(seq_id, cache, length)`` slices a single-sequence cache (batch
    dim 1) into ``ceil(length/block_tokens)`` blocks along the seq axis for
    pageable leaves and whole tensors for the rest, written asynchronously.
    ``start_fetch``/``fetch`` stream the blocks back with at most
    ``prefetch_blocks`` reads in flight and reassemble the cache zero-padded
    to ``cache_len`` capacity. ``drop`` deletes a finished sequence's blocks.
    """

    def __init__(self, store: ArrayStore, *, block_tokens: int,
                 seq_axis_names: Tuple[str, ...] = ("k", "v"),
                 prefetch_blocks: int = 2):
        if block_tokens < 1:
            raise ValueError(f"block_tokens={block_tokens}: must be >= 1")
        self.store = store
        self.block_tokens = int(block_tokens)
        self.seq_axis_names = tuple(seq_axis_names)
        self.prefetch_blocks = max(1, int(prefetch_blocks))
        # seq_id -> (length, [(name, n_blocks_or_0, shape)], bytes)
        self._layout: Dict[str, tuple] = {}

    def n_blocks(self, length: int) -> int:
        return max(1, -(-int(length) // self.block_tokens))

    def park(self, seq_id: str, cache: dict, length: int) -> int:
        """Write one sequence's cache (batch dim 1); padding past ``length``
        on the seq axis is not shipped. Returns bytes written. Asynchronous
        (``flush()`` or the next fetch commits): the caller must not write
        into the cache's tensors afterwards."""
        entries: List[tuple] = []
        nbytes = 0
        bt = self.block_tokens
        for path in pt.tree_paths(cache):
            leaf, name = pt.tree_get(cache, path), "/".join(path)
            if _is_seq_leaf(path[-1], leaf, self.seq_axis_names):
                nb = self.n_blocks(length)
                for i in range(nb):
                    blk = leaf[:, :, i * bt: min((i + 1) * bt, int(length))]
                    self.store.write(f"{seq_id}/{name}/b{i}", blk)
                    nbytes += blk.numel() * blk.element_size()
                entries.append((name, nb, tuple(leaf.shape)))
            else:
                self.store.write(f"{seq_id}/{name}/full", leaf)
                nbytes += leaf.numel() * leaf.element_size()
                entries.append((name, 0, tuple(leaf.shape)))
        self._layout[seq_id] = (int(length), entries, nbytes)
        trace.instant("kv_park", sys="kv", cls="kv", unit=seq_id,
                      nbytes=nbytes, length=int(length))
        return nbytes

    def start_fetch(self, seq_id: str, cache_len: int) -> "KVFetchHandle":
        """Begin a windowed read-back without blocking."""
        length, entries, _ = self._layout[seq_id]
        self.store.flush()  # a fetch racing its own park must see the blocks
        work = []
        for name, nb, _shape in entries:
            if nb:
                work.extend((name, f"{seq_id}/{name}/b{i}") for i in range(nb))
            else:
                work.append((name, f"{seq_id}/{name}/full"))
        return KVFetchHandle(self, length, entries, work, cache_len)

    def fetch(self, seq_id: str, cache_len: int):
        """Blocking read-back: ``(cache of host tensors, nested as it was
        parked, length)`` with seq leaves zero-padded to ``cache_len``."""
        return self.start_fetch(seq_id, cache_len).result()

    def drop(self, seq_id: str) -> None:
        """Forget a sequence and delete its blocks from the slow tier."""
        rec = self._layout.pop(seq_id, None)
        if rec is None:
            return
        for name, nb, _shape in rec[1]:
            if nb:
                for i in range(nb):
                    self.store.delete(f"{seq_id}/{name}/b{i}")
            else:
                self.store.delete(f"{seq_id}/{name}/full")

    def parked_bytes(self) -> int:
        return sum(rec[2] for rec in self._layout.values())

    def parked_seqs(self) -> List[str]:
        return list(self._layout)

    def flush(self) -> None:
        self.store.flush()

    def mark(self) -> dict:
        return self.store.mark()

    def delta_since(self, mark: dict) -> dict:
        return self.store.delta_since(mark)


class KVFetchHandle:
    """One parked sequence's in-flight fetch (see ``start_fetch``): reads
    stream through the store's workers with at most ``prefetch_blocks`` in
    flight; ``poll()`` refills the window without blocking, ``result()``
    blocks for the remainder and assembles the cache."""

    def __init__(self, cache: PagedKVCache, length: int, entries, work,
                 cache_len: int):
        self._kv = cache
        self.length = int(length)
        self._entries = entries
        self._work = work
        self._cache_len = int(cache_len)
        self._parts: Dict[str, List[torch.Tensor]] = collections.defaultdict(list)
        self._inflight: collections.deque = collections.deque()
        self._wi = 0
        self._out = None
        self._issue()

    def _issue(self) -> None:
        while (self._wi < len(self._work)
               and len(self._inflight) < self._kv.prefetch_blocks):
            name, key = self._work[self._wi]
            self._inflight.append((name, self._kv.store.read(key)))
            self._wi += 1

    def poll(self) -> None:
        """Harvest completed reads and keep the window full — never blocks."""
        while self._inflight and self._inflight[0][1].done():
            name, fut = self._inflight.popleft()
            self._parts[name].append(fut.result())
            self._issue()

    def done(self) -> bool:
        self.poll()
        return self._wi >= len(self._work) and not self._inflight

    def result(self):
        """Block for the uncovered remainder; returns ``(cache, length)``."""
        if self._out is not None:
            return self._out
        if self._inflight:
            with trace.span("kv_fetch_wait", sys="kv", attr="io_wait",
                            cls="kv") as sp:
                n = 0
                while self._inflight:
                    name, fut = self._inflight.popleft()
                    self._parts[name].append(fut.result())
                    self._issue()
                    n += 1
                sp.set(n_blocks=n)
        out = {}
        for name, nb, shape in self._entries:
            if nb:
                t = torch.cat(self._parts[name], dim=SEQ_AXIS)
                pad = self._cache_len - t.shape[SEQ_AXIS]
                if pad > 0:
                    t = F.pad(t, (0, 0, 0, 0, 0, pad))
                elif pad < 0:
                    t = t[:, :, :self._cache_len]
            else:
                t = self._parts[name][0].reshape(shape)
            pt.tree_set(out, tuple(name.split("/")), t)
        self._out = (out, self.length)
        return self._out


def slice_sequence(cache: dict, b: int) -> dict:
    """Sequence ``b`` of a batched cache as batch-1 views, nested as the
    cache is. The top-level ``len`` leaf becomes a 0-d int32 zero on the
    cache's device, as in the reference: a structural placeholder that
    ``park`` ships as ``.../len/full`` and unpark never consults (the
    paging layout tracks each sequence's length)."""
    out = pt.tree_map(lambda leaf: leaf[:, b: b + 1],
                      {name: sub for name, sub in cache.items() if name != "len"})
    if "len" in cache:
        out["len"] = torch.zeros((), dtype=torch.int32, device=cache["len"].device)
    return out
