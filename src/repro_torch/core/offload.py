"""The out-of-graph offload tiers (paper Secs. 5.1.1, 5.2.2, 6.3), ported
from ``repro/core/offload.py``.

  * ``PinnedBufferPool`` — a fixed, reused budget of host staging buffers
    (``torch.uint8`` tensors, page-locked with ``pin_memory=True`` on the
    card path, where they make host<->device copies direct DMA).
  * ``ArrayStore`` — the async key->tensor store with bandwidth counters
    (cumulative ``bandwidth_stats``, per-step ``mark``/``delta_since``).
      - ``HostArrayStore``: tensors resident in host DRAM;
      - ``NvmeStore``: file-backed, same on-disk format as the JAX package
        (hashed ``.bin`` + JSON ``.meta`` sidecar, dtype names such as
        ``"bfloat16"``), so either package reopens the other's directory.

  * ``ChunkedAdamOffload`` — the slow-tier optimizer step: master/m/v
    stream store -> host in chunks, read(k+1) || CPU update(k) ||
    write(k-1); the update is ``_adam_update`` on CPU tensors, in place
    (the DeepSpeed CPU-Adam analogue).
  * ``ParamStreamer`` — slow-tier resident bf16 rows, one per layer, read
    and written asynchronously for the layer scheduler.
  * ``PinnedStager`` — host rows to the card through pinned pool buffers
    with non-blocking copies; a buffer returns to the pool only after its
    copy's event completed.

Stores hold torch tensors, not numpy arrays: numpy has no bfloat16 without
``ml_dtypes``, which the port does not use. A tensor handed to ``write`` or
``roundtrip`` may live on the card; its device->host copy runs on the
store's worker thread (``roundtrip``'s after the ``ready`` event the caller
recorded behind the kernels that produce it).
"""
from __future__ import annotations

import collections
import hashlib
import json
import math
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.core.qformat import dtype_from_name, dtype_name
from repro_torch.runtime import trace

DEFAULT_CHUNK_ELEMS = 1 << 22  # 4M elements per pipeline chunk


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class PinnedBufferPool:
    """Reusable host buffers under a fixed byte budget.

    Buffers are recycled by (rounded) size class; acquiring beyond the budget
    blocks until a buffer is released — backpressure instead of
    fragmentation. The budget bounds *resident* bytes: buffers handed out
    plus buffers cached for reuse. A single request larger than the whole
    budget is still honoured once no other buffer is outstanding.
    """

    def __init__(self, budget_bytes: int, pin: bool = False):
        self.budget = budget_bytes
        self.pin = pin
        self._lock = threading.Condition()
        self._free: Dict[int, List[torch.Tensor]] = {}
        self._outstanding = 0
        self._resident = 0  # outstanding + cached free bytes
        self.peak_outstanding = 0
        self.peak_resident = 0

    @staticmethod
    def _size_class(nbytes: int) -> int:
        return 1 << max(12, math.ceil(math.log2(max(nbytes, 1))))

    def _drop_free(self, need_bytes: int) -> None:
        """Drop cached buffers (any class) until ``need_bytes`` are freed."""
        for cls in sorted(self._free, reverse=True):
            bucket = self._free[cls]
            while bucket and need_bytes > 0:
                bucket.pop()
                self._resident -= cls
                need_bytes -= cls
            if not bucket:
                del self._free[cls]
            if need_bytes <= 0:
                return

    def acquire(self, nbytes: int) -> torch.Tensor:
        cls = self._size_class(nbytes)
        with self._lock:
            while True:
                bucket = self._free.get(cls)
                if bucket:
                    buf = bucket.pop()
                    break  # recycled: resident bytes unchanged
                if self._resident + cls > self.budget:
                    self._drop_free(self._resident + cls - self.budget)
                if self._resident + cls <= self.budget or self._outstanding == 0:
                    buf = torch.empty(cls, dtype=torch.uint8, pin_memory=self.pin)
                    self._resident += cls
                    break
                # genuine backpressure: the fixed pinned supply is exhausted
                with trace.span("pinned_pool_wait", sys="store", nbytes=nbytes):
                    self._lock.wait(timeout=10.0)
            self._outstanding += cls
            self.peak_outstanding = max(self.peak_outstanding, self._outstanding)
            self.peak_resident = max(self.peak_resident, self._resident)
        return buf

    def release(self, buf: torch.Tensor) -> None:
        cls = _nbytes(buf)
        with self._lock:
            self._free.setdefault(cls, []).append(buf)
            self._outstanding -= cls
            self._lock.notify_all()


def _staged(buf: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """The first bytes of a pool buffer viewed as a tensor of dtype/shape."""
    n = math.prod(shape) * dtype.itemsize
    return buf[:n].view(dtype).reshape(shape)


class ArrayStore:
    """Async key->tensor store with bandwidth accounting (DeepNVMe analogue).

    write(key, t) / read(key) return futures; flush() synchronizes writes.
    Counters are cumulative over the store's lifetime (``bandwidth_stats``);
    per-step deltas come from ``mark()`` + ``delta_since(mark)``.
    """

    kind = "abstract"
    # state class this store carries ("kv", ...); tags every I/O span
    trace_cls: Optional[str] = None

    def __init__(self, pool: Optional[PinnedBufferPool] = None, pool_mb: int = 64,
                 workers: int = 2, overlap: bool = True):
        self.pool = pool if pool is not None else PinnedBufferPool(pool_mb << 20)
        self.overlap = overlap
        self._pool_exec = ThreadPoolExecutor(max_workers=workers) if overlap else None
        self._stat_lock = threading.Lock()
        self.bytes_read = 0
        self.bytes_written = 0
        self.read_time = 0.0
        self.write_time = 0.0
        self._pending: List[Future] = []

    # -- accounting ---------------------------------------------------------

    def _count_read(self, nbytes: int, dt: float) -> None:
        with self._stat_lock:
            self.bytes_read += nbytes
            self.read_time += dt

    def _count_write(self, nbytes: int, dt: float) -> None:
        with self._stat_lock:
            self.bytes_written += nbytes
            self.write_time += dt

    def bandwidth_stats(self) -> dict:
        with self._stat_lock:
            return {
                "read_gbps": self.bytes_read / max(self.read_time, 1e-9) / 1e9,
                "write_gbps": self.bytes_written / max(self.write_time, 1e-9) / 1e9,
                "bytes_read": self.bytes_read,
                "bytes_written": self.bytes_written,
                # a plain store moves its arrays as they are: logical ==
                # wire (``qformat.QuantizedArrayStore`` splits them)
                "logical_bytes_read": self.bytes_read,
                "logical_bytes_written": self.bytes_written,
                "read_time": self.read_time,
                "write_time": self.write_time,
                "pinned_peak_bytes": self.pool.peak_resident,
            }

    def mark(self) -> dict:
        """Counter snapshot; pass to ``delta_since`` for per-step stats."""
        with self._stat_lock:
            return {"bytes_read": self.bytes_read, "bytes_written": self.bytes_written,
                    "logical_bytes_read": self.bytes_read,
                    "logical_bytes_written": self.bytes_written,
                    "read_time": self.read_time, "write_time": self.write_time}

    def delta_since(self, mark: dict) -> dict:
        with self._stat_lock:
            br = self.bytes_read - mark["bytes_read"]
            bw = self.bytes_written - mark["bytes_written"]
            rt = self.read_time - mark["read_time"]
            wt = self.write_time - mark["write_time"]
        return {"bytes_read": br, "bytes_written": bw,
                "logical_bytes_read": br, "logical_bytes_written": bw,
                "read_gbps": br / max(rt, 1e-9) / 1e9,
                "write_gbps": bw / max(wt, 1e-9) / 1e9}

    # -- sync backends (implemented by subclasses) --------------------------

    def _write_sync(self, key: str, t: torch.Tensor) -> None:
        raise NotImplementedError

    def _read_sync(self, key: str) -> torch.Tensor:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        """Remove a key (idempotent). Synchronous and uncounted."""
        raise NotImplementedError

    # -- traced sync wrappers (the span is where the bytes move) ------------

    def _traced_write(self, key: str, t: torch.Tensor, ready=None) -> None:
        attr = "io" if self.overlap else "io_wait"
        with trace.span(f"{self.kind}_write", sys="store", attr=attr,
                        cls=self.trace_cls, key=key) as sp:
            sp.set(nbytes=_nbytes(t), wire_bytes=_nbytes(t))
            if ready is not None:
                # the kernels that write t were only enqueued: wait for them
                # before the copy reads it (else a half-written tensor)
                ready.synchronize()
            self._write_sync(key, t.detach())

    def _traced_read(self, key: str) -> torch.Tensor:
        attr = "io" if self.overlap else "io_wait"
        with trace.span(f"{self.kind}_read", sys="store", attr=attr,
                        cls=self.trace_cls, key=key) as sp:
            out = self._read_sync(key)
            sp.set(nbytes=_nbytes(out), wire_bytes=_nbytes(out))
            return out

    # -- async API ----------------------------------------------------------

    def write(self, key: str, t: torch.Tensor, ready=None) -> Future:
        """Async write. ``t`` may be a CUDA tensor: the device->host copy
        runs on the worker thread, not the caller, after ``ready`` (an
        event recorded behind the kernels that produce ``t``) completes.
        The caller must not write into ``t`` until the future resolves
        (``flush``)."""
        if not self.overlap:
            f: Future = Future()
            f.set_result(self._traced_write(key, t, ready))
            return f
        fut = self._pool_exec.submit(self._traced_write, key, t, ready)
        self._pending.append(fut)
        return fut

    def read(self, key: str) -> Future:
        if not self.overlap:
            f: Future = Future()
            f.set_result(self._traced_read(key))
            return f
        return self._pool_exec.submit(self._traced_read, key)

    def roundtrip(self, key: str, t: torch.Tensor, ready=None) -> Future:
        """Drain ``t`` into the store and resolve to the store-resident copy:
        an ordered write-then-read on one worker (the grad-tier leg of the
        overlap-centric schedule). ``t`` may be a CUDA tensor: the worker
        copies it after ``ready`` (a ``torch.cuda.Event`` recorded behind
        the kernels that produce ``t``) completes."""
        if not self.overlap:
            f: Future = Future()
            self._traced_write(key, t, ready)
            f.set_result(self._traced_read(key))
            return f

        def _rt():
            self._traced_write(key, t, ready)
            return self._traced_read(key)

        fut = self._pool_exec.submit(_rt)
        self._pending.append(fut)
        return fut

    def close(self) -> None:
        """Synchronize pending writes and stop the worker threads."""
        self.flush()
        if self._pool_exec is not None:
            self._pool_exec.shutdown(wait=True)

    def flush(self) -> None:
        if not self._pending:
            return
        with trace.span(f"{self.kind}_flush", sys="store", attr="io_wait",
                        cls=self.trace_cls, n_pending=len(self._pending)):
            for f in self._pending:
                f.result()
            self._pending.clear()

    def keys(self):
        raise NotImplementedError


class HostArrayStore(ArrayStore):
    """Host-DRAM tier: tensors live in host memory, staged through the
    shared buffer pool."""

    kind = "host"

    def __init__(self, pool: Optional[PinnedBufferPool] = None, pool_mb: int = 64,
                 workers: int = 2, overlap: bool = True):
        super().__init__(pool=pool, pool_mb=pool_mb, workers=workers, overlap=overlap)
        self._data: Dict[str, torch.Tensor] = {}
        self._data_lock = threading.Lock()

    def _write_sync(self, key: str, t: torch.Tensor) -> None:
        t0 = time.perf_counter()
        n = _nbytes(t)
        buf = self.pool.acquire(max(n, 1))
        staged = _staged(buf, t.dtype, t.shape)
        staged.copy_(t)  # device->host staging through the pool
        resident = staged.clone()  # the host-resident copy outlives the buffer
        self.pool.release(buf)
        with self._data_lock:
            self._data[key] = resident
        self._count_write(n, time.perf_counter() - t0)

    def _read_sync(self, key: str) -> torch.Tensor:
        t0 = time.perf_counter()
        with self._data_lock:
            src = self._data[key]
        out = src.clone()
        self._count_read(_nbytes(out), time.perf_counter() - t0)
        return out

    def delete(self, key: str) -> None:
        with self._data_lock:
            self._data.pop(key, None)

    def keys(self):
        with self._data_lock:
            return list(self._data)


class NvmeStore(ArrayStore):
    """Async file-backed tensor store (DeepNVMe analogue).

    Filenames are content-addressed from the key (sanitized prefix + md5),
    so overlapping key namespaces never collide on disk. Per-key metadata
    persists in a ``.meta`` sidecar committed with the data file;
    reopening a store on the same directory serves all flushed keys.
    """

    kind = "nvme"

    def __init__(self, directory: str, pool_mb: int = 64, workers: int = 2,
                 overlap: bool = True, pool: Optional[PinnedBufferPool] = None):
        super().__init__(pool=pool, pool_mb=pool_mb, workers=workers, overlap=overlap)
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._meta: Dict[str, Tuple[tuple, str]] = {}
        self._meta_lock = threading.Lock()
        self._reopen()

    def _reopen(self) -> None:
        for name in os.listdir(self.dir):
            if not name.endswith(".meta"):
                continue
            try:
                with open(os.path.join(self.dir, name)) as f:
                    rec = json.load(f)
                self._meta[rec["key"]] = (tuple(rec["shape"]), rec["dtype"])
            except (OSError, ValueError, KeyError):
                continue  # partial sidecar from a crash mid-write: skip

    def _fname(self, key: str) -> str:
        safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in key)[:48]
        return f"{safe}-{hashlib.md5(key.encode()).hexdigest()[:12]}"

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, self._fname(key) + ".bin")

    def _meta_path(self, key: str) -> str:
        return os.path.join(self.dir, self._fname(key) + ".meta")

    def _write_sync(self, key: str, t: torch.Tensor) -> None:
        t0 = time.perf_counter()
        n = _nbytes(t)
        buf = self.pool.acquire(max(n, 1))
        staged = _staged(buf, t.dtype, t.shape)
        staged.copy_(t)  # host staging copy through the pool
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(buf[:n].numpy().data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(key))
        meta = (tuple(t.shape), dtype_name(t.dtype))
        with self._meta_lock:
            meta_stale = self._meta.get(key) != meta
            self._meta[key] = meta
        if meta_stale:  # sidecar only on first write / layout change
            mtmp = self._meta_path(key) + ".tmp"
            with open(mtmp, "w") as f:
                json.dump({"key": key, "shape": list(t.shape),
                           "dtype": meta[1]}, f)
            os.replace(mtmp, self._meta_path(key))
        self.pool.release(buf)
        self._count_write(n, time.perf_counter() - t0)

    def _read_sync(self, key: str) -> torch.Tensor:
        t0 = time.perf_counter()
        with self._meta_lock:
            shape, name = self._meta[key]
        dtype = dtype_from_name(name)
        n = math.prod(shape) * dtype.itemsize
        buf = self.pool.acquire(max(n, 1))
        with open(self._path(key), "rb") as f:
            got = f.readinto(buf[:n].numpy())
        if got != n:
            self.pool.release(buf)
            raise OSError(f"{self._path(key)}: read {got} of {n} bytes")
        out = _staged(buf, dtype, shape).clone()
        self.pool.release(buf)
        self._count_read(n, time.perf_counter() - t0)
        return out

    def delete(self, key: str) -> None:
        with self._meta_lock:
            self._meta.pop(key, None)
        for path in (self._path(key), self._meta_path(key)):
            try:
                os.remove(path)
            except OSError:
                pass

    def keys(self):
        with self._meta_lock:
            return list(self._meta)


# ---------------------------------------------------------------------------
# the streamed optimizer and the streamed parameter rows
# ---------------------------------------------------------------------------


def _adam_update(p, m, v, g, lr, b1, b2, eps, wd, c1, c2):
    """AdamW on f32 CPU tensors, IN PLACE on p, m and v, with host-float
    scalars — the CPU-Adam analogue (``repro/core/offload.py:443``)."""
    m.mul_(b1).add_(g * (1.0 - b1))
    v.mul_(b2).add_(g * (1.0 - b2) * g)
    mh = m / c1
    vh = v / c2
    p.sub_(lr * (mh / (torch.sqrt(vh) + eps) + wd * p))
    return p, m, v


class ChunkedAdamOffload:
    """Slow-tier-resident optimizer states with a 3-stage streamed update.

    States are stored as fixed-size f32 chunks in any ``ArrayStore``.
    ``step()`` runs the software pipeline read(k+1) || update(k) ||
    write(k-1) over every key's chunks; with overlap off the stages
    serialize. ``last_step_stats`` holds the store-counter deltas of the
    latest step.
    """

    def __init__(self, store: ArrayStore, chunk_elems: int = DEFAULT_CHUNK_ELEMS):
        self.store = store
        self.chunk = chunk_elems
        self.layout: List[Tuple[str, tuple, int]] = []  # (key, shape, n elems)
        self.step_count = 0
        self.last_step_stats: dict = {}

    def init_from_params(self, flat_params: Dict[str, torch.Tensor]) -> None:
        """Seed master (the f32 params) and zero m, v, key by key in the
        dict's order (the order ``step`` streams them)."""
        self.layout = []
        for key, p in flat_params.items():
            p32 = p.detach().to("cpu", torch.float32).reshape(-1)
            self.layout.append((key, tuple(p.shape), p32.numel()))
            for ci, off in enumerate(range(0, p32.numel(), self.chunk)):
                sl = p32[off: off + self.chunk]
                self.store.write(f"{key}.master.{ci}", sl)
                self.store.write(f"{key}.m.{ci}", torch.zeros_like(sl))
                self.store.write(f"{key}.v.{ci}", torch.zeros_like(sl))
        self.store.flush()

    def _chunks_of(self, n: int) -> Iterator[Tuple[int, int, int]]:
        for ci, off in enumerate(range(0, n, self.chunk)):
            yield ci, off, min(self.chunk, n - off)

    def step(self, flat_grads: Dict[str, object], *, lr: float, beta1: float = 0.9,
             beta2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1
             ) -> Dict[str, torch.Tensor]:
        """Consume f32 grads per key; return the updated f32 params.

        A grad may be a tensor (any device) or a Future (a grad-tier drain
        in flight), resolved only when its key's first chunk reaches the
        update stage, so later keys' drains overlap earlier keys' traffic.
        The bias corrections c1, c2 are host floats from ``step_count``.
        """
        t_mark = self.store.mark()
        self.step_count += 1
        c1 = 1.0 - beta1 ** self.step_count
        c2 = 1.0 - beta2 ** self.step_count
        work = [(key, ci, off, ln) for key, _, n in self.layout
                for ci, off, ln in self._chunks_of(n)]
        g_cache: Dict[str, torch.Tensor] = {}

        def g_slice(key: str, off: int, ln: int) -> torch.Tensor:
            if key not in g_cache:
                g = flat_grads[key]
                if hasattr(g, "result"):  # a draining Future
                    with trace.span("grad_drain_wait", sys="optim",
                                    attr="io_wait", cls="grad", key=key):
                        g = g.result()
                g_cache[key] = g.to("cpu", torch.float32).reshape(-1)
            return g_cache[key][off: off + ln]

        out = {key: torch.empty(n, dtype=torch.float32) for key, _, n in self.layout}

        def read_chunk(item):
            key, ci, _, _ = item
            return (self.store.read(f"{key}.master.{ci}"),
                    self.store.read(f"{key}.m.{ci}"),
                    self.store.read(f"{key}.v.{ci}"))

        pending = read_chunk(work[0]) if work else None
        for i, item in enumerate(work):
            key, ci, off, ln = item
            nxt = read_chunk(work[i + 1]) if i + 1 < len(work) else None
            with trace.span("opt_read_wait", sys="optim", attr="io_wait",
                            cls="opt", key=key, unit=ci):
                p, m, v = (f.result() for f in pending)
            with trace.span("opt_update", sys="optim", attr="compute",
                            cls="opt", key=key, unit=ci):
                p, m, v = _adam_update(p, m, v, g_slice(key, off, ln), lr,
                                       beta1, beta2, eps, weight_decay, c1, c2)
            out[key][off: off + p.numel()] = p
            self.store.write(f"{key}.master.{ci}", p)  # async write-back
            self.store.write(f"{key}.m.{ci}", m)
            self.store.write(f"{key}.v.{ci}", v)
            pending = nxt
        self.store.flush()
        self.last_step_stats = self.store.delta_since(t_mark)
        return {key: out[key].reshape(shape) for key, shape, _ in self.layout}


class ParamStreamer:
    """Slow-tier-resident parameters, one chunk per row.

    Each named (L, P) array is stored as L rows, ``f"{name}/c{i}"``
    (``row_split=True``; a 1-D array is one chunk), or whole, as one chunk
    (``row_split=False``: the GSPMD engine's parameter leaves, named by
    ``keystr`` in tree order). The per-row API (``read_row`` /
    ``write_row`` / ``names``) is the layer and leaf schedulers' I/O
    backend; ``save_all`` writes every array back, and ``load_all``
    reassembles them (checkpoint paths only).
    """

    def __init__(self, store: ArrayStore, read_ahead: int = 2):
        self.store = store
        self.read_ahead = max(1, read_ahead)
        self._layout: Dict[str, Tuple[int, bool]] = {}

    def seed(self, named: Dict[str, torch.Tensor], *, row_split: bool = True) -> None:
        self._layout = {}
        for name, arr in named.items():
            split = row_split and arr.dim() >= 2
            chunks = [arr[i] for i in range(arr.shape[0])] if split else [arr]
            for i, c in enumerate(chunks):
                self.store.write(f"{name}/c{i}", c)
            self._layout[name] = (len(chunks), split)
        self.store.flush()

    def load_all(self) -> Dict[str, torch.Tensor]:
        """Every chunk, at most ``read_ahead`` reads in flight."""
        worklist = [(name, i) for name, (n, _) in self._layout.items()
                    for i in range(n)]
        results: Dict[str, List[torch.Tensor]] = collections.defaultdict(list)
        inflight: collections.deque = collections.deque()
        wi = 0
        while wi < len(worklist) or inflight:
            while wi < len(worklist) and len(inflight) < self.read_ahead:
                name, i = worklist[wi]
                inflight.append((name, self.store.read(f"{name}/c{i}")))
                wi += 1
            name, fut = inflight.popleft()
            with trace.span("param_load_wait", sys="store", attr="io_wait",
                            cls="param", key=name):
                results[name].append(fut.result())
        return {name: torch.stack(results[name]) if split else results[name][0]
                for name, (_, split) in self._layout.items()}

    def save_all(self, named: Dict[str, torch.Tensor], ready=None) -> None:
        """Write every named array back, chunked as it was seeded, and
        commit. A CUDA array is copied off the card on a store worker
        after ``ready`` (an event behind the kernels that wrote it)."""
        for name, arr in named.items():
            n, split = self._layout[name]
            chunks = [arr[i] for i in range(n)] if split else [arr]
            for i, c in enumerate(chunks):
                self.store.write(f"{name}/c{i}", c, ready=ready)
        self.store.flush()

    def names(self) -> List[str]:
        """The seeded arrays' names, in seeding order."""
        return list(self._layout)

    def read_row(self, name: str, i: int, wire: bool = False) -> Future:
        """Async read of one row — the fetch the ``PrefetchEngine`` submits
        ahead of the layer's use. With ``wire`` (a ``QuantizedArrayStore``)
        the row resolves to its wire payload, undecoded."""
        key = f"{name}/c{i}"
        return self.store.read_wire(key) if wire else self.store.read(key)

    def write_row(self, name: str, i: int, t: torch.Tensor) -> Future:
        """Async write-back of one updated row; ``flush()`` commits."""
        return self.store.write(f"{name}/c{i}", t)

    def flush(self) -> None:
        self.store.flush()


class PinnedStager:
    """Host rows to ``device`` through pinned pool buffers.

    On the card each row is copied into a pinned buffer and from there to
    the device with a non-blocking copy; the buffer goes back to the pool
    only once the event recorded behind that copy has completed (released
    earlier, the next row would overwrite it while the DMA still reads it).
    At most ``max_inflight`` copies hold buffers; ``retire(wait=True)``
    drains them (end of step). On the CPU a row is returned as it is.
    """

    def __init__(self, pool: PinnedBufferPool, device, max_inflight: int = 2):
        self.pool = pool
        self.device = torch.device(device)
        self.max_inflight = max_inflight
        self._pending: collections.deque = collections.deque()  # (event, buf)

    def to_device(self, t: torch.Tensor, gap: tuple = (0, 0)) -> torch.Tensor:
        """``t`` on the device. ``gap = (at, n)`` leaves ``n`` unset
        elements before element ``at`` of a 1-D ``t`` in the device copy
        (the rest moves up by ``n``), so a part of it can start on an
        aligned address; the card's copy, from the same pinned buffer."""
        at, n_gap = gap
        if self.device.type != "cuda":
            return t.to(self.device)
        self.retire()
        while len(self._pending) >= self.max_inflight:
            self._release_oldest()
        n = _nbytes(t)
        buf = self.pool.acquire(max(n, 1))
        staged = _staged(buf, t.dtype, t.shape)
        staged.copy_(t)
        if n_gap:
            out = torch.empty((t.numel() + n_gap,), dtype=t.dtype, device=self.device)
            out[:at].copy_(staged[:at], non_blocking=True)
            out[at + n_gap:].copy_(staged[at:], non_blocking=True)
        else:
            out = torch.empty(t.shape, dtype=t.dtype, device=self.device)
            out.copy_(staged, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._pending.append((ev, buf))
        return out

    def _release_oldest(self) -> None:
        ev, buf = self._pending.popleft()
        ev.synchronize()
        self.pool.release(buf)

    def retire(self, wait: bool = False) -> None:
        """Return every buffer whose copy has completed (with ``wait``, wait
        for all of them first)."""
        while self._pending and (wait or self._pending[0][0].query()):
            self._release_oldest()
