"""Atomic, durable, asynchronous checkpoints (``repro/checkpoint/manager.py``),
in the reference's on-disk format byte for byte, so each package reads the
other's checkpoints.

  * **format**: ``step-<8 digits>/`` holds one ``.npy`` per leaf, named
    ``md5(key)[:16]``, and ``manifest.json`` (``step``, ``extra``, per leaf
    ``file``/``shape``/``dtype``/``bytes``/``md5``, ``time``). A leaf's key
    is its path joined by "/" as the reference spells jax's path keys:
    dict keys as themselves in sorted order, ``AdamState`` fields by name
    (``opt/master/blocks/attn/wq``, ``other_opt/step``, ``flat``). bf16
    leaves are stored as the reference's numpy stores them, raw 2-byte
    voids (``<V2``) with ``"dtype": "bfloat16"`` in the manifest, written
    and read through a ``uint16`` view (no ``ml_dtypes`` here); the md5 is
    over the raw bytes. Scalars (``step``) are 0-d int32 arrays.
  * **atomic and durable**: leaves go to ``step-N.tmp/``, each fsynced,
    then the manifest, then the directory; ``os.replace`` commits it and
    the parent directory is fsynced. A crash mid-write leaves only an
    uncommitted ``.tmp``.
  * **asynchronous**: ``save()`` snapshots every leaf on the caller's
    thread — a fresh host copy of each, device-to-host copies included —
    and persists on one worker thread. No leaf the caller may update in
    place afterwards (a pinned host-tier leaf the next step overwrites)
    is aliased by the snapshot.
  * **self-healing restore**: a truncated, bit-flipped or unreadable
    checkpoint raises ``CheckpointCorruptError``, and ``restore()``
    without an explicit step falls back to the newest intact one, printing
    why. A leaf missing from the manifest raises ``KeyError``: a structure
    mismatch, which the resume path reads as a tier migration.
  * **on ranks** (``launch/train.py``): every rank takes part in the
    gathers of ``InfinityExecutor.checkpoint_state``, rank 0 alone holds
    the global leaves and saves them (writes, fsyncs, commits,
    garbage-collects), so a checkpoint written on a mesh is the file set
    one rank writes for the same state. On a resume rank 0 reads the
    directory once its own persist has committed, restores the newest
    intact step (the fallback above) and names it
    (``last_restore_step``); every other rank restores that step.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import TensorSpec

BF16 = "bfloat16"


def _leaves_with_keys(tree, path=()):
    """(key, leaf) pairs in the reference's order and spelling."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_keys(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and not isinstance(tree, TensorSpec):  # a placeholder is a leaf
        for name, v in zip(tree._fields, tree):
            yield from _leaves_with_keys(v, path + (name,))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, TensorSpec):
        for i, v in enumerate(tree):
            yield from _leaves_with_keys(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def flatten_with_keys(tree) -> dict:
    return dict(_leaves_with_keys(tree))


def _rebuild(like, flat: dict, path=()):
    """``like``'s structure with each leaf taken from ``flat`` by key."""
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, path + (str(k),)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields") \
            and not isinstance(like, TensorSpec):
        return type(like)(*(_rebuild(v, flat, path + (n,))
                            for n, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)) and not isinstance(like, TensorSpec):
        return type(like)(_rebuild(v, flat, path + (str(i),)) for i, v in enumerate(like))
    return flat["/".join(path)]


def _snapshot(x) -> Tuple[np.ndarray, str]:
    """A fresh host copy of one leaf -> (array in a plain numpy dtype, the
    manifest's dtype name). bf16 travels as its ``uint16`` bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        t = t.to("cpu", copy=True) if t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.array(x, copy=True)
    if arr.dtype.name == BF16:  # an ml_dtypes array handed in by a caller
        return arr.view(np.uint16), BF16
    if not hasattr(arr.dtype, "type") or arr.dtype.kind not in "biufc":
        raise TypeError(f"cannot checkpoint a leaf of type {type(x).__name__}")
    return arr, str(arr.dtype)


def _md5(arr: np.ndarray) -> str:
    return hashlib.md5(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _write_leaf(f, arr: np.ndarray, dtype: str) -> None:
    if dtype == BF16:
        # the header numpy writes for the reference's bf16 arrays
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())
    else:
        np.save(f, arr)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")  # keeps a 0-d scalar 0-d
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointCorruptError(RuntimeError):
    """A committed checkpoint failed verification (truncated leaf, checksum
    mismatch, unreadable manifest). Distinct from ``KeyError``, a structure
    mismatch (tier migration)."""


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - non-POSIX dir-open semantics
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    """``save`` / ``wait`` / ``restore`` over ``directory``, keeping the
    newest ``keep`` checkpoints. ``last_snapshot_s``, ``last_persist_s``,
    ``last_bytes`` and ``last_restore_s`` time the latest of each;
    ``last_restore_step`` is the step the latest restore read."""

    def __init__(self, directory: str, keep: int = 2, async_save: bool = True):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.keep = keep
        self._exec = ThreadPoolExecutor(max_workers=1) if async_save else None
        self._last_save: Optional[Future] = None
        self.save_count = 0
        self.last_snapshot_s = self.last_persist_s = self.last_restore_s = 0.0
        self.last_bytes = 0
        self.last_restore_step: Optional[int] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step-{step:08d}")

    def save(self, step: int, state: Any, extra: Optional[dict] = None) -> Future:
        """Snapshot synchronously (fresh host copies), persist
        asynchronously; one save outstanding at a time."""
        self.wait()
        t0 = time.perf_counter()
        flat = {k: _snapshot(v) for k, v in flatten_with_keys(state).items()}
        self.last_snapshot_s = time.perf_counter() - t0
        extra = dict(extra or {})
        if self._exec is None:
            f: Future = Future()
            f.set_result(self._persist(step, flat, extra))
            return f
        self._last_save = self._exec.submit(self._persist, step, flat, extra)
        return self._last_save

    def _persist(self, step: int, flat: dict, extra: dict) -> str:
        t0 = time.perf_counter()
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": {}, "time": time.time()}
        for key, (arr, dtype) in flat.items():
            fname = hashlib.md5(key.encode()).hexdigest()[:16] + ".npy"
            # each leaf durable before the manifest names it
            with open(os.path.join(tmp, fname), "wb") as f:
                _write_leaf(f, arr, dtype)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype,
                "bytes": int(arr.nbytes), "md5": _md5(arr),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic commit
        _fsync_dir(self.dir)  # the rename itself
        self.save_count += 1
        self.last_bytes = sum(m["bytes"] for m in manifest["leaves"].values())
        self._gc()
        self.last_persist_s = time.perf_counter() - t0
        return final

    def wait(self) -> None:
        if self._last_save is not None:
            self._last_save.result()
            self._last_save = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step-") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("-")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None) -> Tuple[Any, dict]:
        """Restore into the structure of ``like`` (a state; its leaves may be
        placeholders) -> (tree of CPU tensors in the checkpoint's dtypes,
        ``extra``). Without ``step``, a corrupt newest checkpoint falls
        back to the next-newest intact one; an explicit ``step`` raises."""
        if step is not None:
            return self._restore_step(step, like)
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        for i, s in enumerate(reversed(steps)):
            try:
                return self._restore_step(s, like)
            except CheckpointCorruptError as e:
                print(f"checkpoint step {s} failed verification ({e}); "
                      f"falling back to the previous complete one")
                if i == len(steps) - 1:
                    raise CheckpointCorruptError(
                        f"no intact checkpoint left in {self.dir}") from e
        raise AssertionError("unreachable")  # pragma: no cover

    def _restore_step(self, step: int, like: Any) -> Tuple[Any, dict]:
        t0 = time.perf_counter()
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(f"unreadable manifest: {e}") from e
        out = {}
        for key in flatten_with_keys(like):
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint at step {step} missing leaf {key}")
            try:
                arr = np.load(os.path.join(d, meta["file"]))
            except (OSError, ValueError, EOFError) as e:
                raise CheckpointCorruptError(f"leaf {key}: unreadable ({e})") from e
            if str(arr.dtype) != meta["dtype"]:
                # bf16 arrives as raw 2-byte voids: reinterpret its bits
                arr = arr.view(np.uint16 if meta["dtype"] == BF16
                               else np.dtype(meta["dtype"]))
            if arr.nbytes != meta["bytes"]:
                raise CheckpointCorruptError(
                    f"leaf {key}: {arr.nbytes} bytes on disk, manifest says "
                    f"{meta['bytes']} (truncated write?)")
            if meta.get("md5") and _md5(arr) != meta["md5"]:
                raise CheckpointCorruptError(f"leaf {key}: checksum mismatch")
            out[key] = _to_tensor(arr, meta["dtype"])
        tree = _rebuild(like, out)
        self.last_restore_s = time.perf_counter() - t0
        self.last_restore_step = step
        return tree, manifest["extra"]
