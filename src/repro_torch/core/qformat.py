"""Block-quantized wire formats for the slow tiers (quantized tier
transport), the torch-only port of ``repro/core/qformat.py``.

A store that ships parameter rows (or parked KV blocks) in a quantized
*wire* format moves fewer bytes over the slow link, multiplying its
effective bandwidth by the compression ratio:

  * ``q8`` — blocks of 32 elements as int8 quants plus one fp16
    absmax/127 scale: 34 wire bytes per 32 elements (1.0625 B/elem).
  * ``q4`` — blocks of 32 elements as packed nibbles plus one fp16 scale
    and one fp16 min: 20 wire bytes per 32 elements (0.625 B/elem).

A wire payload is a 1-D ``torch.uint8`` tensor: ``b"QFMT"``, a
little-endian uint32 header length, a JSON header (fmt / dtype / shape /
block), then the body (scales, [mins,] quants). Non-float tensors pass
through as ``raw`` bytes. Frames are byte for byte the JAX package's for
the same array, so either package reads the other's stores: the header is
the same JSON (dtype names such as ``"bfloat16"``), ``torch.round``
rounds half to even as ``np.rint`` does, and each scale is the f32
``absmax / 127.0`` rounded once to fp16.

``QuantizedArrayStore`` wraps any ``ArrayStore``: writes encode in the
caller's thread, reads decode lazily on ``result()``; it keeps *logical*
byte counters beside the wrapped store's *wire* counters, and a
``__qformat__`` record in the store makes a reopened NVMe directory fail
fast on a format mismatch. ``read_wire`` hands a q8 row over undecoded:
``wire_row_device`` copies its body to the card, where the MLP
projections consume the int8 quants and fp16 scales directly through the
quantized-matmul kernel (``kernels/ops.quantized_matmul``), so no
full-precision copy of those weights is ever made.
"""
from __future__ import annotations

import json
import math
import struct
import threading
from concurrent.futures import Future
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.runtime import trace

MAGIC = b"QFMT"
BLOCK = 32  # elements per quantization block (both formats)
FORMATS = ("q8", "q4")
_METADATA_KEY = "__qformat__"

# wire bytes per element, per-block scale overhead included
WIRE_BYTES_PER_ELEM = {
    "q8": 34.0 / BLOCK,  # 32 x int8 + 1 x fp16 scale
    "q4": 20.0 / BLOCK,  # 16 packed bytes + fp16 scale + fp16 min
}

# dtypes that quantize; everything else passes through as raw bytes
_FLOAT_NAMES = ("float16", "float32", "float64", "bfloat16")


def dtype_name(dtype: torch.dtype) -> str:
    """Round-trippable dtype name shared with the JAX package's frames and
    store sidecars ('float32', 'bfloat16', 'int32', ...)."""
    return str(dtype).removeprefix("torch.")


def dtype_from_name(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r} in a store sidecar")
    return dt


def compression_ratio(fmt: Optional[str]) -> float:
    """Logical bytes / wire bytes for ``fmt`` carrying bf16 payloads (header
    excluded); 1.0 for ``None``/``"none"``/``"raw"``."""
    if fmt in (None, "none", "raw"):
        return 1.0
    if fmt not in WIRE_BYTES_PER_ELEM:
        raise ValueError(f"unknown quant format {fmt!r}; known: {FORMATS}")
    return torch.bfloat16.itemsize / WIRE_BYTES_PER_ELEM[fmt]


# ---------------------------------------------------------------------------
# encode/decode cores on CPU tensors
# ---------------------------------------------------------------------------


def _pad_blocks(flat: torch.Tensor) -> torch.Tensor:
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.view(-1, BLOCK)


def _blocks_f32(x: torch.Tensor) -> torch.Tensor:
    return _pad_blocks(x.detach().to("cpu", torch.float32).reshape(-1))


def q8_encode(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float tensor -> (quants int8 (nb, BLOCK), scales fp16 (nb,)).

    scale = absmax/127 rounded to fp16; the quantizer divides by the same
    rounded scale it stores."""
    blocks = _blocks_f32(x)
    s = (blocks.abs().amax(dim=1) / 127.0).to(torch.float16)
    s32 = s.float()
    s_safe = torch.where(s32 > 0, s32, torch.ones_like(s32))
    q = torch.round(blocks / s_safe[:, None]).clamp_(-127, 127).to(torch.int8)
    return q, s


def dequant_q8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8 quants (..., n) and fp16 scales (..., n/BLOCK) -> f32 (..., n):
    element i of a row is ``q[i] * s[i // BLOCK]``, one f32 product (the
    host decode, the quantized matmul's operands and a device wire row all
    use this layout)."""
    blocks = q.float().unflatten(-1, (-1, BLOCK))
    return (blocks * s.float()[..., None]).flatten(-2)


def q4_encode(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Float tensor -> (packed uint8 (nb, BLOCK//2), scales fp16, mins fp16).

    q = round((x - min) / scale) in [0, 15]; an all-equal block stores
    scale 0 and decodes exactly to its fp16-rounded min."""
    blocks = _blocks_f32(x)
    mn = blocks.amin(dim=1)
    mx = blocks.amax(dim=1)
    s = ((mx - mn) / 15.0).to(torch.float16)
    m16 = mn.to(torch.float16)
    s32 = s.float()
    m32 = m16.float()
    s_safe = torch.where(s32 > 0, s32, torch.ones_like(s32))
    q = torch.round((blocks - m32[:, None]) / s_safe[:, None]).clamp_(0, 15).to(torch.uint8)
    packed = q[:, 0::2] | (q[:, 1::2] << 4)
    return packed, s, m16


def q4_decode(packed: torch.Tensor, s: torch.Tensor, m16: torch.Tensor) -> torch.Tensor:
    nb = packed.shape[0]
    q = torch.empty((nb, BLOCK), dtype=torch.float32)
    q[:, 0::2] = packed & 0x0F
    q[:, 1::2] = packed >> 4
    return (q * s.float()[:, None] + m16.float()[:, None]).reshape(-1)


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """A CPU tensor's bytes as a flat uint8 tensor (a view when contiguous)."""
    return t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8)


def encode_array(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """Tensor (any device) -> self-describing wire payload (1-D uint8, CPU).

    Float dtypes quantize with ``fmt``; anything else (ints, bools — e.g.
    the KV cache's length placeholders) passes through as ``raw`` bytes."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown quant format {fmt!r}; known: {FORMATS}")
    used = _used_format(x.dtype, x.numel(), fmt)
    if used == "raw":
        body = [_bytes_of(x)]
    elif used == "q8":
        q, s = q8_encode(x)
        body = [_bytes_of(s), _bytes_of(q)]
    else:
        packed, s, m16 = q4_encode(x)
        body = [_bytes_of(s), _bytes_of(m16), _bytes_of(packed)]
    prefix = bytearray(_prefix(used, x.dtype, x.shape))
    return torch.cat([torch.frombuffer(prefix, dtype=torch.uint8)] + body)


def _used_format(dtype: torch.dtype, numel: int, fmt: str) -> str:
    """What ``encode_array`` writes a tensor in: ``fmt`` for a non-empty
    float tensor, ``raw`` otherwise."""
    return fmt if dtype_name(dtype) in _FLOAT_NAMES and numel else "raw"


def _prefix(used: str, dtype: torch.dtype, shape) -> bytes:
    """A frame's magic, header length and JSON header."""
    header = json.dumps({"fmt": used, "dtype": dtype_name(dtype), "shape": list(shape),
                         "block": 0 if used == "raw" else BLOCK},
                        separators=(",", ":")).encode()
    return MAGIC + struct.pack("<I", len(header)) + header


def wire_nbytes(shape, dtype: torch.dtype, fmt: str) -> int:
    """The bytes of ``encode_array``'s frame of a tensor of ``shape`` and
    ``dtype``: the prefix (magic, header length, JSON header) plus, for a
    float tensor, ``ceil(n / 32)`` blocks of 34 (q8) or 20 (q4) bytes, the
    last block's zero pad included (n the elements); a raw frame carries
    the bytes themselves. On a mesh each rank's shard is its own frame:
    its own pad block where its length is ragged, its own header."""
    n = math.prod(shape)
    used = _used_format(dtype, n, fmt)
    body = (n * dtype.itemsize if used == "raw"
            else -(-n // BLOCK) * round(WIRE_BYTES_PER_ELEM[used] * BLOCK))
    return len(_prefix(used, dtype, shape)) + body


def grid_aligned(shape, cuts: dict) -> bool:
    """Whether a shard of a leaf of ``shape``, cut into ``cuts[dim]``
    equal parts along each dim in ``cuts``, quantizes on the whole leaf's
    block grid: every contiguous run of the shard in the whole leaf's flat
    order starts and ends on a ``BLOCK`` boundary. A run spans the
    innermost cut dim's part and everything after it, and the runs start
    at multiples of their length, so the rule is that length % ``BLOCK``
    == 0 (a column cut of a (K, N) leaf: N / parts % 32 == 0). Then the
    shard's frame decodes to the slice of the whole leaf's decode; else
    its blocks straddle other ranks' elements and its values differ from
    the whole leaf's decode by up to both grids' rounding. A leaf no axis
    cuts is its own grid."""
    dims = [d for d, parts in cuts.items() if parts > 1]
    if not dims:
        return True
    k = max(dims)
    return (shape[k] // cuts[k]) * math.prod(shape[k + 1:]) % BLOCK == 0


def _parse_wire(wire: torch.Tensor) -> Tuple[dict, int]:
    """(header dict, body offset) of a CPU wire payload."""
    if wire.dtype != torch.uint8 or wire.dim() != 1:
        raise ValueError(f"a wire payload is 1-D uint8, got {wire.dtype} "
                         f"{tuple(wire.shape)}")
    head = bytes(wire[:8].numpy())
    if head[:4] != MAGIC:
        raise ValueError("not a QFMT wire payload (bad magic)")
    (hlen,) = struct.unpack_from("<I", head, 4)
    return json.loads(bytes(wire[8:8 + hlen].numpy()).decode()), 8 + hlen


def logical_nbytes(wire: torch.Tensor) -> int:
    """Bytes of the array a wire payload decodes to (its header's shape
    and dtype)."""
    hdr, _ = _parse_wire(wire)
    return math.prod(hdr["shape"]) * dtype_from_name(hdr["dtype"]).itemsize


def _view(body: torch.Tensor, start: int, count: int, dtype: torch.dtype) -> torch.Tensor:
    """``count`` elements of ``dtype`` at byte ``start`` of a uint8 body,
    copied (the body's offsets need not be aligned to ``dtype``)."""
    return body[start:start + count * dtype.itemsize].clone().view(dtype)


def decode_array(wire: torch.Tensor) -> torch.Tensor:
    """Wire payload -> tensor with the original shape and dtype (CPU)."""
    hdr, off = _parse_wire(wire)
    shape = tuple(hdr["shape"])
    dtype = dtype_from_name(hdr["dtype"])
    n = math.prod(shape)
    body = wire[off:]
    fmt = hdr["fmt"]
    if fmt == "raw":
        return _view(body, 0, n, dtype).reshape(shape)
    nb = -(-n // BLOCK)
    if fmt == "q8":
        s = _view(body, 0, nb, torch.float16)
        flat = dequant_q8(body[nb * 2:nb * 2 + nb * BLOCK].view(torch.int8), s)
    elif fmt == "q4":
        s = _view(body, 0, nb, torch.float16)
        m16 = _view(body, nb * 2, nb, torch.float16)
        packed = body[nb * 4:nb * 4 + nb * (BLOCK // 2)].view(nb, BLOCK // 2)
        flat = q4_decode(packed, s, m16)
    else:
        raise ValueError(f"wire payload has unknown fmt {fmt!r}")
    return flat[:n].reshape(shape).to(dtype)


def wire_matmul_operands(wire: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.dtype]:
    """View a q8 wire payload of a 2-D (K, N) array as the quantized
    matmul's operands without dequantizing: (quants int8 (K, N), scales
    fp16 (K, N//BLOCK), the array's dtype).

    Blocks run along the row-major flattening, so for N % BLOCK == 0 the
    block grid is exactly (K, N//BLOCK)."""
    hdr, off = _parse_wire(wire)
    if hdr["fmt"] != "q8":
        raise ValueError(f"fused matmul path needs q8 wire, got {hdr['fmt']!r}")
    shape = tuple(hdr["shape"])
    if len(shape) != 2 or shape[1] % BLOCK:
        raise ValueError(
            f"fused matmul path needs a 2-D (K, N % {BLOCK} == 0) payload, "
            f"got shape {shape}")
    K, N = shape
    nb = (K * N) // BLOCK
    body = wire[off:]
    s = _view(body, 0, nb, torch.float16).view(K, N // BLOCK)
    q = body[nb * 2:nb * 2 + K * N].view(torch.int8).view(K, N)
    return q, s, dtype_from_name(hdr["dtype"])


def wire_row_device(payload: torch.Tensor, stager) -> Tuple[torch.Tensor, torch.Tensor]:
    """A q8 payload of a flat row -> ``(q int8 (nb*BLOCK,), s fp16 (nb,))``
    on ``stager.device``.

    The header is parsed on the host; the body (scales, then quants) goes
    to the device through the pinned ``PinnedStager`` (one staging copy,
    two non-blocking device copies), and both operands are views of that
    one buffer: the scales first, then a gap of under 16 bytes, so the
    quants start on a 16-byte boundary (where TMA reads them in the
    quantized matmul's tensor-core route). ``q`` covers whole blocks: the
    row's elements are ``q[:n]``."""
    hdr, off = _parse_wire(payload)
    if hdr["fmt"] != "q8" or len(hdr["shape"]) != 1:
        raise ValueError(f"a device wire row is a 1-D q8 payload, got "
                         f"{hdr['fmt']!r} of shape {hdr['shape']}")
    nb = -(-hdr["shape"][0] // BLOCK)
    body = payload[off:off + nb * (2 + BLOCK)]
    sb = nb * 2
    gap = -sb % 16
    if stager.device.type == "cuda":
        body = stager.to_device(body, gap=(sb, gap))
    else:  # the host's copy stands in for the link
        out = torch.empty(body.numel() + gap, dtype=torch.uint8)
        out[:sb] = body[:sb]
        out[sb + gap:] = body[sb:]
        body = out
    return body[sb + gap:].view(torch.int8), body[:sb].view(torch.float16)


# ---------------------------------------------------------------------------
# the transparent store wrapper
# ---------------------------------------------------------------------------


class _WireFuture:
    """Future adapter over the wrapped store's read: resolves once, on the
    consumer's thread, to the decoded tensor (``decode=True``) or to the
    wire payload itself, and counts the logical bytes delivered."""

    def __init__(self, fut: Future, store: "QuantizedArrayStore", decode: bool = True):
        self._fut = fut
        self._store = store
        self._decode = decode
        self._lock = threading.Lock()
        self._value: Optional[torch.Tensor] = None

    def result(self, timeout=None) -> torch.Tensor:
        wire = self._fut.result(timeout)
        with self._lock:
            if self._value is None:
                if self._decode:
                    with trace.span("wire_decode", sys="store",
                                    cls=self._store.trace_cls,
                                    fmt=self._store.fmt) as sp:
                        value = decode_array(wire)
                        nbytes = value.numel() * value.element_size()
                        sp.set(nbytes=nbytes, wire_bytes=wire.numel())
                else:
                    value, nbytes = wire, logical_nbytes(wire)
                self._store._count_logical_read(nbytes)
                self._value = value
        return self._value

    def done(self) -> bool:
        return self._fut.done()


class QuantizedArrayStore:
    """Transparent quantizing wrapper around any ``ArrayStore``.

    Writes encode to wire format in the caller's thread, so the wrapped
    store's workers, the pinned staging pool and the files see only wire
    bytes; reads decode lazily on ``result()``. The duck-typed surface is
    the part of ``ArrayStore``'s that ``ParamStreamer``, ``PagedKVCache``
    and the executor use (write / read / flush / close / keys / delete /
    mark / delta_since / bandwidth_stats / kind), plus ``read_wire`` for a
    consumer of the wire layout itself.

    Counters: the wrapped store counts wire bytes (``bytes_read`` /
    ``bytes_written``); this wrapper adds ``logical_bytes_read`` /
    ``logical_bytes_written``, the decoded arrays' bytes.
    """

    def __init__(self, inner, fmt: str = "q8"):
        if fmt not in FORMATS:
            raise ValueError(f"unknown quant format {fmt!r}; known: {FORMATS}")
        self.inner = inner
        self.fmt = fmt
        self._lock = threading.Lock()
        self.logical_bytes_read = 0
        self.logical_bytes_written = 0
        self._check_or_write_metadata()

    # -- format metadata (sidecar record in the wrapped store) ----------

    def _check_or_write_metadata(self) -> None:
        meta = {"format": self.fmt, "block": BLOCK, "version": 1}
        if _METADATA_KEY in self.inner.keys():
            raw = self.inner.read(_METADATA_KEY).result()
            try:
                existing = json.loads(bytes(raw.numpy()))
            except ValueError:
                existing = None
            if existing != meta:
                raise ValueError(
                    f"store already holds quantized rows with metadata "
                    f"{existing}, but this wrapper is configured for {meta} "
                    f"— reopen with the matching --param-quant format")
        else:
            payload = bytearray(json.dumps(meta, separators=(",", ":")).encode())
            self.inner.write(_METADATA_KEY,
                             torch.frombuffer(payload, dtype=torch.uint8)).result()

    # -- counters -------------------------------------------------------

    def _count_logical_read(self, nbytes: int) -> None:
        with self._lock:
            self.logical_bytes_read += nbytes

    def _count_logical_write(self, nbytes: int) -> None:
        with self._lock:
            self.logical_bytes_written += nbytes

    def mark(self) -> dict:
        m = self.inner.mark()
        with self._lock:
            m["logical_bytes_read"] = self.logical_bytes_read
            m["logical_bytes_written"] = self.logical_bytes_written
        return m

    def delta_since(self, mark: dict) -> dict:
        d = self.inner.delta_since(mark)
        with self._lock:
            d["logical_bytes_read"] = self.logical_bytes_read - mark["logical_bytes_read"]
            d["logical_bytes_written"] = (self.logical_bytes_written
                                          - mark["logical_bytes_written"])
        return d

    def bandwidth_stats(self) -> dict:
        s = self.inner.bandwidth_stats()
        with self._lock:
            s["logical_bytes_read"] = self.logical_bytes_read
            s["logical_bytes_written"] = self.logical_bytes_written
        s["wire_format"] = self.fmt
        return s

    # -- the async store surface ----------------------------------------

    def _encode(self, t: torch.Tensor) -> torch.Tensor:
        nbytes = t.numel() * t.element_size()
        self._count_logical_write(nbytes)
        with trace.span("wire_encode", sys="store", cls=self.trace_cls,
                        fmt=self.fmt, nbytes=nbytes) as sp:
            wire = encode_array(t, self.fmt)
            sp.set(wire_bytes=wire.numel())
        return wire

    def write(self, key: str, t: torch.Tensor, ready=None) -> Future:
        """Encode ``t`` (any device) here and write its wire bytes; the
        encode's ops are ordered behind the kernels that produced ``t``
        on their stream, so ``ready`` needs no wait."""
        return self.inner.write(key, self._encode(t))

    def read(self, key: str) -> _WireFuture:
        return _WireFuture(self.inner.read(key), self)

    def read_wire(self, key: str) -> _WireFuture:
        """Read ``key`` and resolve to its wire payload, undecoded; the
        logical bytes are counted all the same."""
        return _WireFuture(self.inner.read(key), self, decode=False)

    def flush(self) -> None:
        self.inner.flush()

    def close(self) -> None:
        self.inner.close()

    def delete(self, key: str) -> None:
        self.inner.delete(key)

    def keys(self):
        return [k for k in self.inner.keys() if k != _METADATA_KEY]

    @property
    def kind(self) -> str:
        return self.inner.kind

    @property
    def trace_cls(self):
        return getattr(self.inner, "trace_cls", None)


def maybe_wrap_store(store, fmt: Optional[str]):
    """``fmt in (None, "none")`` -> the store unchanged; otherwise the
    quantizing wrapper."""
    if fmt in (None, "none"):
        return store
    return QuantizedArrayStore(store, fmt)
