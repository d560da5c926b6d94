"""The port's quantized tier transport (``repro_torch/core/qformat.py``) and
the quantized matmul against the JAX package, on the CPU.

Wire frames must be byte for byte the reference's for the same array, so
either package reads the other's stores: the tests compare the encoded
bytes exactly, decoded arrays exactly, and the store wrappers' counters
exactly. The plain quantized product is held against the Pallas kernel in
interpret mode at the reference test's shapes and tolerance
(``tests/test_kernels.py``, 2e-2); its dX and dW (the ``anchor``'s
gradient) against ``jax.vjp``, in f32 (sums in another order: 2e-5 of the
largest element).
"""
import json

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import kvcache as jkv  # noqa: E402
from repro.core import offload as joff  # noqa: E402
from repro.core import qformat as jq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.testing import optional_hypothesis  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import kvcache as tkv  # noqa: E402
from repro_torch.core import offload as toff  # noqa: E402
from repro_torch.core import qformat as tq  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

given, settings, st, HAVE_HYPOTHESIS = optional_hypothesis()

NP_DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
             "float16": np.float16, "float64": np.float64}


def _both(x32: np.ndarray, dtype: str):
    """The same values as a numpy array and a torch tensor of ``dtype``."""
    a = x32.astype(NP_DTYPES[dtype])
    return a, bridge.tensor_from_numpy(a)


def _cases():
    rng = np.random.default_rng(0)
    odd = (rng.standard_normal(97) * 3.0).astype(np.float32)
    zero_block = rng.standard_normal(96).astype(np.float32)
    zero_block[32:64] = 0.0
    const_block = rng.standard_normal(80).astype(np.float32)
    const_block[:32] = -1.375
    tiny = (rng.standard_normal(33) * 1e-6).astype(np.float32)
    matrix = (rng.standard_normal((24, 64)) * 0.02).astype(np.float32)
    return {"odd": odd, "zero_block": zero_block, "const_block": const_block,
            "tiny": tiny, "matrix": matrix, "one": np.float32(0.75).reshape(())}


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", sorted(NP_DTYPES))
@pytest.mark.parametrize("fmt", ["q8", "q4"])
def test_frames_and_decodes_byte_identical_to_reference(case, dtype, fmt):
    a, t = _both(CASES[case], dtype)
    want = jq.encode_array(a, fmt)
    got = tq.encode_array(t, fmt)
    assert got.dtype == torch.uint8 and got.dim() == 1
    np.testing.assert_array_equal(got.numpy(), want)
    dec_t, dec_j = tq.decode_array(got), jq.decode_array(want)
    assert str(dec_t.dtype) == f"torch.{dtype}" and tuple(dec_t.shape) == dec_j.shape
    np.testing.assert_array_equal(dec_t.double().numpy(), dec_j.astype(np.float64))


@pytest.mark.parametrize("arr", [np.arange(7, dtype=np.int32), np.array([True, False]),
                                 np.zeros((0, 3), np.float32),
                                 np.arange(6, dtype=np.uint8).reshape(2, 3)])
def test_raw_passthrough_frames_identical(arr):
    t = torch.from_numpy(arr.copy())
    for fmt in ("q8", "q4"):
        got = tq.encode_array(t, fmt)
        np.testing.assert_array_equal(got.numpy(), jq.encode_array(arr, fmt))
        back = tq.decode_array(got)
        assert back.dtype == t.dtype and torch.equal(back, t)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 300), seed=st.integers(0, 10_000),
       scale=st.sampled_from([1e-3, 1.0, 50.0]), fmt=st.sampled_from(["q8", "q4"]))
def test_wire_frames_identical_property(n, seed, scale, fmt):
    x = (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)
    a, t = _both(x, "bfloat16")
    got = tq.encode_array(t, fmt)
    want = jq.encode_array(a, fmt)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tq.decode_array(got).float().numpy(),
                                  jq.decode_array(want).astype(np.float32))


def test_bad_payloads_raise():
    with pytest.raises(ValueError, match="magic"):
        tq.decode_array(torch.zeros(16, dtype=torch.uint8))
    with pytest.raises(ValueError, match="unknown quant format"):
        tq.encode_array(torch.zeros(4), "q2")
    assert tq.compression_ratio("q8") == jq.compression_ratio("q8")
    assert tq.compression_ratio("q4") == jq.compression_ratio("q4")
    assert tq.compression_ratio("none") == 1.0


def test_wire_matmul_operands_match_reference_and_reject_others():
    w = (np.random.default_rng(3).standard_normal((64, 96)) * 0.5).astype(np.float32)
    a, t = _both(w, "bfloat16")
    q, s, dt = tq.wire_matmul_operands(tq.encode_array(t, "q8"))
    jqq, js, jdt = jq.wire_matmul_operands(jq.encode_array(a, "q8"))
    assert q.dtype == torch.int8 and s.dtype == torch.float16 and dt == torch.bfloat16
    assert str(jdt) == "bfloat16"
    np.testing.assert_array_equal(q.numpy(), jqq)
    np.testing.assert_array_equal(s.numpy(), js)
    with pytest.raises(ValueError, match="needs q8"):
        tq.wire_matmul_operands(tq.encode_array(t, "q4"))
    with pytest.raises(ValueError, match="N % 32"):
        tq.wire_matmul_operands(tq.encode_array(t[:, :40], "q8"))
    with pytest.raises(ValueError, match="N % 32"):
        tq.wire_matmul_operands(tq.encode_array(t.reshape(-1), "q8"))


def test_wire_row_device_gives_views_of_one_body():
    """On the CPU the body is copied once; q covers whole blocks, s is one
    scale per block, and both equal the reference's decode cores' inputs."""
    x = (np.random.default_rng(4).standard_normal(100) * 0.1).astype(np.float32)
    a, t = _both(x, "bfloat16")
    stager = toff.PinnedStager(toff.PinnedBufferPool(1 << 20), "cpu")
    q, s = tq.wire_row_device(tq.encode_array(t, "q8"), stager)
    jqq, js = jq.q8_encode_np(a)
    assert q.shape == (128,) and s.shape == (4,)
    assert q.untyped_storage().data_ptr() == s.untyped_storage().data_ptr()
    np.testing.assert_array_equal(q.numpy(), jqq.reshape(-1))
    np.testing.assert_array_equal(s.numpy(), js)
    with pytest.raises(ValueError, match="1-D q8"):
        tq.wire_row_device(tq.encode_array(t, "q4"), stager)


# ---------------------------------------------------------------------------
# the store wrapper: counters, sidecar, cross-package directories
# ---------------------------------------------------------------------------


def _arrays():
    rng = np.random.default_rng(5)
    return {"w": (rng.standard_normal((64, 96)) * 0.1).astype(np.float32),
            "b": (rng.standard_normal(50)).astype(np.float32),
            "len": np.arange(3, dtype=np.int32)}


@pytest.mark.parametrize("fmt", ["q8", "q4"])
@pytest.mark.parametrize("kind", ["host", "nvme"])
def test_store_counters_equal_reference(tmp_path, fmt, kind):
    def make(pkg, sub):
        if kind == "nvme":
            return pkg.NvmeStore(str(tmp_path / sub), pool_mb=4)
        return pkg.HostArrayStore(pool_mb=4)

    js = jq.maybe_wrap_store(make(joff, "j"), fmt)
    ts = tq.maybe_wrap_store(make(toff, "t"), fmt)
    jm, tm = js.mark(), ts.mark()
    arrays = {k: x.astype(ml_dtypes.bfloat16) if x.dtype == np.float32 else x
              for k, x in _arrays().items()}
    for key, a in arrays.items():
        js.write(key, a).result()
        ts.write(key, bridge.tensor_from_numpy(a)).result()
    for key in arrays:
        got, want = ts.read(key).result(), js.read(key).result()
        np.testing.assert_array_equal(got.double().numpy(), want.astype(np.float64))
    jd, td = js.delta_since(jm), ts.delta_since(tm)
    for k in ("bytes_read", "bytes_written", "logical_bytes_read",
              "logical_bytes_written"):
        assert td[k] == jd[k], k
    assert 0 < td["bytes_written"] < td["logical_bytes_written"]
    assert ts.bandwidth_stats()["wire_format"] == fmt
    assert ts.keys() == js.keys() == list(arrays)
    # read_wire: the payload undecoded; wire bytes as read, logical as decoded
    m = ts.mark()
    wire = ts.read_wire("w").result()
    np.testing.assert_array_equal(wire.numpy(), jq.encode_array(arrays["w"], fmt))
    d = ts.delta_since(m)
    assert d["bytes_read"] == wire.numel()
    assert d["logical_bytes_read"] == arrays["w"].nbytes
    js.close()
    ts.close()


def test_nvme_directories_cross_read_with_sidecar(tmp_path):
    """A param directory written by the port (sidecar included) reads back
    through the reference's wrapper, and the other way round; a format
    mismatch fails fast in either package."""
    rows = (np.random.default_rng(6).standard_normal((3, 200)) * 0.05).astype(np.float32)
    a, t = _both(rows, "bfloat16")
    tw = tq.maybe_wrap_store(toff.NvmeStore(str(tmp_path / "t"), pool_mb=4), "q8")
    toff.ParamStreamer(tw).seed({"rank0": t}, row_split=True)
    tw.close()
    jw = jq.maybe_wrap_store(joff.NvmeStore(str(tmp_path / "j"), pool_mb=4), "q8")
    joff.ParamStreamer(jw).seed({"rank0": a}, row_split=True)
    jw.close()
    j_reads_t = jq.maybe_wrap_store(joff.NvmeStore(str(tmp_path / "t"), pool_mb=4), "q8")
    t_reads_j = tq.maybe_wrap_store(toff.NvmeStore(str(tmp_path / "j"), pool_mb=4), "q8")
    for i in range(3):
        want = jq.decode_array(jq.encode_array(a[i], "q8")).astype(np.float32)
        np.testing.assert_array_equal(
            np.asarray(j_reads_t.read(f"rank0/c{i}").result(), np.float32), want)
        np.testing.assert_array_equal(
            t_reads_j.read(f"rank0/c{i}").result().float().numpy(), want)
    j_reads_t.close()
    t_reads_j.close()
    with pytest.raises(ValueError, match="configured for"):
        jq.maybe_wrap_store(joff.NvmeStore(str(tmp_path / "t"), pool_mb=4), "q4")
    with pytest.raises(ValueError, match="configured for"):
        tq.maybe_wrap_store(toff.NvmeStore(str(tmp_path / "j"), pool_mb=4), "q4")


@pytest.mark.parametrize("fmt", ["q8", "q4"])
def test_paged_kv_parks_and_fetches_the_reference_bytes(fmt):
    """``--kv-quant``'s path: one sequence's bf16 K/V blocks parked through
    ``PagedKVCache`` over a quantized host store in each package move the
    same wire and logical bytes and fetch the same values."""
    rng = np.random.default_rng(7)
    kv = {n: (rng.standard_normal((2, 1, 40, 2, 16)) * 0.3).astype(np.float32)
          for n in ("k", "v")}
    jstore = jq.maybe_wrap_store(joff.HostArrayStore(pool_mb=4), fmt)
    tstore = tq.maybe_wrap_store(toff.HostArrayStore(pool_mb=4), fmt)
    jc = jkv.PagedKVCache(jstore, block_tokens=16, prefetch_blocks=2)
    tc = tkv.PagedKVCache(tstore, block_tokens=16, prefetch_blocks=2)
    jm, tm = jc.mark(), tc.mark()
    jc.park("s0", {n: jnp.asarray(a).astype(jnp.bfloat16) for n, a in kv.items()}, 33)
    tc.park("s0", {n: torch.from_numpy(a).to(torch.bfloat16) for n, a in kv.items()}, 33)
    jcache, jlen = jc.fetch("s0", 48)
    tcache, tlen = tc.fetch("s0", 48)
    assert jlen == tlen == 33
    for n in ("k", "v"):
        np.testing.assert_array_equal(tcache[n].float().numpy(),
                                      np.asarray(jcache[n]).astype(np.float32))
    jd, td = jc.delta_since(jm), tc.delta_since(tm)
    for k in ("bytes_read", "bytes_written", "logical_bytes_read", "logical_bytes_written"):
        assert td[k] == jd[k], k
    assert td["bytes_written"] < td["logical_bytes_written"]


# ---------------------------------------------------------------------------
# the quantized product against the Pallas kernel and jax.vjp
# ---------------------------------------------------------------------------


def _qmm_inputs(M, K, N, seed, x_dtype=np.float32):
    """x (M, K) and a bf16 weight quantized by the reference's q8 encoder."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, K)) * 0.3).astype(x_dtype)
    w = (rng.standard_normal((K, N)) * 0.3).astype(ml_dtypes.bfloat16)
    q, s, _ = jq.wire_matmul_operands(jq.encode_array(w, "q8"))
    return x, np.array(q), np.array(s)


@pytest.mark.parametrize("M,K,N,blocks", [
    (64, 128, 256, (64, 128, 64)),
    (100, 96, 64, (64, 64, 64)),
    (8, 32, 32, (8, 32, 32)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_matmul_plain_matches_pallas(M, K, N, blocks, dtype):
    x, q, s = _qmm_inputs(M, K, N, seed=M)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    bm, bn, bk = blocks
    want = jops.quantized_matmul(jnp.asarray(x).astype(jdt), jnp.asarray(q),
                                 jnp.asarray(s), bm=bm, bn=bn, bk=bk)
    got = ops.quantized_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(q),
                               torch.from_numpy(s))
    assert got.dtype == tdt and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def _close(got, want, rel=2e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_quantized_matmul_dx_matches_jax_vjp():
    """The transposed orientation is the cotangent of x through
    ``x @ dequantize_q8_jnp(q, s)``."""
    x, q, s = _qmm_inputs(48, 96, 64, seed=1)
    dy = np.random.default_rng(2).standard_normal((48, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: a @ jq.dequantize_q8_jnp(jnp.asarray(q), jnp.asarray(s)),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    got = ref.quantized_matmul_ref(torch.from_numpy(dy), torch.from_numpy(q),
                                   torch.from_numpy(s), transpose=True)
    _close(got, want)


def test_quantized_matmul_autograd_dx_and_anchor_match_jax_vjp():
    """Through ``ops.quantized_matmul``'s Function: dX (the transposed
    kernel's plain version) against ``jax.vjp`` of x @ dequant(q, s) with
    respect to x, and the anchor's gradient against ``jax.vjp`` of x @ W
    with respect to the bf16 weight W (dW does not depend on W's values)."""
    x, q, s = _qmm_inputs(40, 64, 96, seed=3)
    dy = np.random.default_rng(4).standard_normal((40, 96)).astype(np.float32)
    w32 = jq.dequantize_q8_jnp(jnp.asarray(q), jnp.asarray(s))
    _, vjp_x = jax.vjp(lambda a: a @ w32, jnp.asarray(x))
    (jdx,) = vjp_x(jnp.asarray(dy))
    _, vjp_w = jax.vjp(lambda w: jnp.asarray(x) @ w.astype(jnp.float32),
                       w32.astype(jnp.bfloat16))
    (jdw,) = vjp_w(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    anchor = torch.zeros(64, 96, dtype=torch.bfloat16, requires_grad=True)
    y = ops.quantized_matmul(xt, torch.from_numpy(q), torch.from_numpy(s), anchor)
    assert type(y.grad_fn).__name__ == "_QuantizedMatmulBackward"
    tdx, tdw = torch.autograd.grad(y, (xt, anchor), torch.from_numpy(dy))
    assert tdw.dtype == torch.bfloat16
    _close(tdx, jdx)
    # dW rounds to the anchor's bf16: one bf16 ulp of the largest element
    _close(tdw.float(), np.asarray(jdw, np.float32), rel=2**-8)


def test_quantized_matmul_saves_nothing_under_no_grad_and_checks_shapes():
    x, q, s = _qmm_inputs(8, 32, 64, seed=5)
    xt = torch.from_numpy(x).requires_grad_()
    qt, st_ = torch.from_numpy(q), torch.from_numpy(s)
    with torch.no_grad():
        y = ops.quantized_matmul(xt, qt, st_)
    assert y.grad_fn is None
    assert torch.equal(y, ref.quantized_matmul_ref(xt.detach(), qt, st_))
    with pytest.raises(ValueError, match="contraction"):
        ops.quantized_matmul(xt[:, :16], qt, st_)
    with pytest.raises(ValueError, match="N % 32"):
        ops.quantized_matmul(xt, qt[:, :48], st_[:, :1])
    with pytest.raises(ValueError, match="anchor"):
        ops.quantized_matmul(xt, qt, st_, torch.zeros(32, 32, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="int8, float16"):
        ops.quantized_matmul(xt, qt.float(), st_)


@pytest.mark.parametrize("axis,tiles", [("n", 2), ("n", 4), ("k", 2), ("k", 4)])
def test_tiled_matmul_of_a_q8_weight_matches_the_plain_product(axis, tiles):
    """``core.tiling.tiled_matmul`` on a ``QWeight``: column tiles slice the
    quants and scales on whole blocks, K tiles slice rows and accumulate in
    f32; output, dX and the anchor's gradient (dW) as the untiled product's."""
    from repro_torch.core import partition, tiling

    x, q, s = _qmm_inputs(24, 64, 128, seed=7)
    qt, st_ = torch.from_numpy(q), torch.from_numpy(s)
    dy = torch.from_numpy(np.random.default_rng(8).standard_normal((24, 128))
                          .astype(np.float32))
    grads = []
    for n_tiles in (1, tiles):
        xt = torch.from_numpy(x).requires_grad_()
        anchor = torch.zeros(64, 128, dtype=torch.bfloat16, requires_grad=True)
        y = tiling.tiled_matmul(xt, partition.QWeight(qt, st_, anchor), n_tiles, axis)
        assert y.dtype == torch.float32 and tuple(y.shape) == (24, 128)
        _close(y.detach(), ref.quantized_matmul_ref(xt.detach(), qt, st_))
        grads.append(torch.autograd.grad(y, (xt, anchor), dy))
    (dx1, dw1), (dxt, dwt) = grads
    _close(dxt, dx1)
    _close(dwt.float(), dw1.float(), rel=2**-8)  # dW rounds to the anchor's bf16


def test_tiled_matmul_of_a_q8_weight_rejects_tiles_off_the_blocks():
    from repro_torch.core import partition, tiling

    x, q, s = _qmm_inputs(8, 32, 96, seed=9)
    w = partition.QWeight(torch.from_numpy(q), torch.from_numpy(s), None)
    with pytest.raises(ValueError, match="whole 32-element quant blocks"):
        tiling.tiled_matmul(torch.from_numpy(x), w, 2, "n")  # 48-column tiles


def test_metadata_sidecar_is_the_references_json(tmp_path):
    tq.maybe_wrap_store(toff.NvmeStore(str(tmp_path), pool_mb=4), "q8").close()
    raw = toff.NvmeStore(str(tmp_path), pool_mb=4).read("__qformat__").result()
    assert json.loads(bytes(raw.numpy())) == {"format": "q8", "block": 32, "version": 1}
