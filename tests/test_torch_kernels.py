"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's ``kernels.ops`` run the plain PyTorch versions; they
are held against the Pallas kernels in interpret mode (``repro.kernels.ops``)
at the shapes of ``tests/test_kernels.py``, from the same numpy inputs.
Tolerances are the reference suite's: f32 sums differ only in order
(2e-5 matmul, 2e-4 attention), bf16 outputs near 1 carry ~4e-3 rounding
(2e-2). ``tests/test_torch_cuda.py`` holds the CUDA kernels against the
plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(arr: np.ndarray, dtype: str):
    """The same values in each framework (both round f32 -> bf16 to nearest
    even)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(arr).to(tdt)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("shape", [(128, 256, 128), (64, 512, 384),
                                   (300, 200, 100), (8, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_matmul_plain_matches_pallas(shape, dtype):
    M, K, N = shape
    rng = np.random.default_rng(M * 7 + K)
    xj, xt = _both((rng.standard_normal((M, K)) * 0.1).astype(np.float32), dtype)
    wj, wt = _both((rng.standard_normal((K, N)) * 0.1).astype(np.float32), dtype)
    got = ops.tiled_matmul(xt, wt)
    want = jops.tiled_matmul(xj, wj)
    assert got.dtype == xt.dtype and tuple(got.shape) == (M, N)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,D,causal", [
    (2, 4, 2, 128, 128, 32, True),
    (1, 8, 8, 64, 64, 64, True),
    (2, 4, 1, 128, 128, 32, False),   # MQA
    (1, 2, 2, 100, 132, 32, True),    # ragged, Sq < Sk
    (1, 6, 2, 64, 256, 64, True),     # long KV
    (1, 4, 2, 64, 64, 192, True),     # nemotron-4-340b's head_dim
    (1, 2, 1, 40, 72, 256, True),     # gemma-7b's, ragged
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(B, H, KV, Sq, Sk, D, causal, dtype):
    rng = np.random.default_rng(B * 100 + Sq + Sk)
    qj, qt = _both((rng.standard_normal((B, H, Sq, D)) * 0.3).astype(np.float32), dtype)
    kj, kt = _both((rng.standard_normal((B, KV, Sk, D)) * 0.3).astype(np.float32), dtype)
    vj, vt = _both((rng.standard_normal((B, KV, Sk, D)) * 0.3).astype(np.float32), dtype)
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    want = jops.flash_attention(qj, kj, vj, causal=causal)
    assert got.dtype == qt.dtype and tuple(got.shape) == (B, H, Sq, D)
    tol = 2e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_cpu_tensors_take_the_plain_path():
    """A CPU tensor goes to the plain version: no launch is counted and the
    result is the plain version's, bit for bit."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 4, 16, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 16, 32)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((7, 3)).astype(np.float32))
    ops.reset_launch_counts()
    assert torch.equal(ops.flash_attention(q, k, k), ref.attention_ref(q, k, k))
    assert torch.equal(ops.tiled_matmul(x, w), ref.matmul_ref(x, w))
    assert set(ops.launch_counts().values()) == {0}


def test_gqa_maps_heads_by_repeat_interleave():
    """Query head h reads KV head h // (H / KV): with KV heads of distinct
    constant values, each query head's output is its group's value."""
    B, H, KV, S, D = 1, 6, 2, 8, 32
    q = torch.zeros(B, H, S, D)
    v = torch.stack([torch.full((S, D), float(g + 1)) for g in range(KV)])[None]
    out = ops.flash_attention(q, torch.zeros(B, KV, S, D), v, causal=True)
    assert torch.equal(out[0, :, 0, 0], torch.tensor([1., 1., 1., 2., 2., 2.]))


def test_unsupported_devices_and_shapes_raise():
    meta = torch.empty(2, 2, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.tiled_matmul(meta, meta)
    q = torch.zeros(1, 2, 9, 32)
    k = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        ops.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="H % KV"):
        ops.flash_attention(torch.zeros(1, 3, 4, 32), torch.zeros(1, 2, 4, 32),
                            torch.zeros(1, 2, 4, 32))
    with pytest.raises(ValueError, match=r"\(M,K\) @ \(K,N\)"):
        ops.tiled_matmul(torch.zeros(2, 3), torch.zeros(4, 5))


def test_build_names_hopper_target_and_hashes_sources(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build.nvcc_command("tiled_matmul", _build.lib_path("tiled_matmul"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    before = _build.lib_path("flash_attention")
    assert before.parent == _build.BUILD_DIR
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.lib_path("flash_attention") != before  # flags are in the key
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


# ---------------------------------------------------------------------------
# training slice: fused Adam, the attention and matmul gradients
# ---------------------------------------------------------------------------

import jax  # noqa: E402

from repro.core.tiling import tiled_matmul_xla  # noqa: E402
from repro.kernels import fused_adam as jfa  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro_torch.core import tiling as ttiling  # noqa: E402


@pytest.mark.parametrize("n", [64, 128, 129, 4096, 100_001])
def test_fused_adam_plain_matches_pallas(n):
    """All four outputs (p32, m, v, p_bf16) against ``fused_adam_flat`` in
    interpret mode, padded to 128 lanes as ``ops.fused_adam`` pads. Same f32
    operations in the same order, but XLA on the CPU may contract a multiply
    and an add into one FMA where the plain version rounds twice, visible
    where ``b1*m + (1-b1)*g`` cancels: the reference suite's tolerance
    (rtol 1e-4, atol 1e-6, ``tests/test_kernels.py``); the bf16 copy to one
    bf16 ulp. On the card the kernel repeats the plain version bit for bit
    (``tests/test_torch_cuda.py``)."""
    rng = np.random.default_rng(n)
    p, g, m = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    m *= 0.1
    v = np.abs(rng.standard_normal(n)).astype(np.float32) * 0.01
    scal = np.array([1e-3, 0.9, 0.95, 1e-8, 0.1, 0.1, 0.05], np.float32)
    pad = (-n) % 128
    rows = lambda a: jnp.asarray(np.pad(a, (0, pad)).reshape(-1, 128))
    want = jfa.fused_adam_flat(rows(p), rows(g), rows(m), rows(v),
                               jnp.asarray(scal), interpret=True)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    pbf = ops.fused_adam(tp, torch.from_numpy(g), tm, tv, torch.from_numpy(scal))
    assert pbf.dtype == torch.bfloat16 and tuple(pbf.shape) == (n,)
    for got, w in ((tp, want[0]), (tm, want[1]), (tv, want[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w).reshape(-1)[:n],
                                   rtol=1e-4, atol=1e-6)
    wbf = _np(want[3]).reshape(-1)[:n]
    assert (np.abs(_np(pbf) - wbf) <= 2**-7 * np.abs(wbf) + 1e-6).all()


def test_fused_adam_updates_in_place_and_refuses_strided_state():
    p = torch.zeros(3, 128)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    s = ops.adam_scalars(0.1, 0.9, 0.95, 1e-8, 0.0, 0.1, 0.05, "cpu")
    ops.fused_adam(p, torch.ones_like(p), m, v, s)
    assert (p < 0).all() and (m > 0).all() and (v > 0).all()
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_adam(p.T, p.T, m.T, v.T, s)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,D", [
    (2, 4, 2, 64, 64, 16),    # GQA, Sq == Sk
    (1, 6, 2, 20, 37, 16),    # GQA, Sq < Sk, ragged
    (2, 3, 3, 48, 48, 32),    # MHA
])
def test_flash_backward_plain_matches_jax_vjp(B, H, KV, Sq, Sk, D):
    """``ref.attention_bwd_ref`` (through the autograd Function) against
    ``jax.vjp`` of the reference's jnp ``chunked_attention`` with the causal
    mask aligned at the end (``q_offset = Sk - Sq``), in f32: the sums differ
    only in order (2e-5 of the gradient's largest element)."""
    rng = np.random.default_rng(Sq * 10 + Sk)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, KV, D)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    f = lambda q, k, v: jcm.chunked_attention(q, k, v, causal=True, q_offset=Sk - Sq,
                                              q_chunk=16, kv_chunk=16)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2), causal=True)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do).transpose(1, 2))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-5 * np.abs(w).max())


@pytest.mark.parametrize("D", [16, 64, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,window", [(48, 48, 16), (20, 53, 24)])
def test_windowed_plain_attention_matches_chunked_attention(D, causal, Sq, Sk, window):
    """The windowed plain version (forward, and backward through the
    autograd Function) against the reference's jnp ``chunked_attention``
    with ``window`` and the query's end-aligned offset ``q_offset = Sk -
    Sq``, forward and ``jax.vjp``, in f32: sums differ only in order (2e-5
    of the largest element). The same plain version without the window's
    lower bound (a mutant that drops it) misses the forward by far more."""
    B, H, KV = 1, 4, 2
    rng = np.random.default_rng(Sq * 10 + Sk + D)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, KV, D)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    f = lambda q, k, v: jcm.chunked_attention(q, k, v, causal=causal, q_offset=Sk - Sq,
                                              window=window, q_chunk=16, kv_chunk=16)
    want_o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2), causal=causal, window=window)
    want_o = np.asarray(want_o)
    tol = 2e-5 * np.abs(want_o).max()
    np.testing.assert_allclose(out.detach().transpose(1, 2).numpy(), want_o, rtol=0, atol=tol)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do).transpose(1, 2))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-5 * np.abs(w).max())
    dropped = ref.attention_ref(tq.detach().transpose(1, 2), tk.detach().transpose(1, 2),
                                tv.detach().transpose(1, 2), causal=causal)
    assert np.abs(dropped.transpose(1, 2).numpy() - want_o).max() > 100 * tol


def test_window_rule_is_end_aligned_and_global_at_zero():
    m = ref.visible(3, 6, True, 2, "cpu")  # query i sits at key position i + 3
    assert m.tolist() == [[False, False, True, True, False, False],
                          [False, False, False, True, True, False],
                          [False, False, False, False, True, True]]
    assert ref.visible(4, 4, False, 0, "cpu").all()
    assert torch.equal(ref.visible(5, 7, True, 0, "cpu"), ref.visible(5, 7, True, 99, "cpu"))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(torch.zeros(1, 1, 4, 8), torch.zeros(1, 1, 4, 8),
                            torch.zeros(1, 1, 4, 8), window=-1)


def test_autograd_wiring_saves_nothing_when_serving():
    """Under ``no_grad`` (serving) the forward runs alone: no graph, the
    plain version's output bit for bit. With grad the Function's backward
    is the plain backward written out (``attention_bwd_ref``)."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 4, 12, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 12, 16)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((7, 3)).astype(np.float32))
    for t in (q, k, x, w):
        t.requires_grad_()
    with torch.no_grad():
        o = ops.flash_attention(q, k, k)
        y = ops.tiled_matmul(x, w)
    assert o.grad_fn is None and y.grad_fn is None
    assert torch.equal(o, ref.attention_ref(q.detach(), k.detach(), k.detach()))
    o = ops.flash_attention(q, k, k)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    do = torch.ones_like(o)
    got = torch.autograd.grad(o, (q, k), do)
    _, lse = ref.attention_fwd_ref(q.detach(), k.detach(), k.detach())
    dq, dk, dv = ref.attention_bwd_ref(q.detach(), k.detach(), k.detach(), o.detach(),
                                       lse, do)
    assert torch.equal(got[0], dq) and torch.equal(got[1], dk + dv)


@pytest.mark.parametrize("tiles,axis", [(1, None), (2, "n"), (2, "k")])
def test_matmul_gradients_match_jax_vjp(tiles, axis):
    """dX and dW through ``core.tiling.tiled_matmul`` (the kernel's autograd
    Function) against ``jax.vjp`` of ``tiled_matmul_xla``, f32 (2e-5)."""
    rng = np.random.default_rng(tiles)
    x = rng.standard_normal((3, 10, 64)).astype(np.float32) * 0.1
    w = rng.standard_normal((64, 96)).astype(np.float32) * 0.1
    dy = rng.standard_normal((3, 10, 96)).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w: tiled_matmul_xla(x, w, tiles, axis),
                     jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(dy))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    y = ttiling.tiled_matmul(tx, tw, tiles, axis)
    got = torch.autograd.grad(y, (tx, tw), torch.from_numpy(dy))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=2e-5, atol=2e-5)
