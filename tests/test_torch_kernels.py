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
    assert ops.launch_counts() == {"flash_attention": 0, "tiled_matmul": 0}


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
