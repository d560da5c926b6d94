"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where torch has no CUDA
device: the kernels have no CPU mode. The module imports neither JAX nor
the JAX package, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

TF32 is off for every comparison. Tolerances: f32 sums differ only in
order (1e-4 matmul at K <= 1536, 2e-4 attention). bf16 is held element by
element to one output ulp (2^-7 |plain|) plus the rounding inside the sums,
scaled by the plain version on absolute values: 2^-7 of softmax-weighted
|v| (p is rounded to bf16 against another max in each version), 2^-12 of
|x| @ |w| (f32 sums in another order).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def assert_close(got, want, mag, dtype, f32_tol, mtol):
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= f32_tol
    else:
        allowed = 2**-7 * want.float().abs() + mtol * mag.float()
        assert (err <= allowed).all(), (err / allowed).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 576, 1536), (4, 576, 1536), (300, 200, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_matmul_kernel_matches_plain(cuda, shape, dtype):
    M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(M, K, generator=g, device=cuda) * 0.1).to(dtype)
    w = (torch.randn(K, N, generator=g, device=cuda) * 0.1).to(dtype)
    before = ops.launch_counts()["tiled_matmul"]
    got = ops.tiled_matmul(x, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["tiled_matmul"] == before + 1
    assert_close(got, ref.matmul_ref(x, w), ref.matmul_ref(x.abs(), w.abs()),
                 dtype, f32_tol=1e-4, mtol=2**-12)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 9, 3, 512, 512, 64), (1, 2, 2, 100, 132, 32),
                                   (2, 4, 1, 64, 64, 128), (1, 3, 1, 16, 16, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, shape, dtype):
    B, H, KV, Sq, Sk, D = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    # unit variance: a peaked softmax and outputs of O(1)
    q = torch.randn(B, Sq, H, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Sk, KV, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Sk, KV, D, generator=g, device=cuda).to(dtype)
    # the model's (B,S,H,D) storage goes in as a strided (B,H,S,D) view
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    got = ops.flash_attention(qh, kh, vh, causal=True)
    torch.cuda.synchronize()
    assert got.stride() == qh.stride()
    assert_close(got, ref.attention_ref(qh, kh, vh, causal=True),
                 ref.attention_ref(qh, kh, vh.abs(), causal=True),
                 dtype, f32_tol=2e-4, mtol=2**-7)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.zeros(4, 4, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        ops.tiled_matmul(x, x)
    q = torch.zeros(1, 1, 4, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_cuda(q, q, q)
