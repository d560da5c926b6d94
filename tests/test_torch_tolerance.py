"""``chip_smoke.py``'s kernel tolerances against faulty kernels, on the CPU.

The CUDA kernels run only on the card, so their arithmetic is emulated
here in float64: the flash kernel's K/V tiles of 32 keys, online softmax
against the running max and p rounded to the input type before P@V; the
tiled matmul's exact sum rounded once. Each emulation must pass
``chip_smoke.compare`` against the plain version at a serve shape, and each
mutant of it (a fault the kernel could carry) must fail there, so the
check on the card can tell a faulty kernel from a right one.
"""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BK = 32  # keys per K/V tile in csrc/flash_attention.cu


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emulate_flash(q, k, v, *, scale_mul=1.0, drop=None, dup=None, shift=0,
                  rescale_l=True):
    """The kernel's arithmetic for causal q (B,H,S,D), k/v (B,KV,S,D)."""
    B, H, S, D = q.shape
    n_rep = H // k.shape[1]
    qf = q.double()
    kf = k.repeat_interleave(n_rep, 1).double()
    vf = v.repeat_interleave(n_rep, 1).double()
    m = torch.full((B, H, S, 1), -1e30, dtype=torch.float64)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, H, S, D, dtype=torch.float64)
    rows = torch.arange(S)[:, None]
    tiles = [t for t in range(S // BK) if t != drop] + ([dup] if dup is not None else [])
    for t in tiles:
        keys = slice(t * BK, (t + 1) * BK)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, keys]) * D ** -0.5 * scale_mul
        s = torch.where(torch.arange(t * BK, (t + 1) * BK) <= rows + shift, s,
                        torch.tensor(-1e30, dtype=torch.float64))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = (l * alpha if rescale_l else l) + p.sum(-1, keepdim=True)
        p = p.to(q.dtype).double()
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vf[:, :, keys])
        m = m_new
    return (acc / l).to(q.dtype)


def _flash_inputs(dtype):
    # chip_smoke's draw at the serve shape's heads, length and head_dim
    B, H, KV, S, D = 1, 9, 3, 512, 64
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, S, H, D, generator=g).to(dtype).transpose(1, 2)
    k = torch.randn(B, S, KV, D, generator=g).to(dtype).transpose(1, 2)
    v = torch.randn(B, S, KV, D, generator=g).to(dtype).transpose(1, 2)
    return (B, H, KV, S, S, D), q, k, v


def _check_flash(dtype, **mutation):
    shape, q, k, v = _flash_inputs(dtype)
    return _chip_smoke().compare(
        "flash_attention", shape, dtype, emulate_flash(q, k, v, **mutation),
        ref.attention_ref(q, k, v, causal=True),
        ref.attention_ref(q, k, v.abs(), causal=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_tolerance_passes_the_kernels_arithmetic(dtype):
    assert _check_flash(dtype)["worst_err_over_tol"] <= 1.0


@pytest.mark.parametrize("mutation", [
    {"scale_mul": 1.003}, {"drop": 15}, {"drop": 8}, {"dup": 15},
    {"shift": 1}, {"shift": -1}, {"rescale_l": False}],
    ids=["scale", "lost-last-tile", "lost-mid-tile", "doubled-tile",
         "causal+1", "causal-1", "l-not-rescaled"])
def test_flash_tolerance_rejects_a_faulty_kernel(mutation):
    with pytest.raises(SystemExit, match="FAIL flash_attention"):
        _check_flash(torch.float32, **mutation)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_tolerance_passes_right_and_rejects_a_lost_k_tile(dtype):
    M, K, N = 2048, 1536, 576
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(M, K, generator=g) * 0.1).to(dtype)
    w = (torch.randn(K, N, generator=g) * 0.1).to(dtype)
    plain, mag = ref.matmul_ref(x, w), ref.matmul_ref(x.abs(), w.abs())
    cs = _chip_smoke()
    right = (x.double() @ w.double()).to(dtype)
    assert cs.compare("tiled_matmul", (M, K, N), dtype, right, plain, mag)[
        "worst_err_over_tol"] <= 1.0
    lost = (x[:, 64:].double() @ w[64:].double()).to(dtype)
    with pytest.raises(SystemExit, match="FAIL tiled_matmul"):
        cs.compare("tiled_matmul", (M, K, N), dtype, lost, plain, mag)
