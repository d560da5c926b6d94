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

from repro_torch.core import qformat  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import tiled_matmul as tmm  # noqa: E402


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


def _took(key, fn, want):
    """``fn()``, held by the launch counters of ``key``: one launch on the
    route ``want``, none on the other."""
    before = ops.launch_counts()
    got = fn()
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after[key] == before[key] + 1
    for r in tmm.ROUTES:
        assert after[f"{key}_{r}"] == before[f"{key}_{r}"] + (r == want), (r, before, after)
    return got


def _routed(x, w, want):
    """``ops.tiled_matmul`` on the route ``want``, which the rule picks."""
    assert tmm.route(x, w) == want
    return _took("tiled_matmul", lambda: ops.tiled_matmul(x, w), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 576, 1536), (4, 576, 1536), (300, 200, 100),
                                   (1, 576, 1536), (296, 200, 104), (2048, 1536, 576)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_matmul_kernel_matches_plain(cuda, shape, dtype):
    """bf16 takes the tensor cores but where TMA cannot read w (300,200,100:
    rows 200 bytes apart); f32 the CUDA cores."""
    M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(M, K, generator=g, device=cuda) * 0.1).to(dtype)
    w = (torch.randn(K, N, generator=g, device=cuda) * 0.1).to(dtype)
    want = "wgmma" if dtype == torch.bfloat16 and shape != (300, 200, 100) else "simt"
    got = _routed(x, w, want)
    assert_close(got, ref.matmul_ref(x, w), ref.matmul_ref(x.abs(), w.abs()),
                 dtype, f32_tol=1e-4, mtol=2**-12)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,trans", [
    (s, t) for s in [(296, 200, 104), (520, 264, 392), (1536, 4096, 576), (576, 4096, 1536)]
    for t in ["", "x", "w", "xw"]] + [((4, 576, 1536), ""), ((4, 576, 1536), "w")]
    # llava-next-34b's MLP: x @ W_in (K 7168, N 20480), h @ W_out and dX =
    # dY @ W_in^T (K 20480), dW = X^T @ dY
    + [((520, 7168, 20480), ""), ((520, 20480, 7168), ""), ((520, 20480, 7168), "w"),
       ((7168, 520, 20480), "x")])
def test_tiled_matmul_wgmma_reads_every_major_ness(cuda, shape, trans):
    """x K- or M-major, w N- or K-major (``trans`` names the operands given
    as transposed views), at M, K, N all distinct -- a square product would
    not show a B read in the wrong major-ness -- ragged against every tile,
    split along K = 4096, and at decode's M = 4 (x K-major there: an M-major
    x of 4 rows has an 8-byte stride, which TMA cannot read)."""
    M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(4)
    x = (torch.randn((K, M) if "x" in trans else (M, K), generator=g, device=cuda) * 0.1)
    w = (torch.randn((N, K) if "w" in trans else (K, N), generator=g, device=cuda) * 0.1)
    x = (x.T if "x" in trans else x).to(torch.bfloat16)
    w = (w.T if "w" in trans else w).to(torch.bfloat16)
    got = _routed(x, w, "wgmma")
    # f32 sums of K products in another order: K * 2^-24 of |x| @ |w|
    mtol = 2**-12 if K <= 1536 else 2**-11 if K <= 8192 else 2**-9
    assert_close(got, ref.matmul_ref(x, w), ref.matmul_ref(x.abs(), w.abs()),
                 torch.bfloat16, f32_tol=None, mtol=mtol)


@pytest.mark.cuda
def test_tiled_matmul_simt_route_on_request(cuda):
    """``simt=True`` runs the CUDA-core kernel on operands the tensor cores
    take (the previous design, timed beside the new one)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.randn(296, 200, generator=g, device=cuda) * 0.1).to(torch.bfloat16)
    w = (torch.randn(200, 104, generator=g, device=cuda) * 0.1).to(torch.bfloat16)
    before = ops.launch_counts()
    got = tmm.tiled_matmul_cuda(x, w, simt=True)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["tiled_matmul_simt"] == before["tiled_matmul_simt"] + 1
    assert after["tiled_matmul_wgmma"] == before["tiled_matmul_wgmma"]
    assert_close(got, ref.matmul_ref(x, w), ref.matmul_ref(x.abs(), w.abs()),
                 torch.bfloat16, f32_tol=None, mtol=2**-12)


def _flash_routed(fn, inputs, want, bwd=False):
    """A flash call on the route ``want``: the one the rule picks for
    ``inputs``, or ``simt`` forced by the call."""
    assert want == "simt" or tfa.route(*inputs) == want
    return _took("flash_attention_bwd" if bwd else "flash_attention", fn, want)


def _want_route(dtype, D):
    return "wgmma" if dtype == torch.bfloat16 and D in tfa.WGMMA_HEAD_DIMS else "simt"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 9, 3, 512, 512, 64), (1, 2, 2, 100, 132, 32),
                                   (2, 4, 1, 64, 64, 128), (1, 3, 1, 16, 16, 32),
                                   (1, 12, 2, 100, 132, 192), (2, 4, 4, 77, 77, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, shape, dtype):
    """bf16 at head_dim 64, 128, 192 and 256 takes the tensor cores; f32 and
    head_dim 32 the CUDA cores."""
    B, H, KV, Sq, Sk, D = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    # unit variance: a peaked softmax and outputs of O(1)
    q = torch.randn(B, Sq, H, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Sk, KV, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Sk, KV, D, generator=g, device=cuda).to(dtype)
    # the model's (B,S,H,D) storage goes in as a strided (B,H,S,D) view
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    got = _flash_routed(lambda: ops.flash_attention(qh, kh, vh, causal=True), (qh, kh, vh),
                        _want_route(dtype, D))
    assert got.stride() == qh.stride()
    assert_close(got, ref.attention_ref(qh, kh, vh, causal=True),
                 ref.attention_ref(qh, kh, vh.abs(), causal=True),
                 dtype, f32_tol=2e-4, mtol=2**-7)


# (B, H, KV, Sq, Sk, D, layout, causal): head_dim 64, 128, 192 and 256;
# n_rep 1 to 16; Sq < Sk; Sq and Sk not multiples of the tiles (128 query
# rows, 64 keys; 64 query rows in dQ above head_dim 128); (B,S,H,D) storage
# as a strided view ("bshd") and contiguous (B,H,S,D)
FLASH_ROUTE_CASES = [
    (2, 9, 3, 512, 512, 64, "bshd", True),     # smollm-135m's heads
    (1, 6, 2, 100, 132, 64, "bshd", True),     # ragged, Sq < Sk
    (2, 4, 4, 77, 77, 128, "bhsd", True),      # head_dim 128, n_rep 1
    (1, 24, 8, 200, 264, 128, "bshd", True),   # llama-3.2-3b's heads
    (3, 3, 1, 130, 130, 64, "bhsd", True),     # n_rep 3, one row past a tile
    (1, 4, 2, 96, 160, 64, "bshd", False),     # not causal
    (1, 16, 1, 300, 300, 256, "bshd", True),   # recurrentgemma-9b's MQA, 16 on 1
    (2, 16, 16, 130, 130, 256, "bhsd", True),  # gemma-7b's heads, odd length
    (1, 24, 2, 100, 132, 192, "bshd", True),   # nemotron-4-340b's 12 a group, Sq < Sk
    (2, 4, 4, 77, 77, 192, "bshd", True),      # odd length, n_rep 1
    (1, 8, 2, 96, 160, 256, "bshd", False),    # not causal, Sq < Sk
    (1, 14, 2, 300, 300, 128, "bshd", True),   # llava-next-34b's n_rep 7, ragged
    (2, 16, 16, 77, 77, 64, "bshd", False),    # seamless's encoder, odd length
    (2, 16, 16, 33, 130, 64, "bshd", False),   # its cross-attention, Sq ~ Sk / 4
]


def _flash_inputs(case, dtype, seed, grads=False):
    B, H, KV, Sq, Sk, D, layout, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(S, heads):
        t = torch.randn(B, S, heads, D, generator=g, device="cuda").to(dtype).transpose(1, 2)
        return t if layout == "bshd" else t.contiguous()

    ts = [draw(Sq, H), draw(Sk, KV), draw(Sk, KV)]
    return ts + [draw(Sq, H)] if grads else ts


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_ROUTE_CASES)
def test_flash_attention_routes_match_plain_and_each_other(cuda, case):
    """The forward and backward on both routes, bf16: each against the plain
    version on the same inputs (the tolerances above), and the two routes
    against each other within the sum of their tolerances."""
    causal = case[7]
    q, k, v, do = _flash_inputs(case, torch.bfloat16, 6, grads=True)
    plain, lse_ref = ref.attention_fwd_ref(q, k, v, causal=causal)
    mag = ref.attention_ref(q, k, v.abs(), causal=causal)
    outs = {}
    for r in tfa.ROUTES:
        outs[r] = _flash_routed(
            lambda: tfa.flash_attention_cuda(q, k, v, causal=causal, with_lse=True,
                                             simt=r == "simt"), (q, k, v), r)
        o, lse = outs[r]
        assert o.stride() == q.stride()
        assert_close(o, plain, mag, torch.bfloat16, f32_tol=None, mtol=2**-7)
        assert (lse - lse_ref).abs().max().item() <= 1e-4 * max(1.0, lse_ref.abs().max().item())
    # both backward routes from the same saved o and lse (the wgmma forward's)
    o, lse = outs["wgmma"]
    grads = {r: _flash_routed(lambda: tfa.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, causal=causal, simt=r == "simt"), (q, k, v, do), r, bwd=True)
        for r in tfa.ROUTES}
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    for r in tfa.ROUTES:
        for a, b, t in zip(grads[r], want, (q, k, v)):
            assert a.stride() == t.stride() and a.dtype == torch.bfloat16
            _bwd_close(a, b, torch.bfloat16)
    err = (outs["wgmma"][0].float() - outs["simt"][0].float()).abs()
    assert (err <= 2 * (2**-7 * plain.float().abs() + 2**-7 * mag.float())).all()
    for a, b, w in zip(grads["wgmma"], grads["simt"], want):
        err = (a.float() - b.float()).abs()
        assert (err <= 2 * (2**-7 * w.float().abs() + 2**-9 * w.float().abs().max())).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case,window", [
    (FLASH_ROUTE_CASES[0], 0), (FLASH_ROUTE_CASES[3], 0), (FLASH_ROUTE_CASES[6], 0),
    (FLASH_ROUTE_CASES[6], 100), (FLASH_ROUTE_CASES[7], 0), (FLASH_ROUTE_CASES[8], 0),
    (FLASH_ROUTE_CASES[8], 50)])
def test_flash_attention_wgmma_repeats_to_the_bit(cuda, case, window):
    """No atomics anywhere: two runs of the forward and of the backward on
    the same inputs are bit-identical, at every head_dim, with and without
    a window."""
    causal = case[7]
    q, k, v, do = _flash_inputs(case, torch.bfloat16, 7, grads=True)
    assert tfa.route(q, k, v, do) == "wgmma"
    runs = []
    for _ in range(2):
        o, lse = tfa.flash_attention_cuda(q, k, v, causal=causal, window=window, with_lse=True)
        runs.append((o, lse, *tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                                           window=window)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_simt_route_on_request_and_f32_stays_there(cuda):
    """``simt=True`` runs the CUDA-core kernels on bf16 operands the tensor
    cores take; f32 and head_dim 32 route there by the rule."""
    q, k, v = _flash_inputs(FLASH_ROUTE_CASES[1], torch.bfloat16, 8)
    assert tfa.route(q, k, v) == "wgmma"
    _took("flash_attention", lambda: tfa.flash_attention_cuda(q, k, v, simt=True), "simt")
    assert tfa.route(*_flash_inputs(FLASH_ROUTE_CASES[1], torch.float32, 8)) == "simt"
    q32 = torch.zeros(1, 2, 40, 32, device=cuda, dtype=torch.bfloat16)
    assert tfa.route(q32, q32[:, :1], q32[:, :1]) == "simt"


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.zeros(4, 4, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        ops.tiled_matmul(x, x)
    q = torch.zeros(1, 1, 4, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_cuda(q, q, q)


def _bwd_close(got, want, dtype):
    """Backward gradients: f32 sums differ in order only (1e-4 of the
    tensor's largest element); bf16 adds one output ulp (2^-7 |plain|) and
    the rare p rounded to bf16 one ulp apart inside dV (2^-9 of the
    largest element)."""
    err = (got.float() - want.float()).abs()
    top = want.float().abs().max()
    if dtype == torch.float32:
        allowed = 1e-4 * top
    else:
        allowed = 2**-7 * want.float().abs() + 2**-9 * top
    assert (err <= allowed).all(), (err / allowed).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 9, 3, 512, 512, 64), (1, 6, 2, 100, 132, 64),
                                   (2, 4, 1, 64, 64, 128), (1, 2, 2, 40, 40, 32),
                                   (1, 12, 2, 100, 132, 192), (2, 4, 4, 77, 77, 256),
                                   (1, 16, 16, 512, 512, 256), (1, 96, 8, 256, 256, 192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_matches_plain(cuda, shape, dtype):
    """Every head_dim the kernels take, gemma-7b's and nemotron-4-340b's
    heads among them (head_dim 256 and 192: the tensor cores in bf16)."""
    B, H, KV, Sq, Sk, D = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    q, do = (torch.randn(B, Sq, H, D, generator=g, device=cuda).to(dtype).transpose(1, 2)
             for _ in range(2))
    k, v = (torch.randn(B, Sk, KV, D, generator=g, device=cuda).to(dtype).transpose(1, 2)
            for _ in range(2))
    o, lse = tfa.flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    o_ref, lse_ref = ref.attention_fwd_ref(q, k, v, causal=True)
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    got = _flash_routed(lambda: tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True),
                        (q, k, v, do), _want_route(dtype, D), bwd=True)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    for a, b, t in zip(got, want, (q, k, v)):
        assert a.stride() == t.stride() and a.dtype == dtype
        _bwd_close(a, b, dtype)


# (B, H, KV, Sq, Sk, D, layout, causal, window): a local window on both
# routes at head_dim 64, 128, 192 and 256; odd Sq/Sk (77, 130: where the
# TMA-box fault hid), Sq < Sk, not causal, a window past Sk (global), and
# recurrentgemma's heads (16 query heads on one KV head, head_dim 256)
FLASH_WINDOW_CASES = [
    (2, 9, 3, 512, 512, 64, "bshd", True, 128),
    (1, 6, 2, 100, 132, 64, "bshd", True, 50),
    (3, 3, 1, 130, 130, 64, "bhsd", True, 64),
    (1, 4, 2, 96, 160, 64, "bshd", False, 40),
    (2, 4, 4, 77, 77, 128, "bhsd", True, 33),
    (1, 3, 1, 130, 130, 64, "bshd", True, 1000),
    (1, 16, 1, 300, 300, 256, "bshd", True, 100),
    (1, 4, 2, 77, 130, 192, "bshd", False, 50),
    (1, 16, 1, 600, 600, 256, "bshd", True, 256),   # rows past the window's tiles
    (2, 16, 1, 77, 130, 256, "bhsd", True, 60),     # MQA, odd, Sq < Sk
    (1, 12, 2, 130, 130, 192, "bshd", True, 1000),  # a window past Sk
    (1, 24, 2, 200, 264, 192, "bshd", True, 64),    # GQA 12 a group, Sq < Sk
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_WINDOW_CASES)
def test_flash_attention_window_matches_plain_on_both_routes(cuda, case):
    """The windowed forward and backward on every route the head_dim
    allows, bf16, against the windowed plain version with the tolerances
    of the unwindowed checks; the plain version without the window's lower
    bound (the mutant that drops it) fails that tolerance."""
    causal, window, D = case[7], case[8], case[5]
    q, k, v, do = _flash_inputs(case[:8], torch.bfloat16, 9, grads=True)
    plain, lse_ref = ref.attention_fwd_ref(q, k, v, causal=causal, window=window)
    mag = ref.attention_ref(q, k, v.abs(), causal=causal, window=window)
    routes = tfa.ROUTES if D in tfa.WGMMA_HEAD_DIMS else ("simt",)
    for r in routes:
        o, lse = _flash_routed(
            lambda: tfa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                             with_lse=True, simt=r == "simt"), (q, k, v), r)
        assert_close(o, plain, mag, torch.bfloat16, f32_tol=None, mtol=2**-7)
        assert (lse - lse_ref).abs().max().item() <= 1e-4 * max(1.0, lse_ref.abs().max().item())
        grads = _flash_routed(lambda: tfa.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal=causal, window=window, simt=r == "simt"),
            (q, k, v, do), r, bwd=True)
        want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
        for a, b, t in zip(grads, want, (q, k, v)):
            assert a.stride() == t.stride()
            _bwd_close(a, b, torch.bfloat16)
        if window < q.shape[2] + k.shape[2]:
            dropped = ref.attention_ref(q, k, v, causal=causal)
            with pytest.raises(AssertionError):
                assert_close(o, dropped, mag, torch.bfloat16, f32_tol=None, mtol=2**-7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_matmul_reads_transposed_views(cuda, dtype):
    """dX = dY @ W^T and dW = X^T @ dY on saved tensors, in place."""
    M, K, N = 4096, 576, 1536
    g = torch.Generator(device=cuda).manual_seed(2)
    x = (torch.randn(M, K, generator=g, device=cuda) * 0.1).to(dtype)
    w = (torch.randn(K, N, generator=g, device=cuda) * 0.1).to(dtype)
    dy = (torch.randn(M, N, generator=g, device=cuda) * 0.1).to(dtype)
    for a, b in ((dy, w.T), (x.T, dy), (x[:, 7:300], w[7:300, 100:1000])):
        got = ops.tiled_matmul(a, b)
        assert_close(got, ref.matmul_ref(a, b), ref.matmul_ref(a.abs(), b.abs()),
                     dtype, f32_tol=1e-4, mtol=2**-11)  # K up to 4096: 2^-12 |x|@|w|


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 129, 100_001, 49152 * 576])
def test_fused_adam_kernel_repeats_plain_bit_for_bit(cuda, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    p, grad, m = (torch.randn(n, generator=g, device=cuda) for _ in range(3))
    v = torch.randn(n, generator=g, device=cuda).abs() * 0.01
    scalars = ops.adam_scalars(1e-3, 0.9, 0.95, 1e-8, 0.1, 0.1, 0.05, cuda)
    cpu = [t.cpu() for t in (p, grad, m, v)]
    before = ops.launch_counts()["fused_adam"]
    pbf = ops.fused_adam(p, grad, m, v, scalars)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_adam"] == before + 1
    # the plain version on the card, on copies of the same inputs
    pp, mp, vp = (t.to(cuda) for t in (cpu[0], cpu[2], cpu[3]))
    pad = (-n) % 128
    rows = lambda t: torch.nn.functional.pad(t, (0, pad)).view(-1, 128)
    pr, gr, mr, vr = rows(pp), rows(cpu[1].to(cuda)), rows(mp), rows(vp)
    pbf_ref = ref.adam_ref(pr, gr, mr, vr, scalars).reshape(-1)[:n]
    for got, want in ((p, pr), (m, mr), (v, vr)):
        assert torch.equal(got, want.reshape(-1)[:n])
    assert torch.equal(pbf, pbf_ref)


@pytest.mark.cuda
def test_layer_vjp_gives_every_row_leaf_a_gradient_on_the_card(cuda):
    """The layered step's backward on the card: the row gradient comes
    through the kernels' autograd Functions (flash backward, the tiled
    matmul's two gradient products), and every leaf of the row gets one."""
    from repro_torch import configs
    from repro_torch.config import RunConfig, make_offload, make_parallel
    from repro_torch.core import zero

    cfg = configs.get("smollm-135m")
    run = RunConfig(model=cfg, parallel=make_parallel("zero3", remat="none"),
                    offload=make_offload(opt_tier="nvme", param_tier="nvme",
                                         grad_tier="nvme"))
    eng = zero.ExplicitZero3Engine(run, cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    row = (torch.randn(eng.layout.padded, generator=g, device=cuda) * 0.02).to(torch.bfloat16)
    x = torch.randn(2, 128, cfg.d_model, generator=g, device=cuda).to(torch.bfloat16)
    dy = torch.randn(2, 128, cfg.d_model, generator=g, device=cuda).to(torch.bfloat16)
    ops.reset_launch_counts()
    dx, grow = eng.make_layer_fns()["layer_vjp"](x, row, dy)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
    # both on the tensor cores
    assert counts["flash_attention_wgmma"] == 1 and counts["flash_attention_bwd_wgmma"] == 1
    assert counts["tiled_matmul"] == 3 + 6  # 3 projections, 2 gradient products each
    assert counts["tiled_matmul_wgmma"] == 9  # every one on the tensor cores
    assert grow.dtype == torch.float32 and torch.isfinite(grow).all()
    off = 0
    for path, size in zip(eng.layout.paths, eng.layout.sizes):
        assert grow[off:off + size].abs().sum() > 0, path
        off += size
    assert torch.isfinite(dx).all() and dx.abs().sum() > 0


@pytest.mark.cuda
def test_pinned_stager_copies_rows_and_returns_buffers(cuda):
    from repro_torch.core.offload import PinnedBufferPool, PinnedStager

    pool = PinnedBufferPool(64 << 20, pin=True)
    stager = PinnedStager(pool, cuda)
    rows = [torch.randn(1 << 20).to(torch.bfloat16) for _ in range(5)]
    got = [stager.to_device(r) for r in rows]
    assert len(stager._pending) <= stager.max_inflight
    stager.retire(wait=True)
    assert not stager._pending and pool._outstanding == 0
    for r, d in zip(rows, got):
        assert d.device.type == "cuda" and torch.equal(d.cpu(), r)
    # a gap: the device copy's tail starts 10 elements later
    row = torch.arange(100, dtype=torch.int16)
    gapped = stager.to_device(row, gap=(36, 10))
    stager.retire(wait=True)
    assert gapped.shape == (110,)
    assert torch.equal(gapped[:36].cpu(), row[:36]) and torch.equal(gapped[46:].cpu(), row[36:])


def _q8(w: torch.Tensor):
    """A weight's q8 operands (int8 (K,N), fp16 (K,N/32)), on w's device."""
    q, s, _ = qformat.wire_matmul_operands(qformat.encode_array(w, "q8"))
    return q.to(w.device), s.to(w.device)


def _qmm_inputs(shape, transpose, dtype, seed, cols=None):
    """x and the q8 operands of a 0.1-scaled bf16 weight (K, N); with
    ``cols`` = (lo, hi), q and s are that column tile of a wider weight,
    cut as ``core/tiling.py:_slice`` cuts it."""
    M, K, N = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    width = N if cols is None else N + cols[0] + 64
    q, s = _q8((torch.randn(K, width, generator=g, device="cuda") * 0.1).to(torch.bfloat16))
    if cols is not None:
        lo, hi = cols
        q, s = q[:, lo:hi], s[:, lo // 32:hi // 32]
    x = (torch.randn(M, N if transpose else K, generator=g, device="cuda") * 0.1).to(dtype)
    return x, q, s


def _qmm_close(got, x, q, s, transpose, dtype):
    w_abs = qformat.dequant_q8(q, s).abs()
    mag = x.float().abs() @ (w_abs.T if transpose else w_abs)
    assert_close(got, ref.quantized_matmul_ref(x, q, s, transpose=transpose), mag,
                 dtype, f32_tol=1e-4, mtol=2**-12)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,transpose,cols", [
    ((4096, 576, 1536), False, None), ((4096, 1536, 576), False, None),
    ((4096, 576, 1536), True, None), ((4096, 1536, 576), True, None),
    ((100, 96, 64), False, None), ((100, 96, 64), True, None),
    # ragged: K and N multiples of no tile or stage; a column tile of q
    ((296, 200, 160), False, None), ((296, 200, 160), True, None),
    ((300, 576, 384), False, (64, 448)), ((300, 576, 384), True, (64, 448))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_matmul_kernel_matches_plain(cuda, shape, transpose, cols, dtype):
    """Both orientations: x (M,K) @ dequant(q (K,N)), and with ``transpose``
    x (M,N) @ dequant(q (K,N))^T, the dX product, on the route the rule
    names (bf16 on the tensor cores, f32 on the CUDA cores), held by the
    launch counters. The tensor cores multiply the weight as a bf16 hi + lo
    pair, which keeps it to ~16 bits, so the rule is the tiled matmul's
    (sums of up to 1536 terms in another order; tests/test_torch_tolerance.py
    emulates the pair against chip_smoke.py's check)."""
    from repro_torch.kernels import quantized_matmul as tqm

    x, q, s = _qmm_inputs(shape, transpose, dtype, 3, cols)
    want = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert tqm.route(x, q) == want
    key = "quantized_matmul_dx" if transpose else "quantized_matmul"
    got = _took(key, lambda: tqm.quantized_matmul_cuda(x, q, s, transpose=transpose), want)
    _qmm_close(got, x, q, s, transpose, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True])
def test_quantized_matmul_simt_route_on_request(cuda, transpose):
    """``simt=True`` runs the CUDA-core kernel on operands the tensor cores
    take (the previous design, timed beside the new one)."""
    from repro_torch.kernels import quantized_matmul as tqm

    x, q, s = _qmm_inputs((296, 200, 160), transpose, torch.bfloat16, 4)
    assert tqm.route(x, q) == "wgmma"
    key = "quantized_matmul_dx" if transpose else "quantized_matmul"
    got = _took(key, lambda: tqm.quantized_matmul_cuda(x, q, s, transpose=transpose,
                                                       simt=True), "simt")
    _qmm_close(got, x, q, s, transpose, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True])
def test_quantized_matmul_wgmma_repeats_to_the_bit(cuda, transpose):
    """No atomics and no split: two runs on the same inputs agree bit for
    bit."""
    from repro_torch.kernels import quantized_matmul as tqm

    x, q, s = _qmm_inputs((4096, 576, 1536), transpose, torch.bfloat16, 5)
    runs = [tqm.quantized_matmul_cuda(x, q, s, transpose=transpose) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_layer_vjp_on_a_wire_row_gives_every_leaf_a_gradient_on_the_card(cuda):
    """A q8 wire row on the card: the MLP projections go through the
    quantized kernel (forward, and dX in the backward), their dW through
    the tiled matmul into the zero anchor row, and every leaf of the row
    gets a gradient."""
    from repro_torch import configs
    from repro_torch.config import RunConfig, make_offload, make_parallel
    from repro_torch.core import offload, zero

    cfg = configs.get("smollm-135m")
    run = RunConfig(model=cfg, parallel=make_parallel("zero3", remat="none"),
                    offload=make_offload(opt_tier="nvme", param_tier="nvme",
                                         grad_tier="nvme", param_quant="q8"))
    eng = zero.ExplicitZero3Engine(run, cuda)
    assert [p[-1] for p in eng.quantized_leaves] == ["w_gate", "w_in", "w_out"]
    g = torch.Generator().manual_seed(0)
    row = (torch.randn(eng.layout.padded, generator=g) * 0.02).to(torch.bfloat16)
    stager = offload.PinnedStager(offload.PinnedBufferPool(64 << 20, pin=True), cuda)
    wire = qformat.wire_row_device(qformat.encode_array(row, "q8"), stager)
    x = torch.randn(2, 128, cfg.d_model, generator=g).to(cuda, torch.bfloat16)
    dy = torch.randn(2, 128, cfg.d_model, generator=g).to(cuda, torch.bfloat16)
    ops.reset_launch_counts()
    dx, grow = eng.make_layer_fns()["layer_vjp"](x, wire, dy)
    torch.cuda.synchronize()
    stager.retire(wait=True)
    counts = ops.launch_counts()
    assert counts["quantized_matmul"] == 3 and counts["quantized_matmul_dx"] == 3
    # every one on the tensor cores: the row's quants start on 16 bytes
    assert counts["quantized_matmul_wgmma"] == counts["quantized_matmul_dx_wgmma"] == 3
    assert counts["quantized_matmul_simt"] == counts["quantized_matmul_dx_simt"] == 0
    assert counts["tiled_matmul"] == 3  # the dW products
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
    assert grow.dtype == torch.float32 and torch.isfinite(grow).all()
    off = 0
    for path, size in zip(eng.layout.paths, eng.layout.sizes):
        assert grow[off:off + size].abs().sum() > 0, path
        off += size
    assert torch.isfinite(dx).all() and dx.abs().sum() > 0


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.cuda
def test_gemma_7b_prefill_and_decode_on_the_card_match_the_cpu(cuda):
    """Full-width gemma-7b (head_dim 256: flash on the tensor cores) cut to
    2 layers: teacher-forced prefill and decode logits on the card (kernels)
    against the CPU (plain versions) from the same weights, under
    chip_smoke.py's end-to-end tolerance."""
    cs = _chip_smoke()
    before = ops.launch_counts()
    rec = cs.phase_e2e("gemma-7b")
    after = ops.launch_counts()
    assert rec["max_rel_err"] <= cs.E2E_REL_TOL
    assert after["flash_attention_wgmma"] > before["flash_attention_wgmma"]
    assert after["flash_attention_simt"] == before["flash_attention_simt"]


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["in_graph", "off_graph", "host"])
def test_gspmd_step_on_the_card_matches_the_cpu(cuda, placement):
    """The GSPMD engine's step at 2 layers, full width: in-graph, off-graph
    (the optimizer on NVMe, remat full) and on the pinned host tier, the
    card (kernels) against the CPU (plain versions) from the same weights
    and batches, by chip_smoke.py's training bounds (``phase_gspmd_numerics``
    raises beyond them)."""
    rec = _chip_smoke().phase_gspmd_numerics(placement)
    assert rec["masters_worst_diff_over_drift"] <= 1.0
    assert rec["params_worst_diff_over_bound"] <= 1.0


@pytest.mark.cuda
def test_host_tier_is_pinned_and_repeats_the_device_tier_to_the_bit(cuda):
    """params and the optimizer on the host tier: page-locked CPU tensors
    before and after a step, and the same kernels on the same values, so
    two steps give the device tier's params and masters bit for bit."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.config import RunConfig, ShapeConfig, make_offload, make_parallel
    from repro_torch.core import partition as pt
    from repro_torch.core.executor import InfinityExecutor
    from repro_torch.data.pipeline import SyntheticStream

    cfg = dataclasses.replace(configs.get("smollm-135m"), n_layers=2)
    out = {}
    for tier in ("device", "host"):
        run = RunConfig(model=cfg, parallel=make_parallel("pjit", remat="none"),
                        offload=make_offload(param_tier=tier, opt_tier=tier))
        ex = InfinityExecutor(run, cuda)
        state = ex.init_state(torch.Generator(device=cuda).manual_seed(0))
        stream = SyntheticStream(ex.input_specs(ShapeConfig("t", 128, 2, "train")),
                                 cfg.vocab_size)
        step = ex.make_train_step()
        for i in range(2):
            batch = {k: torch.from_numpy(a).to(cuda) for k, a in stream.batch_at(i).items()}
            state, _ = step(state, batch)
        ex.wait_host()
        leaves = pt.tree_leaves(state["params"]) + pt.tree_leaves(state["opt"].master)
        if tier == "host":
            assert all(t.device.type == "cpu" and t.is_pinned() for t in leaves)
        else:
            assert all(t.device.type == "cuda" for t in leaves)
        out[tier] = [t.cpu() for t in leaves]
    for a, b in zip(out["device"], out["host"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["in_graph", "host"])
def test_zero3_step_on_the_card_matches_the_cpu(cuda, placement):
    """The explicit engine's monolithic step (2 layers, full width), in-graph
    on the device and with the flat and its optimizer on the pinned host
    tier, card against CPU from the same state and batches, by chip_smoke's
    training bounds (``phase_zero3_numerics`` raises beyond them)."""
    rec = _chip_smoke().phase_zero3_numerics(placement)
    assert rec["masters_worst_diff_over_drift"] <= 1.0
    assert rec["flat_worst_diff_over_bound"] <= 1.0


@pytest.mark.cuda
def test_checkpoint_of_a_pinned_host_tier_state_restores_bit_for_bit(cuda, tmp_path):
    """The explicit engine with the flat and its optimizer pinned on the
    host: a checkpoint saved after one step holds that step's values even
    though the next step rewrites the pinned leaves in place while it
    persists; restored, the leaves are pinned again, and a step from them
    repeats the second step bit for bit."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager, flatten_with_keys
    from repro_torch.config import RunConfig, ShapeConfig, make_offload, make_parallel
    from repro_torch.core.executor import InfinityExecutor
    from repro_torch.data.pipeline import SyntheticStream

    cfg = dataclasses.replace(configs.get("smollm-135m"), n_layers=2)
    run = RunConfig(model=cfg, parallel=make_parallel("zero3", remat="none"),
                    offload=make_offload(param_tier="host", opt_tier="host"))
    ex = InfinityExecutor(run, cuda)
    state = ex.init_state(torch.Generator(device=cuda).manual_seed(0))
    stream = SyntheticStream(ex.input_specs(ShapeConfig("t", 128, 2, "train")),
                             cfg.vocab_size)
    batches = [{k: torch.from_numpy(a).to(cuda) for k, a in stream.batch_at(i).items()}
               for i in range(2)]
    step = ex.make_train_step()
    state, _ = step(state, batches[0])
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, ex.checkpoint_state(state), {"next_step": 1})
    want = {k: v.cpu().clone() for k, v in flatten_with_keys(state).items()}
    state, m2 = step(state, batches[1])  # rewrites the pinned leaves in place
    ex.wait_host()
    mgr.wait()
    assert not torch.equal(state["flat"], want["flat"])
    restored, extra = mgr.restore(state)
    for key, leaf in flatten_with_keys(restored).items():
        assert torch.equal(leaf, want[key]), key
    again = ex.restore_state(restored, step=extra["next_step"])
    assert all(again[k].is_pinned() for k in ("flat", "master", "m", "v"))
    again, m2_again = step(again, batches[1])
    ex.wait_host()
    assert float(m2_again["loss"]) == float(m2["loss"])
    assert torch.equal(again["flat"], state["flat"])
    ex.close()


@pytest.mark.cuda
def test_detect_reports_the_card(cuda):
    from repro_torch import plan

    hw = plan.HardwareSpec.detect()
    assert hw.n_devices == torch.cuda.device_count() >= 1 and hw.source == "detected"
    assert hw.device_mem == torch.cuda.mem_get_info(0)[1] > 0
    assert hw.host_mem > 0 and hw.nvme_capacity >= 0


@pytest.mark.cuda
def test_moe_layer_repeats_to_the_bit_on_the_card(cuda):
    """One full-width granite-moe-1b-a400m layer at the training shape, loss
    and gradients twice from the same weights and batch: equal bits (the
    combine and the dispatch's backward gather in a fixed order; no
    atomics). ``phase_moe_repeat`` raises on any differing leaf."""
    rec = _chip_smoke().phase_moe_repeat()
    assert rec["differing"] == [] and rec["leaves"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gspmd", "layered"])
def test_moe_steps_on_the_card_match_the_cpu(cuda, kind):
    """granite-moe-1b-a400m at full width cut to 2 layers: 2 steps of the
    GSPMD step (all on the device) and of the layered epoch (every state on
    NVMe, expert rows paged), card against CPU from the same weights and
    batches, by chip_smoke.py's row and master bounds
    (``phase_moe_numerics`` raises beyond them)."""
    rec = _chip_smoke().phase_moe_numerics(kind)
    assert rec["masters_worst_diff_over_drift"] <= 1.0
    assert rec["params_worst_diff_over_bound"] <= 1.0
    assert rec["bulk_mean_abs_diff"] <= rec["params_mean_bound"]


@pytest.mark.cuda
def test_remat_dots_saves_the_tiled_matmul_output_on_the_card(cuda):
    """A block ``relu(x @ w1) @ w2`` under ``remat="dots"``: the kernel's
    products are saved by the selective checkpoint (two forward launches,
    none again in the backward; four gradient products), where ``full``
    launches the forward twice more; the gradients equal ``none``'s."""
    from repro_torch.models import remat

    g = torch.Generator(device=cuda).manual_seed(0)
    x0 = (torch.randn(256, 128, generator=g, device=cuda) * 0.1).to(torch.bfloat16)
    w10 = (torch.randn(128, 256, generator=g, device=cuda) * 0.1).to(torch.bfloat16)
    w20 = (torch.randn(256, 128, generator=g, device=cuda) * 0.1).to(torch.bfloat16)

    def block(x, w1, w2):
        return ops.tiled_matmul(torch.relu(ops.tiled_matmul(x, w1)), w2)

    out, launches = {}, {}
    for policy in ("none", "full", "dots"):
        x, w1, w2 = (t.clone().requires_grad_() for t in (x0, w10, w20))
        before = ops.launch_counts()["tiled_matmul"]
        y = remat.remat(policy, block, x, w1, w2)
        y.float().square().sum().backward()
        torch.cuda.synchronize()
        launches[policy] = ops.launch_counts()["tiled_matmul"] - before
        out[policy] = [t.grad for t in (x, w1, w2)]
    assert launches == {"none": 2 + 4, "full": 2 + 2 + 4, "dots": 2 + 4}
    for got, want in zip(out["dots"], out["none"]):
        assert torch.equal(got, want)
