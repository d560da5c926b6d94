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


def _routed(x, w, want):
    """``ops.tiled_matmul`` on the route ``want``, held by the counters: one
    launch on that route, none on the other."""
    assert tmm.route(x, w) == want
    before = ops.launch_counts()
    got = ops.tiled_matmul(x, w)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["tiled_matmul"] == before["tiled_matmul"] + 1
    for r in tmm.ROUTES:
        key = f"tiled_matmul_{r}"
        assert after[key] == before[key] + (r == want), (r, before, after)
    return got


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
    for t in ["", "x", "w", "xw"]] + [((4, 576, 1536), ""), ((4, 576, 1536), "w")])
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
    assert_close(got, ref.matmul_ref(x, w), ref.matmul_ref(x.abs(), w.abs()),
                 torch.bfloat16, f32_tol=None, mtol=2**-11 if K > 1536 else 2**-12)


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
                                   (2, 4, 1, 64, 64, 128), (1, 2, 2, 40, 40, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_matches_plain(cuda, shape, dtype):
    B, H, KV, Sq, Sk, D = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    q, do = (torch.randn(B, Sq, H, D, generator=g, device=cuda).to(dtype).transpose(1, 2)
             for _ in range(2))
    k, v = (torch.randn(B, Sk, KV, D, generator=g, device=cuda).to(dtype).transpose(1, 2)
            for _ in range(2))
    o, lse = tfa.flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    o_ref, lse_ref = ref.attention_fwd_ref(q, k, v, causal=True)
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    before = ops.launch_counts()["flash_attention_bwd"]
    got = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_bwd"] == before + 1
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    for a, b, t in zip(got, want, (q, k, v)):
        assert a.stride() == t.stride() and a.dtype == dtype
        _bwd_close(a, b, dtype)


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


def _q8(w: torch.Tensor):
    """A weight's q8 operands (int8 (K,N), fp16 (K,N/32)), on w's device."""
    q, s, _ = qformat.wire_matmul_operands(qformat.encode_array(w, "q8"))
    return q.to(w.device), s.to(w.device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,transpose", [((4096, 576, 1536), False),
                                             ((4096, 1536, 576), False),
                                             ((4096, 576, 1536), True),
                                             ((4096, 1536, 576), True),
                                             ((100, 96, 64), False), ((100, 96, 64), True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_matmul_kernel_matches_plain(cuda, shape, transpose, dtype):
    """Both orientations: x (M,K) @ dequant(q (K,N)), and with ``transpose``
    x (M,N) @ dequant(q (K,N))^T, the dX product. The dequantized weight is
    the same f32 product in both versions, so the rule is the tiled
    matmul's (sums of up to 1536 terms in another order)."""
    from repro_torch.kernels import quantized_matmul as tqm

    M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(3)
    q, s = _q8((torch.randn(K, N, generator=g, device=cuda) * 0.1).to(torch.bfloat16))
    x = (torch.randn(M, N if transpose else K, generator=g, device=cuda) * 0.1).to(dtype)
    key = "quantized_matmul_dx" if transpose else "quantized_matmul"
    before = ops.launch_counts()[key]
    got = tqm.quantized_matmul_cuda(x, q, s, transpose=transpose)
    torch.cuda.synchronize()
    assert ops.launch_counts()[key] == before + 1
    w_abs = qformat.dequant_q8(q, s).abs()
    mag = x.float().abs() @ (w_abs.T if transpose else w_abs)
    assert_close(got, ref.quantized_matmul_ref(x, q, s, transpose=transpose), mag,
                 dtype, f32_tol=1e-4, mtol=2**-12)


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
    assert counts["tiled_matmul"] == 3  # the dW products
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
    assert grow.dtype == torch.float32 and torch.isfinite(grow).all()
    off = 0
    for path, size in zip(eng.layout.paths, eng.layout.sizes):
        assert grow[off:off + size].abs().sum() > 0, path
        off += size
    assert torch.isfinite(dx).all() and dx.abs().sum() > 0
