"""``chip_smoke.py``'s kernel tolerances against faulty kernels, on the CPU.

The CUDA kernels run only on the card, so their arithmetic is emulated
here in float64: the CUDA-core (simt) flash kernel's K/V tiles of 32 keys,
online softmax against the running max and p rounded to the input type
before P@V; the tensor-core (wgmma) flash kernels' -- K/V tiles of 64 keys
zero-filled past Sk as TMA lands them, bf16 P against the running max per
tile in the forward, bf16 P for dV and dS as a bf16 hi + lo pair for dQ and
dK in the backward, with and without a local window, at head_dim 64, 192
and 256 (above 128 a dK/dV block forms the same products on one slab of
head_dim); the tiled matmul's exact sum rounded once; the
tensor-core quantized matmul's -- each weight element w = q * s formed once
in f32 (exact: a 7-bit integer times an 11-bit significand), split into
hi = bf16(w) and lo = bf16(w - hi), and x @ hi + x @ lo summed exactly and
rounded once to the output type. The emulation stands for the kernel
because every step the kernel takes that can lose a bit is in it: the two
bf16 roundings of the split and the output rounding; the tensor cores'
products of bf16 values are exact and their f32 sums of at most 1536
terms sit far below the tolerance's 2^-12 share (as the tiled matmul's).
Each emulation must pass ``chip_smoke.compare`` against the plain version
under the unchanged ``TOL``, and each mutant of it (a fault the kernel
could carry) must fail there, so the check on the card can tell a faulty
kernel from a right one.
"""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import qformat  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BK = 32  # keys per K/V tile of the simt kernel in csrc/flash_attention.cu
NEG = -1e30


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


# ---------------------------------------------------------------------------
# the tensor-core (wgmma) kernels
# ---------------------------------------------------------------------------


def _keep(Sq, Sk, *, causal=True, shift=0, past_sk=False, drop=None, window=0, wshift=0):
    """The (Sq, Sk + padding to whole BKV tiles) mask the kernels apply:
    keys below Sk and, when causal, ``j <= i + (Sk - Sq)``; with a window
    also ``j > i + (Sk - Sq) - window``. Mutations: ``shift`` moves the
    causal edge, ``wshift`` the window's, ``past_sk`` keeps the zero-filled
    keys past Sk (under causal they lie past the frontier too, so only the
    non-causal form can show it), ``drop`` loses one K/V tile."""
    nk = -(-Sk // tfa.BKV) * tfa.BKV
    i = torch.arange(Sq)[:, None]
    j = torch.arange(nk)[None, :]
    keep = ((j <= i + (Sk - Sq) + shift) | (not causal)) & ((j < Sk) | past_sk)
    if window:
        keep &= j > i + (Sk - Sq) - window + wshift
    if drop is not None:
        keep &= (j // tfa.BKV) != drop
    return keep


def _padded(t, Sk):
    """k or v with the zero keys TMA lands past Sk, to whole BKV tiles."""
    nk = -(-Sk // tfa.BKV) * tfa.BKV
    return torch.nn.functional.pad(t, (0, 0, 0, nk - Sk))


def emulate_flash_wgmma(q, k, v, **mutation):
    """The wgmma forward for q (B,H,Sq,D), k/v (B,KV,Sk,D): per K/V
    tile of BKV keys, S, the mask, the online softmax against the running
    max (l sums f32 p), p rounded to bf16 for the RS product P@V."""
    B, H, Sq, D = q.shape
    Sk, n_rep = k.shape[2], H // k.shape[1]
    qf = q.double()
    kf = _padded(k, Sk).repeat_interleave(n_rep, 1).double()
    vf = _padded(v, Sk).repeat_interleave(n_rep, 1).double()
    keep = _keep(Sq, Sk, **mutation)
    m = torch.full((B, H, Sq, 1), NEG, dtype=torch.float64)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, H, Sq, D, dtype=torch.float64)
    for t in range(kf.shape[2] // tfa.BKV):
        keys = slice(t * tfa.BKV, (t + 1) * tfa.BKV)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, keys]) * D ** -0.5
        s = torch.where(keep[:, keys], s, torch.tensor(NEG, dtype=torch.float64))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p = p.to(torch.bfloat16).double()
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vf[:, :, keys])
        m = m_new
    return (acc / l).to(q.dtype)


def emulate_flash_bwd_wgmma(q, k, v, o, lse, do, *, hilo=True, twice=None, extra=None,
                            slab_from=None, **mutation):
    """The wgmma backward's dq, dk, dv from the forward's o and lse: P =
    exp(S scale - lse) under the mask, dV = sum over the group of
    bf16(P)^T dO, dS = P (dP - delta) carried as hi = bf16(dS) plus
    lo = bf16(dS - hi) (``hilo=False``: hi alone), dQ = scale dS K and
    dK = scale sum over the group of dS^T Q. Above head_dim 128 a dK/dV
    block accumulates one slab of head_dim: the same products, column by
    column. Mutations: ``twice`` sums one query head of each group twice
    into dK/dV; ``extra`` = (q, dO, o, lse) rows past Sq that a kernel
    reading on without masking would take into dK/dV (they see every key);
    ``slab_from`` = s has every slab's dK and dV read slab s's columns of
    Q and dO (a slab offset lost)."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    n_rep, scale = H // KV, D ** -0.5
    keep = _keep(Sq, Sk, **mutation)[:, :Sk]
    if extra is not None:
        q, do, o, lse = (torch.cat([a, b], 2) for a, b in zip((q, do, o, lse), extra))
        keep = torch.cat([keep, torch.ones(q.shape[2] - Sq, Sk, dtype=torch.bool)])
    kr = k.repeat_interleave(n_rep, 1).double()
    vr = v.repeat_interleave(n_rep, 1).double()
    qf, dof = q.double(), do.double()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kr) * scale
    p = torch.where(keep, torch.exp(s - lse.double()[..., None]),
                    torch.zeros((), dtype=torch.float64))
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)
    ds = p * (dp - (dof * o.double()).sum(-1, keepdim=True))
    hi = ds.to(torch.bfloat16).double()
    dsr = hi + (ds - hi).to(torch.bfloat16).double() if hilo else hi
    dq = torch.einsum("bhqk,bhkd->bhqd", dsr, kr)[:, :, :Sq] * scale
    qs, dos = qf, dof
    if slab_from is not None:
        w = tfa.SLAB[D]
        qs, dos = (t[..., slab_from * w:(slab_from + 1) * w].repeat(1, 1, 1, D // w)
                   for t in (qf, dof))
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(torch.bfloat16).double(), dos)
    dk = torch.einsum("bhqk,bhqd->bhkd", dsr, qs) * scale
    if twice is not None:  # head `twice` of every group counted again
        heads = torch.arange(H) % n_rep == twice
        dk = dk + torch.where(heads[:, None, None], dk, 0.0)
        dv = dv + torch.where(heads[:, None, None], dv, 0.0)
    dk = dk.reshape(B, KV, n_rep, Sk, D).sum(2)
    dv = dv.reshape(B, KV, n_rep, Sk, D).sum(2)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# the training cell's heads, length and head_dim (B = 1; chip_smoke draws B =
# 8), and chip_smoke.py's ragged shape: Sq < Sk, neither a multiple of a tile
WG_TRAIN = (1, 9, 3, 512, 512, 64)
WG_RAGGED = (1, 6, 2, 100, 132, 64)


def _draw(shape, seed=0, extra_rows=0):
    """q, k, v, dO as chip_smoke draws them (unit variance, (B,S,H,D)
    storage seen as (B,H,S,D)), bf16; q and dO with ``extra_rows`` more
    rows past Sq."""
    B, H, KV, Sq, Sk, D = shape
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    q, do = (torch.randn(B, Sq + extra_rows, H, D, generator=g).to(bf).transpose(1, 2)
             for _ in range(2))
    k, v = (torch.randn(B, Sk, KV, D, generator=g).to(bf).transpose(1, 2) for _ in range(2))
    return q, k, v, do


def _check_wgmma_fwd(shape, causal=True, window=0, **mutation):
    q, k, v, _ = _draw(shape)
    return _chip_smoke().compare(
        "flash_attention", shape, torch.bfloat16,
        emulate_flash_wgmma(q, k, v, causal=causal, window=window, **mutation),
        ref.attention_ref(q, k, v, causal=causal, window=window),
        ref.attention_ref(q, k, v.abs(), causal=causal, window=window))


def _check_wgmma_bwd(shape, seed=0, rows_past_sq=False, window=0, **mutation):
    """Each of dq, dk, dv against the plain backward from the same saved o
    and lse, as ``chip_smoke.check_flash_bwd`` holds the kernel."""
    Sq = shape[3]
    pad = (-Sq) % tfa.BQB if rows_past_sq else 0
    q, k, v, do = _draw(shape, seed, extra_rows=pad)
    extra = None
    if pad:  # the rows past Sq see every key, as an unmasked kernel lets them
        ox, lsex = ref.attention_fwd_ref(q, k, v, causal=False)
        extra = (q[:, :, Sq:], do[:, :, Sq:], ox[:, :, Sq:], lsex[:, :, Sq:])
        q, do = q[:, :, :Sq], do[:, :, :Sq]
    o, lse = ref.attention_fwd_ref(q, k, v, causal=True, window=window)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=window)
    got = emulate_flash_bwd_wgmma(q, k, v, o, lse, do, extra=extra, window=window, **mutation)
    cs = _chip_smoke()
    return [cs.compare("flash_attention_bwd", shape, torch.bfloat16, g, w, w.float().abs().max())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("shape", [WG_TRAIN, WG_RAGGED], ids=["train", "ragged"])
def test_wgmma_flash_tolerance_passes_the_tensor_core_arithmetic(shape):
    assert _check_wgmma_fwd(shape)["worst_err_over_tol"] <= 1.0
    assert _check_wgmma_fwd(shape, causal=False)["worst_err_over_tol"] <= 1.0
    # the hi + lo pair stays well inside the backward's tolerance
    assert max(r["worst_err_over_tol"] for r in _check_wgmma_bwd(shape)) <= 0.6


@pytest.mark.parametrize("shape,mutation", [
    (WG_TRAIN, {"drop": 3}), (WG_TRAIN, {"drop": 7}), (WG_TRAIN, {"shift": 1}),
    (WG_TRAIN, {"shift": -1}), (WG_RAGGED, {"past_sk": True, "causal": False})],
    ids=["lost-mid-tile", "lost-last-tile", "causal+1", "causal-1", "key-past-Sk-unmasked"])
def test_wgmma_flash_tolerance_rejects_a_faulty_forward(shape, mutation):
    with pytest.raises(SystemExit, match="FAIL flash_attention"):
        _check_wgmma_fwd(shape, **mutation)


@pytest.mark.parametrize("shape,mutation", [
    (WG_TRAIN, {"drop": 3}), (WG_TRAIN, {"shift": 1}), (WG_TRAIN, {"shift": -1}),
    (WG_RAGGED, {"rows_past_sq": True}), (WG_TRAIN, {"twice": 0}), (WG_TRAIN, {"twice": 2})],
    ids=["lost-key-tile", "causal+1", "causal-1", "query-row-past-Sq-unmasked",
         "gqa-head-0-summed-twice", "gqa-head-2-summed-twice"])
def test_wgmma_flash_tolerance_rejects_a_faulty_backward(shape, mutation):
    with pytest.raises(SystemExit, match="FAIL flash_attention_bwd"):
        _check_wgmma_bwd(shape, **mutation)


def test_single_bf16_ds_does_not_fit_the_backward_tolerance():
    """Why the kernels carry dS as a hi + lo pair: rounded once to bf16, dS
    takes an element of dK past the unchanged tolerance at two batches of
    the training cell's heads (chip_smoke times eight); the pair does not."""
    shape = (2, 9, 3, 512, 512, 64)
    with pytest.raises(SystemExit, match="FAIL flash_attention_bwd"):
        _check_wgmma_bwd(shape, hilo=False)
    assert max(r["worst_err_over_tol"] for r in _check_wgmma_bwd(shape)) <= 0.6


# recurrentgemma-9b's heads (16 on one KV head, head_dim 256) under a
# window, cut from 4096 tokens and a window of 2048 to 512 and 192 (the
# emulation holds every score in float64); nemotron-4-340b's head_dim 192
# and its 12 query heads a KV head, cut from 96 / 8 heads to 24 / 2
WG_WIDE = {"recurrentgemma": ((1, 16, 1, 512, 512, 256), 192),
           "nemotron": ((1, 24, 2, 256, 256, 192), 0)}


@pytest.mark.parametrize("case", list(WG_WIDE))
def test_wgmma_flash_tolerance_passes_at_head_dims_256_and_192(case):
    """The tensor-core arithmetic at the wide heads, the window's per-element
    edge included, fits the unchanged tolerances; the backward's hi + lo
    pair stays inside its own (reads 0.32 at recurrentgemma's heads, 0.61
    at nemotron's, where dK sums 12 heads and its own output rounding
    leads: dS rounded once reads 0.64 there)."""
    shape, window = WG_WIDE[case]
    assert _check_wgmma_fwd(shape, window=window)["worst_err_over_tol"] <= 1.0
    assert max(r["worst_err_over_tol"] for r in _check_wgmma_bwd(shape, window=window)) <= 0.75


@pytest.mark.parametrize("case,mutation", [
    ("recurrentgemma", {"wshift": 1}), ("recurrentgemma", {"wshift": -1}),
    ("recurrentgemma", {"drop": 5}), ("nemotron", {"shift": 1})],
    ids=["window-edge+1", "window-edge-1", "lost-tile-in-window", "causal+1"])
def test_wgmma_flash_tolerance_rejects_a_faulty_wide_forward(case, mutation):
    shape, window = WG_WIDE[case]
    with pytest.raises(SystemExit, match="FAIL flash_attention"):
        _check_wgmma_fwd(shape, window=window, **mutation)


@pytest.mark.parametrize("case,mutation", [
    ("recurrentgemma", {"wshift": 1}), ("recurrentgemma", {"wshift": -1}),
    ("recurrentgemma", {"slab_from": 0}), ("nemotron", {"slab_from": 2}),
    ("nemotron", {"twice": 11})],
    ids=["window-edge+1", "window-edge-1", "slab-offset-lost-256", "slab-offset-lost-192",
         "gqa-head-11-summed-twice"])
def test_wgmma_flash_tolerance_rejects_a_faulty_wide_backward(case, mutation):
    shape, window = WG_WIDE[case]
    with pytest.raises(SystemExit, match="FAIL flash_attention_bwd"):
        _check_wgmma_bwd(shape, window=window, **mutation)


# ---------------------------------------------------------------------------
# the tensor-core (wgmma) quantized matmul
# ---------------------------------------------------------------------------

QMM_BK = 64  # contraction elements per ring stage of the wgmma kernel


def _qmm_weight(q, s, mutant=None):
    """The (K, N) f64 weight the kernel multiplies: w = q * s, exact.
    Mutants: ``neighbour-scale`` takes each element's scale from the next
    32-block of its row; ``scale-axis`` reads s as if its blocks ran down
    the columns (element (k, n) takes flat scale (n K + k) / 32)."""
    K, N = q.shape
    qd = q.double()
    if mutant == "neighbour-scale":
        s = s.roll(-1, dims=1)
    if mutant == "scale-axis":
        k, n = torch.meshgrid(torch.arange(K), torch.arange(N), indexing="ij")
        return qd * s.reshape(-1).double()[(n * K + k) // qformat.BLOCK]
    return qd * s.double().repeat_interleave(qformat.BLOCK, dim=1)


def emulate_qmm_wgmma(x, q, s, transpose, *, pair=True, mutant=None):
    """The wgmma quantized matmul's arithmetic: w split into hi + lo
    (``pair=False``: hi alone, one bf16 rounding), both products summed
    exactly, the output rounded once to x's dtype. Mutants beside
    ``_qmm_weight``'s: ``lost-k-slice`` drops the second ring stage's
    contraction slice, ``lo-dropped`` skips the second product."""
    w = _qmm_weight(q, s, mutant)
    hi = w.to(torch.bfloat16).double()
    lo = (w - hi).to(torch.bfloat16).double()
    wk = hi + lo if pair and mutant != "lo-dropped" else hi
    wk = wk.T if transpose else wk
    xd = x.double()
    if mutant == "lost-k-slice":
        keep = torch.ones(wk.shape[0], dtype=torch.bool)
        keep[QMM_BK:2 * QMM_BK] = False
        xd, wk = xd[:, keep], wk[keep]
    return (xd @ wk).to(x.dtype)


def _qmm_check(case, rows=None, **kw):
    """One ``chip_smoke.QMM_TRAIN`` case drawn as chip_smoke draws it (the
    port's q8 encoder on a 0.1-scaled bf16 weight, x at 0.1), the emulation
    held by ``chip_smoke.compare`` under the bf16 quantized ``TOL``;
    ``rows`` keeps the first rows of x (the mutants fail on any)."""
    M, K, N, transpose = case
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(K, N, generator=g) * 0.1).to(torch.bfloat16)
    q, s, _ = qformat.wire_matmul_operands(qformat.encode_array(w, "q8"))
    x = (torch.randn(M, N if transpose else K, generator=g) * 0.1).to(torch.bfloat16)
    if rows is not None:
        x = x[:rows]
    w_abs = qformat.dequant_q8(q, s).abs()
    mag = x.float().abs() @ (w_abs.T if transpose else w_abs)
    return _chip_smoke().compare(
        "quantized_matmul", (x.shape[0], K, N), torch.bfloat16,
        emulate_qmm_wgmma(x, q, s, transpose, **kw),
        ref.quantized_matmul_ref(x, q, s, transpose=transpose), mag)


def _qmm_cases():
    return _chip_smoke().QMM_TRAIN


@pytest.mark.parametrize("i", range(4), ids=["fwd-576x1536", "fwd-1536x576",
                                             "dx-576x1536", "dx-1536x576"])
def test_qmm_hi_lo_pair_fits_the_quantized_tolerance(i):
    """The kernel's hi + lo pair at each training shape stays under the
    unchanged ``TOL[("quantized_matmul", bf16)]`` (reads 0.7-0.85 of it)."""
    assert _qmm_check(_qmm_cases()[i])["worst_err_over_tol"] <= 0.9


@pytest.mark.parametrize("i", range(4), ids=["fwd-576x1536", "fwd-1536x576",
                                             "dx-576x1536", "dx-1536x576"])
def test_qmm_single_bf16_rounding_does_not_fit(i):
    """Why the kernel carries the weight as a pair: w rounded once to bf16
    takes an element past the tolerance at every training shape."""
    with pytest.raises(SystemExit, match="FAIL quantized_matmul"):
        _qmm_check(_qmm_cases()[i], pair=False)


@pytest.mark.parametrize("i,mutant", [
    (0, "neighbour-scale"), (1, "neighbour-scale"), (2, "scale-axis"), (3, "scale-axis"),
    (0, "lost-k-slice"), (3, "lost-k-slice"), (1, "lo-dropped"), (2, "lo-dropped")])
def test_qmm_tolerance_rejects_a_faulty_kernel(i, mutant):
    rows = None if mutant == "lo-dropped" else 256
    with pytest.raises(SystemExit, match="FAIL quantized_matmul"):
        _qmm_check(_qmm_cases()[i], rows=rows, mutant=mutant)
