"""Flash attention's routing rule and launch plan, on the CPU.

``kernels/flash_attention.py:route`` sends a call to the tensor-core
(``wgmma``) kernels when its operands are bf16 of head_dim 64, 128, 192 or
256 and TMA can describe each, else to the CUDA-core (``simt``) kernels.
These tests hold the rule at the operands the main paths hand the kernels
-- ``attention_block``'s (B,S,H,D) storage seen as (B,H,S,D) views, at the
full width of smollm-135m (head_dim 64), llama-3.2-3b (128), gemma-7b
(256) and nemotron-4-340b (192) -- and at the cases that must stay on
``simt``; and ``plan``'s grids against a brute-force count of the (query
tile, key tile) pairs the causal mask and the window leave, with the dQ
tiles and dK/dV slabs of head_dim 192 and 256. The kernels themselves run
only on the card (``tests/test_torch_cuda.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402

BF16 = torch.bfloat16
MODELS = ["smollm-135m", "llama3.2-3b"]
# (B, Sq, Sk): a prefill wave of the serve cell (4 slots x 512 tokens), the
# training cell's batch (8 x 512), and chip_smoke.py's ragged shape
SHAPES = {"serve": (4, 512, 512), "train": (8, 512, 512), "ragged": (1, 100, 132)}


def _views(cfg, B, Sq, Sk, dtype=BF16):
    """q, k, v and dO as ``attention_block`` hands them to the kernels:
    (B,S,H,D) storage seen as (B,H,S,D); dO is the gradient of the output's
    transposed view, (B,S,H,D) storage too."""
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, do = (torch.zeros(B, Sq, H, D, dtype=dtype).transpose(1, 2) for _ in range(2))
    k, v = (torch.zeros(B, Sk, KV, D, dtype=dtype).transpose(1, 2) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("model", MODELS)
def test_main_path_operands_take_the_tensor_cores(model, shape):
    cfg = configs.get(model)
    q, k, v, do = _views(cfg, *SHAPES[shape])
    assert tfa.route(q, k, v) == "wgmma"       # the forward
    assert tfa.route(q, k, v, do) == "wgmma"   # the backward reads dO too
    B, H, D = q.shape[0], cfg.n_heads, cfg.resolved_head_dim
    # a batch of one is never stepped: its stride goes to TMA as 8
    assert tfa.tma_strides(q) == (q.shape[2] * H * D if B > 1 else 8, D, H * D)


def _block_operands(cfg, monkeypatch, Sk=0):
    """The flash operands ``attention_block`` passes, forward and backward,
    on a (2, 24) input at full width; ``Sk`` > 0 cross-attends a memory of
    Sk positions (``kv_source``)."""
    H, KV, D, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_model
    g = torch.Generator().manual_seed(0)
    p = {name: (torch.randn(*shape, generator=g) * 0.02).to(BF16).requires_grad_()
         for name, shape in (("wq", (d, H, D)), ("wk", (d, KV, D)), ("wv", (d, KV, D)),
                             ("wo", (H, D, d)))}
    B, S = 2, 24
    x = torch.randn(B, S, d, generator=g).to(BF16)
    mem = torch.randn(B, Sk, d, generator=g).to(BF16) if Sk else None
    seen = {}
    real_fwd, real_bwd = ops.flash_attention, ref.attention_bwd_ref

    def fwd(q, k, v, **kw):
        seen["fwd"] = (q, k, v)
        seen["causal"] = kw["causal"]
        return real_fwd(q, k, v, **kw)

    def bwd(q, k, v, o, lse, do, **kw):
        seen["bwd"] = (q, k, v, do)
        return real_bwd(q, k, v, o, lse, do, **kw)

    monkeypatch.setattr(ops, "flash_attention", fwd)
    monkeypatch.setattr(ref, "attention_bwd_ref", bwd)
    out, _ = tcm.attention_block(p, x, torch.arange(S).expand(B, S), cfg, kv_source=mem)
    out.float().square().sum().backward()
    return seen


@pytest.mark.parametrize("model", MODELS)
def test_attention_block_hands_the_kernels_views_they_route_to_the_tensor_cores(
        model, monkeypatch):
    """The operands ``models/common.attention_block`` really passes, forward
    and (through the autograd Function) backward, at full width."""
    seen = _block_operands(configs.get(model), monkeypatch)
    assert tfa.route(*seen["fwd"]) == "wgmma"
    assert tfa.route(*seen["bwd"]) == "wgmma"
    assert seen["bwd"][3].stride(-1) == 1


@pytest.mark.parametrize("model,Sk", [("llava-next-34b", 0), ("seamless-m4t-medium", 0),
                                      ("seamless-m4t-medium", 96)])
def test_the_vlm_and_encdec_blocks_hand_the_kernels_tensor_core_views(model, Sk, monkeypatch):
    """llava's 56 query heads on 8 KV heads of 128, and seamless's 16 heads
    of 64 in self-attention and cross-attending a memory four times the
    queries' length (not causal, Sq != Sk), forward and backward."""
    cfg = configs.get(model)
    seen = _block_operands(cfg, monkeypatch, Sk)
    q, k, _ = seen["fwd"]
    assert q.shape[1:] == (cfg.n_heads, 24, cfg.resolved_head_dim)
    assert k.shape[1:] == (cfg.n_kv_heads, Sk or 24, cfg.resolved_head_dim)
    assert seen["causal"] == (Sk == 0)
    assert tfa.route(*seen["fwd"]) == "wgmma"
    assert tfa.route(*seen["bwd"]) == "wgmma"


def test_what_tma_cannot_take_stays_on_the_cuda_cores():
    cfg = configs.get("smollm-135m")
    q, k, v, do = _views(cfg, 1, 100, 132)
    # f32: wgmma's only f32 input is TF32
    assert tfa.route(*_views(cfg, 1, 100, 132, torch.float32)[:3]) == "simt"
    # mixed dtypes never take the tensor cores
    assert tfa.route(q, k.float(), v) == "simt"
    # head_dim 32: no tensor-core kernel
    q32 = torch.zeros(1, 2, 40, 32, dtype=BF16)
    assert tfa.route(q32, q32[:, :1], q32[:, :1]) == "simt"
    # a row stride of 68 elements (136 bytes), not a multiple of 16 bytes
    wide = torch.zeros(1, 100, 9, 68, dtype=BF16)[..., :64].transpose(1, 2)
    assert tfa.tma_strides(wide) is None and tfa.route(wide, k, v) == "simt"
    # a view offset by one element: base 2 bytes off a 16-byte boundary
    buf = torch.zeros(100 * 9 * 64 + 8, dtype=BF16)
    off = buf[1:1 + 100 * 9 * 64].view(1, 100, 9, 64).transpose(1, 2)
    assert tfa.route(off, k, v) == "simt"
    assert tfa.route(buf[8:].view(1, 100, 9, 64).transpose(1, 2), k, v) == "wgmma"
    # the last dim not contiguous
    assert tfa.route(q, k, v, do.transpose(2, 3).contiguous().transpose(2, 3)) == "simt"
    # dO that TMA cannot read sends the backward to simt, not the forward
    assert tfa.route(q, k, v) == "wgmma" and tfa.route(q, k, v, wide) == "simt"


def test_tma_strides_read_either_layout_and_take_size_one_dims():
    c = torch.zeros(2, 9, 100, 64, dtype=BF16)  # contiguous (B,H,S,D)
    assert tfa.tma_strides(c) == (9 * 100 * 64, 100 * 64, 64)
    one = torch.zeros(1, 100, 1, 64, dtype=BF16).transpose(1, 2)  # B = H = 1
    assert tfa.tma_strides(one) == (8, 8, 64)
    bcast = torch.zeros(1, 1, 100, 64, dtype=BF16).expand(1, 3, 100, 64)  # a head stride of 0
    assert tfa.tma_strides(bcast) is None


def _tile_pairs(Sq, Sk, causal, rows, cols, by_keys=False, window=0):
    """Brute force: for each query tile of ``rows`` (key tile of ``cols``
    when ``by_keys``), the tiles of the other kind that hold at least one
    (query, key) pair the mask keeps."""
    i = torch.arange(Sq)[:, None]
    j = torch.arange(Sk)[None, :]
    keep = (j <= i + (Sk - Sq)) if causal else torch.ones(Sq, Sk, dtype=torch.bool)
    if window:
        keep = keep & (j > i + (Sk - Sq) - window)
    nq, nk = -(-Sq // rows), -(-Sk // cols)
    pad = torch.zeros(nq * rows, nk * cols, dtype=torch.bool)
    pad[:Sq, :Sk] = keep
    tiles = pad.view(nq, rows, nk, cols).any(3).any(1)  # (nq, nk)
    return tiles.sum(0).tolist() if by_keys else tiles.sum(1).tolist()


@pytest.mark.parametrize("B,H,KV,Sq,Sk,causal", [
    (8, 9, 3, 512, 512, True),      # the training cell
    (4, 9, 3, 512, 512, True),      # a prefill wave
    (1, 6, 2, 100, 132, True),      # ragged, Sq < Sk
    (2, 24, 8, 200, 264, True),     # llama-3.2-3b's heads, ragged
    (3, 3, 1, 130, 130, True),      # one row past a tile
    (1, 4, 2, 96, 160, False),      # not causal
    (1, 2, 1, 1, 700, True),        # a single query row at the end of long keys
    (1, 56, 8, 4096, 4096, True),   # llava-next-34b's training shape, n_rep 7
    (8, 16, 16, 2048, 2048, False),  # seamless's encoder
    (8, 16, 16, 512, 2048, False),  # seamless's cross-attention, Sq = Sk / 4
    (2, 16, 16, 33, 130, False),    # ragged cross-attention
])
def test_plan_grids_match_a_brute_force_count_heavy_blocks_first(B, H, KV, Sq, Sk, causal):
    p = tfa.plan(B, H, KV, Sq, Sk, causal=causal)
    n_rep = H // KV
    per_q = _tile_pairs(Sq, Sk, causal, tfa.BQ, tfa.BKV)
    per_k = _tile_pairs(Sq, Sk, causal, tfa.BQB, tfa.BKV, by_keys=True)
    for kern in ("fwd", "dq"):
        g = p[kern]
        assert g["tile"] == [tfa.BQ, tfa.BKV]
        assert g["blocks"] == len(per_q) * H * B
        assert g["steps"] == [per_q[t] for t in g["order"]]
        assert g["pairs"] == sum(per_q) * H * B
        assert sorted(g["order"]) == list(range(len(per_q)))
    g = p["dkdv"]
    assert g["tile"] == [tfa.BKV, tfa.BQB]
    assert g["blocks"] == len(per_k) * KV * B
    assert g["steps"] == [n_rep * per_k[t] for t in g["order"]]
    assert g["pairs"] == sum(per_k) * n_rep * KV * B
    assert sorted(g["order"]) == list(range(len(per_k)))
    # the heaviest blocks launch first, so none is left running alone at the end
    for kern in ("fwd", "dq", "dkdv"):
        assert p[kern]["steps"] == sorted(p[kern]["steps"], reverse=True)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,causal,window", [
    (1, 16, 1, 4096, 4096, True, 2048),  # recurrentgemma-9b's local attention
    (8, 9, 3, 1024, 1024, True, 256),    # the tensor-core window shape
    (1, 16, 1, 2500, 2500, True, 2048),  # ragged, longer than the window
    (1, 6, 2, 100, 132, True, 50),       # Sq < Sk
    (1, 4, 2, 96, 160, False, 40),       # not causal: a lower bound alone
    (3, 3, 1, 130, 130, True, 1000),     # a window past Sk: the causal plan
    (1, 2, 1, 77, 300, True, 30),        # early keys no query's window reaches
])
def test_plan_under_a_window_walks_only_the_tiles_it_reaches(B, H, KV, Sq, Sk, causal, window):
    """Each block's steps are the brute-force count of the tiles holding a
    kept pair (a tile's first step and its frontier both tight), so the
    work scales with the window, not with Sk."""
    p = tfa.plan(B, H, KV, Sq, Sk, causal=causal, window=window)
    n_rep = H // KV
    per_q = _tile_pairs(Sq, Sk, causal, tfa.BQ, tfa.BKV, window=window)
    per_k = _tile_pairs(Sq, Sk, causal, tfa.BQB, tfa.BKV, by_keys=True, window=window)
    for kern in ("fwd", "dq"):
        assert p[kern]["steps"] == [per_q[t] for t in p[kern]["order"]]
        assert p[kern]["pairs"] == sum(per_q) * H * B
    assert p["dkdv"]["steps"] == [n_rep * per_k[t] for t in p["dkdv"]["order"]]
    glob = tfa.plan(B, H, KV, Sq, Sk, causal=causal)
    if window >= Sq + Sk:
        assert p == glob
    for kern in ("fwd", "dkdv"):
        assert p[kern]["pairs"] <= glob[kern]["pairs"]
        if Sq >= 1024:  # rows span many windows: whole tiles drop out
            assert p[kern]["pairs"] < glob[kern]["pairs"]


def test_window_halves_the_last_query_tiles_at_recurrentgemmas_shape():
    """(1,16,4096,256) over one KV head, causal, window 2048: the last query
    tile walks 34 of the 64 K/V tiles its causal frontier reaches, every
    tile past the first 2048 rows the same 34 (the work is flat there)."""
    p = tfa.plan(1, 16, 1, 4096, 4096, causal=True, window=2048)
    glob = tfa.plan(1, 16, 1, 4096, 4096, causal=True)
    assert glob["fwd"]["steps"][0] == 64 and p["fwd"]["steps"][0] == 34
    assert set(p["fwd"]["steps"][:16]) == {34}
    assert p["fwd"]["steps"] == sorted(p["fwd"]["steps"], reverse=True)


def test_plan_at_the_training_shape_fills_the_card():
    """128-row query blocks give 4 x 9 x 8 = 288 forward / dQ blocks; 64-key
    dK/dV blocks give 8 x 3 x 8 = 192 where 128-key ones would leave 36 of
    132 SMs without one."""
    p = tfa.plan(8, 9, 3, 512, 512, sms=132)
    assert p["fwd"]["blocks"] == 288 and p["dkdv"]["blocks"] == 192
    assert p["dkdv"]["blocks_per_sm"] > 1 > (512 // 128) * 3 * 8 / 132
    # causal: the last query tile walks all 8 key tiles, the first 2
    assert p["fwd"]["order"][0] == 3 and p["fwd"]["steps"] == [8, 6, 4, 2]
    assert p["dkdv"]["steps"][0] == 3 * 8 and p["dkdv"]["steps"][-1] == 3 * 1


def test_launch_counts_report_each_route_and_their_sums(monkeypatch):
    for name, n in (("wgmma_launches", 5), ("simt_launches", 2),
                    ("bwd_wgmma_launches", 3), ("bwd_simt_launches", 1),
                    ("window_launches", 2), ("bwd_window_launches", 1)):
        monkeypatch.setattr(tfa, name, n)
    c = ops.launch_counts()
    assert (c["flash_attention"], c["flash_attention_wgmma"], c["flash_attention_simt"]) == (7, 5, 2)
    assert (c["flash_attention_bwd"], c["flash_attention_bwd_wgmma"],
            c["flash_attention_bwd_simt"]) == (4, 3, 1)
    assert (c["flash_attention_window"], c["flash_attention_bwd_window"]) == (2, 1)
    ops.reset_launch_counts()
    assert tfa.wgmma_launches == tfa.simt_launches == tfa.window_launches == 0
    assert tfa.bwd_wgmma_launches == tfa.bwd_simt_launches == tfa.bwd_window_launches == 0


@pytest.mark.parametrize("model", ["gemma-7b", "nemotron-4-340b"])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_head_dims_192_and_256_take_the_tensor_cores_in_bf16_and_f32_the_cuda_cores(
        model, dtype):
    """gemma-7b (head_dim 256) and nemotron-4-340b (192) at full width:
    the kernels take the head_dim (``_check_cuda``), and the rule sends bf16
    to the tensor cores and f32 to the CUDA cores."""
    cfg = configs.get(model)
    D = cfg.resolved_head_dim
    assert D == {"gemma-7b": 256, "nemotron-4-340b": 192}[model]
    q, k, v, do = _views(cfg, *SHAPES["ragged"], dtype=dtype)
    want = "wgmma" if dtype == BF16 else "simt"
    assert tfa.route(q, k, v) == tfa.route(q, k, v, do) == want
    tfa._check_cuda((q, k, v), D)
    tfa._check_cuda((q, k, v, do), D)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,D,causal,window", [
    (1, 16, 1, 4096, 4096, 256, True, 2048),  # recurrentgemma-9b's local attention
    (1, 16, 16, 512, 512, 256, True, 0),      # gemma-7b's heads
    (1, 96, 8, 256, 256, 192, True, 0),       # nemotron-4-340b's heads
    (1, 12, 2, 100, 132, 192, True, 0),       # ragged, Sq < Sk
    (2, 4, 4, 77, 77, 256, True, 33),         # odd lengths under a window
    (1, 4, 2, 77, 130, 192, False, 50),       # not causal
    (3, 3, 1, 130, 130, 256, True, 1000),     # a window past Sk
])
def test_plan_above_head_dim_128_tiles_dq_by_64_rows_and_splits_dkdv_into_slabs(
        B, H, KV, Sq, Sk, D, causal, window):
    """Above head_dim 128, dQ blocks hold 64 query rows (one consumer
    warpgroup) and each dK/dV block accumulates one slab of head_dim:
    128 columns at 256, 64 at 192, so a key tile has D / slab blocks per KV
    head. Steps held against the brute-force count, per slab."""
    p = tfa.plan(B, H, KV, Sq, Sk, causal=causal, window=window, D=D)
    n_rep, slab = H // KV, {256: 128, 192: 64}[D]
    per_q = _tile_pairs(Sq, Sk, causal, tfa.BQ, tfa.BKV, window=window)
    per_dq = _tile_pairs(Sq, Sk, causal, tfa.BQB, tfa.BKV, window=window)
    per_k = _tile_pairs(Sq, Sk, causal, tfa.BQB, tfa.BKV, by_keys=True, window=window)
    assert p["fwd"]["tile"] == [tfa.BQ, tfa.BKV] and p["fwd"]["blocks"] == len(per_q) * H * B
    assert p["fwd"]["steps"] == [per_q[t] for t in p["fwd"]["order"]]
    g = p["dq"]
    assert g["tile"] == [tfa.BQB, tfa.BKV] and g["blocks"] == len(per_dq) * H * B
    assert g["steps"] == [per_dq[t] for t in g["order"]]
    assert g["pairs"] == sum(per_dq) * H * B
    g = p["dkdv"]
    assert (g["slab"], g["slabs"]) == (slab, D // slab)
    assert g["blocks"] == len(per_k) * (D // slab) * KV * B
    assert g["steps"] == [n_rep * per_k[t] for t in g["order"]]
    assert g["pairs"] == sum(per_k) * n_rep * (D // slab) * KV * B
    # below head_dim 192 the grids are the forward's and one slab of all of D
    narrow = tfa.plan(B, H, KV, Sq, Sk, causal=causal, window=window, D=128)
    assert narrow["dq"]["tile"] == [tfa.BQ, tfa.BKV] and narrow["dkdv"]["slabs"] == 1
    assert narrow["dkdv"]["blocks"] * (D // slab) == g["blocks"]


def test_slabs_double_the_dkdv_grid_at_recurrentgemmas_shape():
    """16 query heads over one KV head, 4096 keys, window 2048: 64 key tiles
    gave 64 dK/dV blocks for 132 SMs; two 128-column slabs give 128, each
    walking 16 heads x 33 query tiles at most."""
    p = tfa.plan(1, 16, 1, 4096, 4096, causal=True, window=2048, D=256)
    assert p["dkdv"]["blocks"] == 128 and p["dkdv"]["slabs"] == 2
    assert max(p["dkdv"]["steps"]) == 16 * 33
    assert p["dq"]["blocks"] == 64 * 16 and p["fwd"]["blocks"] == 32 * 16
    with pytest.raises(ValueError, match="head_dim"):
        tfa.plan(1, 16, 1, 4096, 4096, D=32)


@pytest.mark.parametrize("D", [8, 16, 48, 320])
def test_head_dims_without_a_kernel_are_refused(D):
    """The smoke configs' head_dim 16 and 8 run on the CPU only."""
    q = torch.zeros(1, 2, 16, D, dtype=BF16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa._check_cuda((q, q, q), D)
