"""The quantized matmul's routing rule and launch plan, on the CPU.

``kernels/quantized_matmul.py:route`` sends a product to the tensor-core
(``wgmma``) kernel when x is bf16 that TMA reads K-major and TMA can
describe the int8 q, else to the CUDA-core (``simt``) kernel, in both
orientations (forward, and dX reading q in place as W^T). These tests hold
the rule at the operands the q8 training path hands the kernel at full
smollm-135m width -- captured from a layer's forward and backward on a q8
wire row, as ``core/tiling.py`` passes them -- at column tiles cut by
``tiling._slice``, and at the cases that must stay on ``simt``. The kernels
themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.config import RunConfig, make_offload, make_parallel  # noqa: E402
from repro_torch.core import offload, qformat, tiling, zero  # noqa: E402
from repro_torch.core.partition import QWeight  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantized_matmul as tqm  # noqa: E402

BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def q8_calls():
    """Every quantized call of one smollm-135m layer's forward and backward
    (``layer_vjp``: forward recompute, then the VJP) on a q8 wire row, on
    the CPU: ``(x, q, s, transpose)`` as ``kernels/ops.py`` dispatches them,
    and the wire row's quants."""
    cfg = configs.get("smollm-135m")
    run = RunConfig(model=cfg, parallel=make_parallel("zero3", remat="none"),
                    offload=make_offload(opt_tier="nvme", param_tier="nvme",
                                         grad_tier="nvme", param_quant="q8"))
    eng = zero.ExplicitZero3Engine(run, "cpu")
    g = torch.Generator().manual_seed(0)
    row = (torch.randn(eng.layout.padded, generator=g) * 0.02).to(BF16)
    stager = offload.PinnedStager(offload.PinnedBufferPool(1 << 20), "cpu")
    wire = qformat.wire_row_device(qformat.encode_array(row, "q8"), stager)
    x = torch.randn(2, 64, cfg.d_model, generator=g).to(BF16)
    dy = torch.randn(2, 64, cfg.d_model, generator=g).to(BF16)
    calls = []
    plain = ops._qmatmul

    def record(x, q, s, transpose=False):
        calls.append((x, q, s, transpose))
        return plain(x, q, s, transpose)

    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "_qmatmul", record)
    try:
        eng.make_layer_fns()["layer_vjp"](x, wire, dy)
    finally:
        mp.undo()
    return calls, wire


def test_wire_row_quants_start_on_16_bytes(q8_calls):
    _, (q, s) = q8_calls
    assert q.data_ptr() % 16 == 0 and s.data_ptr() % 16 == 0
    assert q.untyped_storage().data_ptr() == s.untyped_storage().data_ptr()


@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "dX"])
def test_q8_training_calls_take_the_tensor_cores(q8_calls, transpose):
    calls = [c for c in q8_calls[0] if c[3] == transpose]
    assert len(calls) == 3  # w_gate, w_in, w_out: the VJP's forward, or its dX
    shapes = set()
    for x, q, s, _ in calls:
        assert x.dtype == BF16
        assert tqm.route(x, q) == "wgmma", (tuple(x.shape), x.stride(), q.stride())
        shapes.add(tuple(q.shape))
    assert shapes == {(576, 1536), (1536, 576)}


@pytest.mark.parametrize("tiles", [2, 3, 4, 12])
def test_column_tiles_from_slice_take_the_tensor_cores(tiles):
    """``tiling.tiled_matmul``'s axis "n": each tile's q and s are views
    starting a multiple of 32 columns in."""
    q = torch.zeros(576, 1536, dtype=torch.int8)
    s = torch.zeros(576, 48, dtype=torch.float16)
    x = torch.zeros(256, 576, dtype=BF16)
    step = 1536 // tiles
    for i in range(tiles):
        w = tiling._slice(QWeight(q, s, None), slice(None), slice(i * step, (i + 1) * step))
        assert tqm.route(x, w.q) == "wgmma"
        assert tqm.q_tma_ld(w.q) == 1536


def test_row_tiles_run_f32_and_stay_on_the_cuda_cores():
    """Axis "k" hands the kernel f32 slices of x (an f32 accumulation in
    the caller): wgmma's only f32 input is TF32, so they take ``simt``."""
    q = torch.zeros(1536, 576, dtype=torch.int8)
    s = torch.zeros(1536, 18, dtype=torch.float16)
    x = torch.zeros(64, 1536, dtype=BF16)
    seen = []
    plain = ops._qmatmul

    def record(x, q, s, transpose=False):
        seen.append(tqm.route(x, q))
        return plain(x, q, s, transpose)

    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "_qmatmul", record)
    try:
        tiling.tiled_matmul(x, QWeight(q, s, None), tiles=4, axis="k")
    finally:
        mp.undo()
    assert seen == ["simt"] * 4
    assert tqm.route(x[:, :384], q[:384]) == "wgmma"  # the same slices in bf16


def test_what_tma_cannot_take_stays_on_the_cuda_cores():
    q = torch.zeros(576, 1536, dtype=torch.int8)
    x = torch.zeros(256, 576, dtype=BF16)
    assert tqm.route(x, q) == "wgmma"
    assert tqm.route(x.float(), q) == "simt"                    # f32 x
    assert tqm.route(torch.zeros(576, 256, dtype=BF16).T, q) == "simt"  # x M-major
    xb = torch.zeros(256 * 584, dtype=BF16).as_strided((256, 576), (584, 1))
    assert tqm.route(xb, q) == "wgmma"                          # rows 1168 bytes apart
    xo = torch.zeros(256 * 578, dtype=BF16).as_strided((256, 576), (578, 1))
    assert tqm.route(xo, q) == "simt"                           # 1156: not 16-byte rows
    buf = torch.zeros(576 * 1536 + 16, dtype=torch.int8)
    assert tqm.route(x, buf[8:8 + 576 * 1536].view(576, 1536)) == "simt"    # base 8 off
    assert tqm.route(x, buf[16:16 + 576 * 1536].view(576, 1536)) == "wgmma"
    qs = torch.zeros(576 * 1544, dtype=torch.int8).as_strided((576, 1536), (1544, 1))
    assert tqm.route(x, qs) == "simt"                           # rows 1544 bytes apart
    assert tqm.q_tma_ld(torch.zeros(1, 96, dtype=torch.int8)[:, :64]) == 64
    assert tqm.route(torch.zeros(0, 576, dtype=BF16), q) == "simt"


@pytest.mark.parametrize("M,n_out,tile", [
    (4096, 1536, [128, 128]),   # forward x @ W_in|gate, dX of W_out: 3 waves, 6 at 128 x 64
    (4096, 576, [128, 64]),     # forward h @ W_out, dX of W_in|gate: 2 waves, 3 at 128 x 64
    (256, 576, [128, 64]),      # one wave either way
    (100, 64, [128, 64]),       # 1 tile, the ragged test shape
    (512, 1536, [128, 64]),
    (1024, 1536, [128, 128]),   # 1 wave, 2 at 128 x 64
])
def test_plan_picks_the_tile_by_the_stated_rule(M, n_out, tile):
    p = tqm.plan(M, n_out, sms=132)
    assert p["tile"] == tile
    waves = {bn: -(-(-(-M // 128) * -(-n_out // bn)) // 132) for bn in (128, 64)}
    cheaper = waves[64] * tqm.BN64_COST < waves[128]
    assert p["tile"][1] == (64 if cheaper else 128)
    blocks = -(-M // 128) * -(-n_out // p["tile"][1])
    assert p["blocks"] == blocks and p["waves"] == pytest.approx(blocks / 132)


def test_launch_counts_report_each_route_and_their_sums(monkeypatch):
    for name, n in (("wgmma_launches", 5), ("simt_launches", 2),
                    ("dx_wgmma_launches", 7), ("dx_simt_launches", 1)):
        monkeypatch.setattr(tqm, name, n)
    c = ops.launch_counts()
    assert (c["quantized_matmul"], c["quantized_matmul_wgmma"],
            c["quantized_matmul_simt"]) == (7, 5, 2)
    assert (c["quantized_matmul_dx"], c["quantized_matmul_dx_wgmma"],
            c["quantized_matmul_dx_simt"]) == (8, 7, 1)
    ops.reset_launch_counts()
    assert tqm.wgmma_launches == tqm.simt_launches == 0
    assert tqm.dx_wgmma_launches == tqm.dx_simt_launches == 0


def test_tuner_times_shapes_that_take_the_tensor_cores():
    """``launch/tune_tiled.py``'s quantized shapes (the data behind
    ``plan`` and ``BN64_COST``) are ones the rule sends to ``wgmma``."""
    from repro_torch.launch import tune_tiled

    for M, K, N, trans in tune_tiled.QMM_SHAPES:
        x = torch.zeros(M, N if trans else K, dtype=BF16)
        assert tqm.route(x, torch.zeros(K, N, dtype=torch.int8)) == "wgmma"
