"""The tiled matmul's routing rule and launch plan, on the CPU.

``kernels/tiled_matmul.py:route`` sends a product to the tensor-core
(``wgmma``) kernel when both operands are bf16 and TMA can describe each,
else to the CUDA-core (``simt``) kernel. These tests hold the rule at the
operands the main paths hand the kernel at full smollm-135m width -- the
MLP weights as views into a bf16 layer row laid out by ``core/partition``,
the activations and gradients as the model makes them -- and at the cases
that must stay on ``simt``. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core import partition as pt  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import tiled_matmul as tmm  # noqa: E402
from repro_torch.models import registry  # noqa: E402

BF16 = torch.bfloat16
TOKENS = 8 * 512  # the training cell's batch x seq


@pytest.fixture(scope="module")
def mlp():
    """w_in, w_gate, w_out as the layered step sees them: views into one
    full-width bf16 layer row."""
    cfg = configs.get("smollm-135m")
    layout = pt.build_layout(registry.build(cfg).defs["blocks"])
    row = torch.zeros(layout.padded, dtype=BF16)
    return cfg, pt.unflatten_row(row, layout, BF16)["mlp"]


def _operands(cfg, w, product, M):
    """The (x, w) pair of one product of the projection ``w`` (K, N) at M
    tokens: forward x @ W, dX = dY @ W^T, dW = X^T @ dY."""
    K, N = w.shape
    x = torch.zeros(M, K, dtype=BF16)
    dy = torch.zeros(M, N, dtype=BF16)
    return {"forward": (x, w), "dX": (dy, w.T), "dW": (x.T, dy)}[product]


@pytest.mark.parametrize("leaf", ["w_in", "w_gate", "w_out"])
@pytest.mark.parametrize("product", ["forward", "dX", "dW"])
def test_training_products_take_the_tensor_cores(mlp, leaf, product):
    cfg, p = mlp
    x, w = _operands(cfg, p[leaf], product, TOKENS)
    assert tmm.route(x, w) == "wgmma"


@pytest.mark.parametrize("leaf", ["w_in", "w_gate", "w_out"])
def test_q8_runs_weight_gradient_takes_the_tensor_cores(mlp, leaf):
    """Under --param-quant q8 the projections run the quantized kernel, and
    dW = X^T @ dY (``kernels/ops.py``, the anchor's gradient) the tiled
    matmul: X the projection's bf16 input, dY its output's gradient."""
    cfg, p = mlp
    K, N = p[leaf].shape
    x, dy = torch.zeros(TOKENS, K, dtype=BF16), torch.zeros(TOKENS, N, dtype=BF16)
    assert tmm.route(x.T, dy) == "wgmma"


@pytest.mark.parametrize("M", [4 * 512, 4, 1])  # a prefill wave, decode at 4 slots and 1
@pytest.mark.parametrize("leaf", ["w_in", "w_gate", "w_out"])
def test_serving_products_take_the_tensor_cores(mlp, M, leaf):
    cfg, p = mlp
    x, w = _operands(cfg, p[leaf], "forward", M)
    assert tmm.route(x, w) == "wgmma"


def test_what_tma_cannot_take_stays_on_the_cuda_cores():
    # f32: wgmma's only f32 input is TF32
    assert tmm.route(torch.zeros(64, 64), torch.zeros(64, 64)) == "simt"
    # the ragged case: w's 100-element rows are 200 bytes apart
    x, w = torch.zeros(300, 200, dtype=BF16), torch.zeros(200, 100, dtype=BF16)
    assert tmm.route(x, w) == "simt"
    assert tmm.route(x, w.T.contiguous().T) == "wgmma"  # column-major: k rows 400 bytes apart
    assert tmm.route(x, torch.zeros(200, 200, dtype=BF16)[:, ::2]) == "simt"  # no unit stride
    # a view offset by one element: base 2 bytes off a 16-byte boundary
    buf = torch.zeros(4096 * 576 + 8, dtype=BF16)
    assert tmm.route(buf[1:-7].view(4096, 576), torch.zeros(576, 1536, dtype=BF16)) == "simt"
    assert tmm.route(buf[8:].view(4096, 576), torch.zeros(576, 1536, dtype=BF16)) == "wgmma"
    # mixed dtypes never take the tensor cores
    assert tmm.route(torch.zeros(64, 64, dtype=BF16), torch.zeros(64, 64)) == "simt"


def test_tma_layout_reads_either_major_ness_and_packs_size_one_dims():
    a = torch.zeros(296, 200, dtype=BF16)
    assert tmm.tma_layout(a) == ("row", 200)
    assert tmm.tma_layout(a.T) == ("col", 200)
    assert tmm.tma_layout(a[:, 64:168]) == ("row", 200)  # 128-byte offset
    assert tmm.tma_layout(a[:, 3:100]) is None           # 6 bytes off
    assert tmm.tma_layout(torch.zeros(1, 576, dtype=BF16)) == ("row", 576)
    assert tmm.tma_layout(torch.zeros(1, 100, dtype=BF16)[:, :99]) == ("row", 104)
    # a stride of 0 (a broadcast row) or one shorter than the row is refused
    assert tmm.tma_layout(torch.zeros(1, 64, dtype=BF16).expand(8, 64)) is None
    assert tmm.tma_layout(torch.zeros(100, dtype=BF16).as_strided((4, 64), (8, 1))) is None


@pytest.mark.parametrize("shape,tile,split", [
    ((4096, 1536, 576), [128, 128], 1),   # forward x @ W_in|gate, dX of W_out
    ((4096, 576, 1536), [128, 128], 1),   # forward h @ W_out, dX of W_in|gate
    ((576, 1536, 4096), [128, 128], 2),   # dW of W_in|gate: 60 tiles, K split
    ((1536, 576, 4096), [128, 128], 2),   # dW of W_out
    ((2048, 1536, 576), [128, 128], 1),   # prefill
    ((2048, 576, 1536), [128, 128], 1),
    ((4, 1536, 576), [128, 64], 1),       # decode: 12 tiles, K too short to split
    ((296, 104, 200), [128, 64], 1),
])
def test_plan_picks_tile_and_split_by_the_stated_rule(shape, tile, split):
    M, N, K = shape
    p = tmm.plan(M, N, K, sms=132)
    assert p["tile"] == tile and p["split"] == split
    per_sm = 2 if tile[1] == 64 else 1
    tiles = -(-M // 128) * -(-N // tile[1])
    assert p["blocks"] == tiles * split
    assert p["waves"] == pytest.approx(tiles * split / (132 * per_sm))
    if split > 1:  # every part resident at once, each long enough to pay for its sums
        assert p["blocks"] <= 132 and -(-K // 64) // split >= tmm.SPLIT_SLICES


def test_launch_counts_report_each_route_and_their_sum(monkeypatch):
    monkeypatch.setattr(tmm, "wgmma_launches", 5)
    monkeypatch.setattr(tmm, "simt_launches", 2)
    c = ops.launch_counts()
    assert (c["tiled_matmul"], c["tiled_matmul_wgmma"], c["tiled_matmul_simt"]) == (7, 5, 2)
    ops.reset_launch_counts()
    assert tmm.wgmma_launches == tmm.simt_launches == 0


def test_tuner_times_tensor_core_shapes_and_needs_the_card(monkeypatch):
    """``launch/tune_tiled.py`` (the data behind ``plan``) times products
    that take the tensor cores, and refuses to run without the card."""
    from repro_torch.launch import tune_tiled

    for M, K, N, trans in tune_tiled.SHAPES:
        x = torch.zeros((K, M) if "x" in trans else (M, K), dtype=BF16)
        w = torch.zeros((N, K) if "w" in trans else (K, N), dtype=BF16)
        assert tmm.route(x.T if "x" in trans else x, w.T if "w" in trans else w) == "wgmma"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tune_tiled.main([]) == 1
