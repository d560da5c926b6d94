"""The port's explicit ZeRO-3 engine's monolithic step at one device
against the JAX package's ``InfinityExecutor(engine="zero3")`` on a 1x1
mesh, on the CPU (where the port's kernels run their plain versions), and
the int8 gradient compression against ``repro.optim.compression``.

Each placement runs in both packages for ``STEPS`` steps from the same
state (the reference engine's ``init_state``, in-graph ``master``/``m``/
``v`` and ``g_err`` included, carried over by ``repro_torch.bridge``) and
the same batches (each package's ``SyntheticStream``, bit-identical), as
(param, grad, opt) tiers: all on the device (in-graph fused Adam on the
flat), the params on the host tier, the optimizer on the host tier
in-graph, the optimizer on NVMe off-graph, the gradients drained to NVMe,
and the first placement again with int8 compression, with the broadcast
baseline and with ``remat="full"`` (the others run ``"none"``). On the CPU
the host tier is the device in both packages; the pinned tier itself is
held on the card (``tests/test_torch_cuda.py``). Model: the smoke smollm
cut to 2 layers.

Tolerances, each reasoned from the arithmetic (the GSPMD step's,
``tests/test_torch_gspmd.py``, which states them in full):

* loss and grad norm per step: rtol = atol = 2e-3 (the reference's
  cross-tier tolerance): both packages differentiate with respect to the
  bf16 flat, so the row gradients are bf16 in both, rounded at other
  places in the two frameworks (one bf16 ulp, 2^-8 relative, per element,
  averaged down in a mean loss and a norm over every element). Under int8
  compression the 'other' gradients cross a 127-level quantizer: an
  element the two sides round a bf16 ulp apart may land one level (1/127
  of its block's absmax) apart and the carried residual adds at most half
  a level more, so the grad norm takes rtol 2^-6 (~2/127).
* the flat after the last step: AdamW's normalized update is bounded
  whatever the gradient (``adam.parity_bound``), plus each side's bf16
  rounding of its master (<= 2^-8 of the value); in the bulk mean |diff| <=
  2^-5 * sum(lr). In-graph masters: the drift bound alone. Moments: 2^-5
  in relative norm (eight bf16 ulps; measured ~five).

Measured on the CPU, as fractions of these bounds: loss and grad norm at
most 0.13 (0.16 under int8), the flat 0.28-0.29 (its mean 0.18-0.20).
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import compat  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.config import RunConfig as JRun  # noqa: E402
from repro.config import TrainConfig as JTrain  # noqa: E402
from repro.config import make_offload as jmake_offload  # noqa: E402
from repro.config import make_parallel as jmake_parallel  # noqa: E402
from repro.core import executor as jexec  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.testing import optional_hypothesis  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import RunConfig, ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.config import make_offload, make_parallel  # noqa: E402
from repro_torch.core import executor as texec  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core.zero import ExplicitZero3Engine  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402

given, settings, st, HAVE_HYPOTHESIS = optional_hypothesis()

TIER_TOL = dict(rtol=2e-3, atol=2e-3)
INT8_NORM_TOL = dict(rtol=2**-6, atol=2e-3)
MOMENT_REL = 2**-5
STEPS = 3
B, S = 2, 16

# placement -> (param tier, grad tier, opt tier, remat, grad_compression,
# partition_mode)
PLACEMENTS = {
    "in_graph": ("device", "device", "device", "none", "none", "allgather"),
    "param_host": ("host", "device", "device", "none", "none", "allgather"),
    "opt_host": ("device", "device", "host", "none", "none", "allgather"),
    "opt_nvme": ("device", "device", "nvme", "none", "none", "allgather"),
    "grad_nvme": ("device", "nvme", "nvme", "none", "none", "allgather"),
    "int8": ("device", "device", "device", "none", "int8", "allgather"),
    "broadcast": ("device", "device", "device", "none", "none", "broadcast"),
    "remat_full": ("device", "device", "device", "full", "none", "allgather"),
    "remat_dots": ("device", "device", "device", "dots", "none", "allgather"),
}
OFFGRAPH = ("opt_nvme", "grad_nvme")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _runs(nvme_dir, placement):
    param, grad, opt, remat, compress, mode = PLACEMENTS[placement]
    jcfg = dataclasses.replace(jconfigs.smoke("smollm-135m"), n_layers=2)
    tcfg = dataclasses.replace(tconfigs.smoke("smollm-135m"), n_layers=2)
    off = dict(param_tier=param, grad_tier=grad, opt_tier=opt)
    par = dict(remat=remat, grad_compression=compress, partition_mode=mode)
    jrun = JRun(model=jcfg, parallel=jmake_parallel("zero3", **par),
                offload=jmake_offload(nvme_dir=f"{nvme_dir}/jax", **off),
                train=JTrain(lr=3e-3, warmup_steps=2))
    trun = RunConfig(model=tcfg, parallel=make_parallel("zero3", **par),
                     offload=make_offload(nvme_dir=f"{nvme_dir}/torch", **off),
                     train=TrainConfig(lr=3e-3, warmup_steps=2))
    return jrun, trun


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh(1, 1)


@pytest.fixture(scope="module", params=list(PLACEMENTS))
def placed(request, tmp_path_factory, mesh):
    """Both executors, ``STEPS`` steps of one placement from the same state
    and batches."""
    jrun, trun = _runs(tmp_path_factory.mktemp(request.param), request.param)
    jex = jexec.InfinityExecutor(jrun, mesh)
    jstate = jex.engine.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jstate)
    jstate = jex.reseed(jstate)
    tex = texec.InfinityExecutor(trun, "cpu")
    tstate = tex.reseed(tex.engine.place_state(bridge.zero3_state_from_numpy(init)))
    stream = tpipe.SyntheticStream(tex.input_specs(ShapeConfig("t", S, B, "train")),
                                   trun.model.vocab_size, seed=0)
    jstep, tstep = jex.make_train_step(), tex.make_train_step()
    jm, tm = [], []
    for i in range(STEPS):
        batch = stream.batch_at(i)
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jm.append(m)
        tstate, m = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        tm.append(m)
    yield types.SimpleNamespace(name=request.param, jex=jex, tex=tex, jstate=jstate,
                                tstate=tstate, jm=jm, tm=tm, trun=trun, init=init)
    tex.close()
    jex.close()


@pytest.mark.parametrize("step", range(STEPS))
def test_step_matches_reference_loss_grad_norm_and_lr(placed, step):
    jm, tm = placed.jm[step], placed.tm[step]
    for key in ("loss", "grad_norm", "lr"):
        tol = INT8_NORM_TOL if (placed.name == "int8" and key == "grad_norm") else TIER_TOL
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **tol,
                                   err_msg=f"{placed.name} {key}")


def test_flat_after_last_step_matches_reference(placed):
    lrs = [float(m["lr"]) for m in placed.jm]
    drift = tadam.parity_bound(placed.trun.train, lrs)
    got, want = placed.tstate["flat"], _np(placed.jstate["flat"])
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    diff = np.abs(_np(got) - want)
    assert (diff <= drift + 2**-8 * (np.abs(want) + np.abs(_np(got)))).all(), \
        (placed.name, diff.max())
    assert diff.mean() <= 2**-5 * sum(lrs), (placed.name, diff.mean())


def test_in_graph_optimizer_states_match_reference(placed):
    """Masters to the drift bound, m and v to ``MOMENT_REL`` in norm;
    off-graph placements carry none in the state."""
    keys = ("master", "m", "v")
    if placed.name in OFFGRAPH:
        assert not set(keys) & set(placed.tstate) and not set(keys) & set(placed.jstate)
        return
    drift = tadam.parity_bound(placed.trun.train, [float(m["lr"]) for m in placed.jm])
    diff = np.abs(_np(placed.tstate["master"]) - _np(placed.jstate["master"]))
    assert diff.max() <= drift, (placed.name, diff.max())
    for name in ("m", "v"):
        got, want = _np(placed.tstate[name]), _np(placed.jstate[name])
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= MOMENT_REL, (placed.name, name, rel)


def test_other_states_and_step_match_reference(placed):
    """The embedding and final norm (the fused-Adam path, through the int8
    reduce under compression) and both step counts."""
    js, ts = placed.jstate, placed.tstate
    drift = tadam.parity_bound(placed.trun.train, [float(m["lr"]) for m in placed.jm])
    for path in tpt.tree_paths(ts["other"]):
        want = _np(tpt.tree_get(js["other"], path))
        diff = np.abs(_np(tpt.tree_get(ts["other"], path)) - want)
        assert (diff <= drift + 2**-8 * np.abs(want)).all(), (placed.name, path, diff.max())
    assert int(ts["step"]) == int(js["step"]) == STEPS
    assert int(ts["other_opt"].step) == int(js["other_opt"].step) == STEPS


def test_tier_counters_match_reference(placed):
    """Off-graph steps move the reference's bytes: the flat's f32 master, m
    and v read and written, its f32 gradient drained; in-graph steps
    report no tier counters in either package."""
    L, Pl = 2, placed.tex.engine.layout.padded
    for jm, tm in zip(placed.jm, placed.tm):
        keys = [k for k in jm if k.endswith("_bytes") and "pinned" not in k]
        if placed.name not in OFFGRAPH:
            assert not keys and not [k for k in tm if k.endswith("_bytes")]
            continue
        assert tm["opt_read_bytes"] == tm["opt_write_bytes"] == 12 * L * Pl
        if placed.name == "grad_nvme":
            assert tm["grad_out_bytes"] == 4 * L * Pl
        for k in keys:
            assert int(tm[k]) == int(jm[k]), k
    if placed.name in OFFGRAPH:
        assert sorted(placed.tex.opt_store.keys()) == sorted(placed.jex.opt_store.keys())
        assert [k for k, _, _ in placed.tex.offload.layout] == ["rank0/flat"]


def test_int8_residuals_have_the_reference_layout(placed):
    """``g_err``: one f32 residual per 'other' leaf with a leading dp = 1
    dim, in both packages, of the same size: each element is at most half
    a quant level of its block, and the blocks' absmax agree to a few bf16
    ulps, so the largest residuals agree within 2x. (Element for element
    they decorrelate: a bf16 ulp of a gradient is ~1/4 level at its
    block's absmax. ``psum_compressed`` itself is held bit for bit below.)"""
    if placed.name != "int8":
        assert "g_err" not in placed.tstate and "g_err" not in placed.jstate
        return
    je, te = placed.jstate["g_err"], placed.tstate["g_err"]
    assert tpt.tree_paths(te) == tpt.tree_paths(je) == tpt.tree_paths(placed.tstate["other"])
    for path in tpt.tree_paths(te):
        got, want = tpt.tree_get(te, path), _np(tpt.tree_get(je, path))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert want.shape[0] == 1
        g, w = np.abs(_np(got)).max(), np.abs(want).max()
        assert 0 < g <= 2 * w and w <= 2 * g, (path, g, w)


def test_int8_reduce_passes_each_other_leaf_and_its_residual(monkeypatch):
    """The step hands each 'other' gradient with its rank's residual slice
    to ``psum_compressed``, carries the new residual as ``g_err`` and
    updates 'other' from the reduced gradient (scaled back by dp = 1)."""
    from repro_torch.core import zero as tzero

    eng = _engine(grad_compression="int8")
    state = eng.init_state(torch.Generator().manual_seed(0))
    state["g_err"] = tpt.tree_map(lambda t: torch.full_like(t, 1e-3), state["g_err"])
    seen = []
    real = tcomp.psum_compressed

    def spy(x, error=None, mesh=None):
        out = real(x, error, mesh)
        seen.append((x, error, out))
        return out

    monkeypatch.setattr(tzero.compression, "psum_compressed", spy)
    new_state, _ = eng.make_train_step()(state, _batch(eng.run.model))
    paths = tpt.tree_paths(state["other"])
    assert len(seen) == len(paths)
    for path, (x, err, (red, ne)) in zip(paths, seen):
        assert x.shape == tpt.tree_get(state["other"], path).shape
        assert torch.equal(err, tpt.tree_get(state["g_err"], path)[0])
        assert torch.equal(tpt.tree_get(new_state["g_err"], path), ne.float()[None])
        assert red.dtype == x.dtype


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def _engine(**kw):
    cfg = dataclasses.replace(tconfigs.smoke("smollm-135m"), n_layers=2)
    par = {k: kw.pop(k) for k in ("remat", "grad_compression", "partition_mode") if k in kw}
    return ExplicitZero3Engine(RunConfig(model=cfg, parallel=make_parallel("zero3", **par),
                                         offload=make_offload(**kw)), "cpu")


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32))
    return {"tokens": t, "labels": t}


@pytest.mark.parametrize("opt_tier,keys", [
    ("device", {"flat", "other", "other_opt", "step", "master", "m", "v"}),
    ("nvme", {"flat", "other", "other_opt", "step"})])
def test_init_state_holds_the_flat_optimizer_only_in_graph(opt_tier, keys):
    eng = _engine(opt_tier=opt_tier)
    state = eng.init_state(torch.Generator().manual_seed(0))
    assert set(state) == keys
    if "master" in state:
        assert state["master"].dtype == torch.float32
        assert torch.equal(state["master"], state["flat"].float())
        assert not state["m"].any() and not state["v"].any()


def test_grads_only_step_returns_the_bf16_cotangent_and_keeps_the_flat():
    """Off-graph: ``(new_state, g32, metrics)``; ``g32`` is the bf16 row
    gradient upcast (every element a bf16 value), the flat is the old
    tensor, and only ``step`` and 'other' advance."""
    eng = _engine(opt_tier="nvme")
    state = eng.init_state(torch.Generator().manual_seed(0))
    flat0 = state["flat"].clone()
    new_state, g32, m = eng.make_train_step()(state, _batch(eng.run.model))
    assert g32.dtype == torch.float32 and g32.shape == flat0.shape
    assert torch.equal(g32.to(torch.bfloat16).float(), g32) and g32.abs().sum() > 0
    assert new_state["flat"] is state["flat"] and torch.equal(new_state["flat"], flat0)
    assert int(new_state["step"]) == 1 and int(new_state["other_opt"].step) == 1
    assert set(m) == {"loss", "grad_norm", "lr"}
    # the norm also counts the 'other' gradients
    assert float(m["grad_norm"]) > float(torch.linalg.vector_norm(g32))


def test_in_graph_step_updates_the_flat_through_fused_adam(monkeypatch):
    """The (L, P) flat's update is one fused-Adam call on its f32 master
    (updated in place), whose bf16 copy becomes the new flat; 'other' takes
    one call per leaf."""
    eng = _engine()
    calls = []
    real = ops.fused_adam

    def spy(p32, g32, m, v, scalars):
        calls.append(tuple(p32.shape))
        return real(p32, g32, m, v, scalars)

    monkeypatch.setattr(ops, "fused_adam", spy)
    state = eng.init_state(torch.Generator().manual_seed(0))
    master = state["master"]
    new_state, _ = eng.make_train_step()(state, _batch(eng.run.model))
    flat_shape = (2, eng.layout.padded)
    assert calls.count(flat_shape) == 1 and len(calls) == 1 + 2
    assert new_state["master"] is master
    assert torch.equal(new_state["flat"], master.to(torch.bfloat16))


def test_remat_full_recomputes_each_layer_and_matches_none(monkeypatch):
    """``remat="full"``: the backward runs each layer's forward again (the
    plain matmul's calls count the recompute's three MLP projections per
    layer); the gradients and the loss equal ``"none"``'s."""
    from repro_torch.kernels import ref

    calls = {"n": 0}
    real = ref.matmul_ref

    def counting(x, w):
        calls["n"] += 1
        return real(x, w)

    monkeypatch.setattr(ref, "matmul_ref", counting)
    out = {}
    for remat in ("none", "full"):
        eng = _engine(remat=remat, opt_tier="nvme")
        state = eng.init_state(torch.Generator().manual_seed(0))
        calls["n"] = 0
        _, g32, m = eng.make_train_step()(state, _batch(eng.run.model))
        out[remat] = (g32, float(m["loss"]), calls["n"])
    assert torch.equal(out["full"][0], out["none"][0])
    assert out["full"][1] == out["none"][1]
    assert out["full"][2] == out["none"][2] + 3 * eng.n_layers


def test_remat_dots_saves_the_products_and_matches_none(monkeypatch):
    """``remat="dots"`` on the monolithic step: the MLP products (the plain
    matmul) run as often as under ``"none"`` (saved, not recomputed),
    attention's plain forward as often as under ``"full"``, and the
    gradients and the loss equal ``"none"``'s."""
    from repro_torch.kernels import ref

    calls = {"mm": 0, "att": 0}
    real_mm, real_att = ref.matmul_ref, ref.attention_fwd_ref

    def mm(x, w):
        calls["mm"] += 1
        return real_mm(x, w)

    def att(*a, **k):
        calls["att"] += 1
        return real_att(*a, **k)

    monkeypatch.setattr(ref, "matmul_ref", mm)
    monkeypatch.setattr(ref, "attention_fwd_ref", att)
    out = {}
    for remat in ("none", "full", "dots"):
        eng = _engine(remat=remat, opt_tier="nvme")
        state = eng.init_state(torch.Generator().manual_seed(0))
        calls.update(mm=0, att=0)
        _, g32, m = eng.make_train_step()(state, _batch(eng.run.model))
        out[remat] = (g32, float(m["loss"]), dict(calls))
    assert torch.equal(out["dots"][0], out["none"][0])
    assert out["dots"][1] == out["none"][1]
    assert out["dots"][2]["mm"] == out["none"][2]["mm"]
    assert out["dots"][2]["att"] == out["full"][2]["att"] == 2 * eng.n_layers


@pytest.mark.parametrize("par,match", [
    ({"partition_mode": "broadcast"}, "partition_mode='allgather'"),
    ({"grad_compression": "int8"}, "grad_compression='int8'")])
def test_layered_epoch_refuses_what_the_reference_refuses(tmp_path, par, match):
    cfg = dataclasses.replace(tconfigs.smoke("smollm-135m"), n_layers=2)
    run = RunConfig(model=cfg, parallel=make_parallel("zero3", **par),
                    offload=make_offload(param_tier="nvme", opt_tier="nvme",
                                         nvme_dir=str(tmp_path)))
    with pytest.raises(ValueError, match=match):
        texec.InfinityExecutor(run, "cpu")


@pytest.mark.parametrize("param", ["device", "host"])
def test_check_ported_accepts_the_monolithic_step(param):
    run = RunConfig(model=tconfigs.smoke("smollm-135m"), parallel=make_parallel("zero3"),
                    offload=make_offload(param_tier=param))
    texec.check_ported(run)
    assert not texec.InfinityExecutor(run, "cpu").layered


# ---------------------------------------------------------------------------
# int8 compression against repro.optim.compression
# ---------------------------------------------------------------------------


def _ref_psum(x, err, mesh):
    """The reference's ``psum_compressed`` at one rank, inside shard_map."""
    def f(x, e):
        return jcomp.psum_compressed(x, "data", e)

    fn = compat.shard_map(f, mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
                          check_vma=False)
    return jax.jit(fn)(x, err)


_ref_quantize = jax.jit(lambda x: jcomp.quantize_int8(x)[:2])


def _pair(shape, seed, dtype=np.float32, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    if dtype == "bfloat16":
        j = jnp.asarray(a).astype(jnp.bfloat16)
        return j, bridge.tensor_from_numpy(np.asarray(j))
    return jnp.asarray(a), torch.from_numpy(a)


@settings(max_examples=15, deadline=None)
@given(shape=st.lists(st.integers(1, 40), min_size=1, max_size=3),
       seed=st.integers(0, 2**16), scale=st.sampled_from([1e-6, 1.0, 300.0]))
def test_quantize_int8_is_bit_exact_against_reference(shape, seed, scale):
    """Quants and scales bit for bit against the reference compiled as its
    step runs it (jitted: XLA divides by 127 as a multiply by the
    reciprocal), at shapes that are mostly not a multiple of 256 (the
    padded tail), and the dequantized round trip."""
    jx, tx = _pair(tuple(shape), seed, scale=scale)
    jq, js = _ref_quantize(jx)
    jst = jax.ShapeDtypeStruct(jx.shape, jx.dtype)
    tq, ts, tst = tcomp.quantize_int8(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tst == (tuple(jst.shape), torch.float32)
    np.testing.assert_array_equal(tcomp.dequantize_int8(tq, ts, tst).numpy(),
                                  np.asarray(jcomp.dequantize_int8(jq, js, jst)))


def test_dequantize_int8_restores_the_recorded_dtype():
    jx, tx = _pair((3, 100), 1, dtype="bfloat16")
    tq, ts, tst = tcomp.quantize_int8(tx)
    out = tcomp.dequantize_int8(tq, ts, tst)
    want = jcomp.dequantize_int8(*_ref_quantize(jx), jax.ShapeDtypeStruct(jx.shape, jx.dtype))
    assert out.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("shape,dtype", [((49, 7), np.float32), ((300,), "bfloat16"),
                                         ((2, 256), np.float32)])
def test_psum_compressed_at_one_rank_is_bit_exact_against_reference(mesh, shape, dtype):
    """Reduced value and new residual bit for bit, over three steps of
    error feedback (bf16 + f32 residual promotes to f32 in both)."""
    jerr = terr = None
    for i in range(3):
        jx, tx = _pair(shape, 10 + i, dtype=dtype)
        if jerr is None:
            jerr, terr = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
        jr, jerr = _ref_psum(jx, jerr, mesh)
        tr, terr = tcomp.psum_compressed(tx, terr)
        assert tr.dtype == tx.dtype and terr.dtype == torch.float32
        np.testing.assert_array_equal(_np(tr), np.asarray(jr, np.float32))
        np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))


def test_psum_compressed_raises_across_ranks(monkeypatch):
    """Across ranks the reduce needs the run's mesh: called without one in
    a process group of two ranks it refuses rather than reduce this rank's
    payload alone (the cross-rank reduce is held in tests/test_torch_dp.py)."""
    monkeypatch.setattr(tcomp, "_world_size", lambda: 2)
    with pytest.raises(ValueError, match="LocalMesh"):
        tcomp.psum_compressed(torch.ones(3))
