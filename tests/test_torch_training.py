"""The port's training slice against the JAX package, on the CPU (where the
port's kernels run their plain versions).

The slice is ``launch/train.py --engine zero3 --offload-param nvme
--offload-grad nvme --offload-opt nvme``: the explicit engine's layered
epoch with every state class on the NVMe tier. Weights come from the
reference engine's ``init_state`` through ``repro_torch.bridge``; batches
from each package's ``SyntheticStream`` (bit-identical). Model: the smoke
smollm cut to 2 layers, ``remat="none"``.

Tolerances. Per-step loss and grad_norm use the reference's own
cross-tier tolerance (``tests/test_executor.py`` TIER_TOL, rtol = atol =
2e-3): the two frameworks round bf16 activations at different places,
one bf16 ulp (2^-8 relative) per element, which averages down in a mean
loss and a norm. Rows and device-resident states after the last step:
AdamW's normalized update is bounded whatever the gradient, so two runs
differ by at most ``adam.parity_bound`` (~2 * sum(lr): a tiny gradient may
flip sign between the packages) plus the bf16 rounding of the stored row;
in the bulk, bf16 rounding of the gradients (2^-8 relative) moves Adam's
ratio by a few 2^-8 of lr per step, held as mean |diff| <= 2^-5 * sum(lr).
"""
import contextlib
import dataclasses
import math
import types
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.config import RunConfig as JRun  # noqa: E402
from repro.config import TrainConfig as JTrain  # noqa: E402
from repro.config import make_offload as jmake_offload  # noqa: E402
from repro.config import make_parallel as jmake_parallel  # noqa: E402
from repro.core import executor as jexec  # noqa: E402
from repro.core import offload as joff  # noqa: E402
from repro.core import qformat as jqformat  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import RunConfig, ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.config import make_offload, make_parallel  # noqa: E402
from repro_torch.core import executor as texec  # noqa: E402
from repro_torch.core import offload as toff  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core import qformat as tqformat  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core import zero as tzero  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402

TIER_TOL = dict(rtol=2e-3, atol=2e-3)
NVME = dict(opt_tier="nvme", param_tier="nvme", grad_tier="nvme")
STEPS = 3
B, S = 2, 16


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _runs(nvme_dir, d_model=None, **offload):
    wide = {} if d_model is None else {"d_model": d_model}
    jcfg = dataclasses.replace(jconfigs.smoke("smollm-135m"), n_layers=2, **wide)
    tcfg = dataclasses.replace(tconfigs.smoke("smollm-135m"), n_layers=2, **wide)
    off = {**NVME, **offload}
    jrun = JRun(model=jcfg, parallel=jmake_parallel("zero3", remat="none"),
                offload=jmake_offload(nvme_dir=f"{nvme_dir}/jax", **off),
                train=JTrain(lr=3e-3, warmup_steps=2))
    trun = RunConfig(model=tcfg, parallel=make_parallel("zero3", remat="none"),
                     offload=make_offload(nvme_dir=f"{nvme_dir}/torch", **off),
                     train=TrainConfig(lr=3e-3, warmup_steps=2))
    return jrun, trun


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh(1, 1)


def _port_steps(trun, init):
    """The port's executor, 3 layered steps from the reference's initial
    state ``init`` (numpy) on the port's stream, which is bit-identical to
    the reference's (test_synthetic_stream_bit_identical_to_reference)."""
    tex = texec.InfinityExecutor(trun, "cpu")
    tstate = tex.reseed(bridge.zero3_state_from_numpy(init))
    tstream = tpipe.SyntheticStream(tex.input_specs(ShapeConfig("t", S, B, "train")),
                                    trun.model.vocab_size, seed=0)
    tstep = tex.make_train_step()
    tm = []
    for i in range(STEPS):
        tstate, m = tstep(tstate, {k: torch.from_numpy(v)
                                   for k, v in tstream.batch_at(i).items()})
        tm.append(m)
    return tex, tstate, tm, tstream


def _both_executors(nvme_dir, mesh, **kw):
    """Both executors, 3 layered steps from the same weights and batches."""
    jrun, trun = _runs(nvme_dir, **kw)
    jex = jexec.InfinityExecutor(jrun, mesh)
    jstate = jex.engine.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jstate)
    jstate = jex.reseed(jstate)
    tex, tstate, tm, tstream = _port_steps(trun, init)
    jstep = jex.make_train_step()
    jm = []
    for i in range(STEPS):
        batch = tstream.batch_at(i)
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jm.append(m)
    return types.SimpleNamespace(jex=jex, tex=tex, jstate=jstate, tstate=tstate,
                                 jm=jm, tm=tm, trun=trun, init=init)


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory, mesh):
    out = _both_executors(tmp_path_factory.mktemp("nvme"), mesh)
    yield out
    out.tex.close()
    out.jex.close()


# ---------------------------------------------------------------------------
# the slice whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", range(STEPS))
def test_layered_step_matches_reference_loss_and_grad_norm(slice_run, step):
    jm, tm = slice_run.jm[step], slice_run.tm[step]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **TIER_TOL,
                                   err_msg=key)


def test_rows_after_last_step_match_reference(slice_run):
    want = np.asarray(slice_run.jex._materialize_flat()).astype(np.float32)
    got = _np(slice_run.tex.materialize_flat())
    assert got.shape == want.shape
    lrs = [float(m["lr"]) for m in slice_run.jm]
    diff = np.abs(got - want)
    drift = tadam.parity_bound(slice_run.trun.train, lrs)
    assert (diff <= drift + 2**-8 * np.abs(want)).all(), diff.max()
    assert diff.mean() <= 2**-5 * sum(lrs), diff.mean()


def test_device_resident_states_match_reference(slice_run):
    """The embedding and final norm (updated by ``finish`` through the
    fused-Adam path) and the carried step."""
    js, ts = slice_run.jstate, slice_run.tstate
    drift = tadam.parity_bound(slice_run.trun.train, [float(m["lr"]) for m in slice_run.jm])
    for path in tpt.tree_paths(ts["other"]):
        want = _np(tpt.tree_get(js["other"], path))
        diff = np.abs(_np(tpt.tree_get(ts["other"], path)) - want)
        assert (diff <= drift + 2**-8 * np.abs(want)).all(), (path, diff.max())
    assert int(ts["step"]) == int(js["step"]) == STEPS
    assert int(ts["other_opt"].step) == STEPS


def test_every_tier_moves_bytes_every_step_and_rows_never_all_resident(slice_run):
    L, P = 2, slice_run.tex.engine.layout.padded
    for m in slice_run.tm:
        assert m["param_in_bytes"] == 2 * L * P * 2  # each row read twice (fwd, bwd)
        assert m["param_out_bytes"] == L * P * 2
        assert m["grad_out_bytes"] == L * P * 4
        assert m["opt_read_bytes"] == m["opt_write_bytes"] == 3 * L * P * 4
        assert m["evictions"] == 2 * L
        assert 0 < m["peak_resident_param_bytes"] < m["param_total_bytes"]
        assert m["nvme_bytes_read"] == (m["param_in_bytes"] + m["opt_read_bytes"]
                                        + m["grad_out_bytes"])


def test_state_drops_rows_to_a_placeholder(slice_run):
    flat = slice_run.tstate["flat"]
    assert not isinstance(flat, torch.Tensor)
    assert tuple(flat.shape) == (2, slice_run.tex.engine.layout.padded)


# ---------------------------------------------------------------------------
# engine pieces, each against the reference's at the same row and inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pieces(mesh, tmp_path_factory):
    jrun, trun = _runs(tmp_path_factory.mktemp("pieces"))
    jeng = jexec.make_engine(jrun, mesh)
    jstate = jeng.init_state(jax.random.PRNGKey(3))
    np_state = jax.tree.map(np.asarray, jstate)
    teng = tzero.ExplicitZero3Engine(trun, "cpu")
    rng = np.random.default_rng(0)
    d = jrun.model.d_model
    x = (rng.standard_normal((B, S, d)) * 0.5).astype(np.float32)
    dy = (rng.standard_normal((B, S, d)) * 0.1).astype(np.float32)
    tokens = rng.integers(0, jrun.model.vocab_size, (B, S)).astype(np.int32)
    return types.SimpleNamespace(
        jfns=jeng.make_layer_fns(), tfns=teng.make_layer_fns(), jeng=jeng,
        teng=teng, jstate=jstate, tstate=bridge.zero3_state_from_numpy(np_state),
        row=np_state["flat"][1], x=x, dy=dy, tokens=tokens, trun=trun)


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, err


def test_bundle_loss_and_its_gradient_match_reference():
    """The dense bundle's training loss, differentiated through the
    kernels' autograd Functions, against ``jax.value_and_grad`` of the
    reference's loss on bridged weights (remat none): loss by TIER_TOL,
    each leaf's gradient to 3e-2 of its largest element (bf16 activations
    rounded at other places through two layers)."""
    jcfg = dataclasses.replace(jconfigs.smoke("smollm-135m"), n_layers=2)
    tcfg = dataclasses.replace(tconfigs.smoke("smollm-135m"), n_layers=2)
    jb = jreg.build(jcfg)
    jparams = jb.init(jax.random.PRNGKey(1))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jl, jg = jax.value_and_grad(jb.loss)(jparams, {"tokens": jnp.asarray(toks),
                                                   "labels": jnp.asarray(toks)})
    leaves = tpt.tree_map(lambda t: t.requires_grad_(), tparams)
    tl = treg.build(tcfg).loss(leaves, {"tokens": torch.from_numpy(toks),
                                        "labels": torch.from_numpy(toks)})
    paths = tpt.tree_paths(leaves)
    tg = torch.autograd.grad(tl, [tpt.tree_get(leaves, p) for p in paths])
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TIER_TOL)
    for path, g in zip(paths, tg):
        _close(g, tpt.tree_get(jg, path), 3e-2)


def test_row_layout_is_byte_identical_to_reference(pieces):
    """flatten order (sorted keys), sizes and padding as ``_build_layout`` /
    ``_flatten_blocks``; unflatten inverts it."""
    jl, tl = pieces.jeng.layout, pieces.teng.layout
    assert tl.padded == jl.padded and tl.sizes == jl.sizes
    assert [tuple(s) for s in jl.shapes] == tl.shapes
    row = bridge.tensor_from_numpy(pieces.row)
    jtree = pieces.jeng._unflatten_layer(jnp.asarray(pieces.row))
    ttree = tpt.unflatten_row(row, tl)
    for path in tpt.tree_paths(ttree):
        np.testing.assert_array_equal(_np(tpt.tree_get(ttree, path)),
                                      _np(tpt.tree_get(jtree, path)))
    flat = tpt.flatten_blocks(pt_stack(ttree), tl, torch.bfloat16)
    np.testing.assert_array_equal(_np(flat[0]), _np(pieces.row))


def pt_stack(tree):
    return tpt.tree_map(lambda t: t[None], tree)


def test_embed_fwd_and_layer_fwd_match_reference(pieces):
    jx, tx = _bf16(pieces.x)
    row_j, row_t = jnp.asarray(pieces.row), bridge.tensor_from_numpy(pieces.row)
    _close(pieces.tfns["layer_fwd"](tx, row_t), pieces.jfns["layer_fwd"](jx, row_j), 2e-2)
    tok = pieces.tokens
    _close(pieces.tfns["embed_fwd"](pieces.tstate["other"], torch.from_numpy(tok)),
           pieces.jfns["embed_fwd"](pieces.jstate["other"], jnp.asarray(tok)), 0.0)


def test_layer_vjp_matches_reference_and_returns_an_f32_row_gradient(pieces):
    """The row gradient is the bf16 row's cotangent carried in f32
    (``repro/core/zero.py:656``): f32, and every value a bf16 value."""
    jx, tx = _bf16(pieces.x)
    jdy, tdy = _bf16(pieces.dy)
    row_j, row_t = jnp.asarray(pieces.row), bridge.tensor_from_numpy(pieces.row)
    jdx, jg = pieces.jfns["layer_vjp"](jx, row_j, jdy)
    tdx, tg = pieces.tfns["layer_vjp"](tx, row_t, tdy)
    assert tg.dtype == torch.float32 and tdx.dtype == torch.bfloat16
    assert torch.equal(tg, tg.to(torch.bfloat16).float())
    _close(tdx, jdx, 2e-2)
    _close(tg, jg, 2e-2)
    # every leaf of the row gets a gradient; the padding none
    lay = pieces.teng.layout
    off = 0
    for size in lay.sizes:
        assert tg[off:off + size].abs().sum() > 0
        off += size
    assert tg[off:].abs().sum() == 0


def test_head_and_embed_vjp_match_reference(pieces):
    jx, tx = _bf16(pieces.x)
    labels = pieces.tokens
    jl, jdx, jg = pieces.jfns["head"](jx, pieces.jstate["other"], jnp.asarray(labels))
    tl, tdx, tg = pieces.tfns["head"](tx, pieces.tstate["other"], torch.from_numpy(labels))
    np.testing.assert_allclose(float(tl), float(jl), **TIER_TOL)
    _close(tdx, jdx, 2e-2)
    for path in tpt.tree_paths(tg):
        _close(tpt.tree_get(tg, path), tpt.tree_get(jg, path), 2e-2)
    jdy, tdy = _bf16(pieces.dy)
    jge = pieces.jfns["embed_vjp"](pieces.jstate["other"], jnp.asarray(labels), jdy)
    tge = pieces.tfns["embed_vjp"](pieces.tstate["other"], torch.from_numpy(labels), tdy)
    for path in tpt.tree_paths(tge):
        _close(tpt.tree_get(tge, path), tpt.tree_get(jge, path), 2e-2)


def test_head_scales_the_loss_by_one_over_dp(pieces):
    """``head`` divides by dp before the cross-rank sum
    (``repro/core/zero.py:662``): at dp = 2 the local loss and its gradient
    halve (the sum over ranks, absent at dp = 1, restores them)."""
    _, tx = _bf16(pieces.x)
    labels = torch.from_numpy(pieces.tokens)
    eng = tzero.ExplicitZero3Engine(pieces.trun, "cpu")
    l1, dx1, _ = eng.make_layer_fns()["head"](tx, pieces.tstate["other"], labels)
    eng.dp = 2
    l2, dx2, _ = eng.make_layer_fns()["head"](tx, pieces.tstate["other"], labels)
    assert float(l2) == pytest.approx(float(l1) / 2, rel=1e-6)
    np.testing.assert_allclose(_np(dx2), _np(dx1) / 2, rtol=2**-7, atol=1e-8)


def test_accum_sumsq_and_finish_match_reference(pieces):
    rng = np.random.default_rng(5)
    jother, tother = pieces.jstate["other"], pieces.tstate["other"]
    g_np = {p: (rng.standard_normal(_np(tpt.tree_get(tother, p)).shape) * 0.01)
            .astype(np.float32) for p in tpt.tree_paths(tother)}
    jg, tg = {}, {}
    for p, a in g_np.items():
        dt = tpt.tree_get(tother, p).dtype
        tpt.tree_set(tg, p, torch.from_numpy(a).to(dt))
        tpt.tree_set(jg, p, jnp.asarray(a).astype(jnp.bfloat16 if dt == torch.bfloat16
                                                   else jnp.float32))
    row = (rng.standard_normal(pieces.row.shape) * 0.01).astype(np.float32)
    js = pieces.jfns["accum_sumsq"](jnp.zeros((), jnp.float32), jnp.asarray(row))
    ts = pieces.tfns["accum_sumsq"](torch.zeros(()), torch.from_numpy(row))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)
    zeros_j = jax.tree.map(jnp.zeros_like, jg)
    zeros_t = tpt.tree_map(torch.zeros_like, tg)
    jo, jopt, jstep, jfm = pieces.jfns["finish"](jother, pieces.jstate["other_opt"],
                                                 pieces.jstate["step"], jg, zeros_j, js)
    opt = pieces.tstate["other_opt"]
    topt = tadam.AdamState(opt.step.clone(), *(tpt.tree_map(torch.clone, t)
                                               for t in opt[1:]))
    to, topt, tstep, tfm = pieces.tfns["finish"](tother, topt, pieces.tstate["step"],
                                                 tg, zeros_t, ts)
    assert int(tstep) == int(jstep) == 1
    np.testing.assert_allclose(float(tfm["grad_norm"]), float(jfm["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(tfm["lr"]), float(jfm["lr"]), rtol=1e-7)
    for p in tpt.tree_paths(to):
        np.testing.assert_allclose(_np(tpt.tree_get(topt.master, p)),
                                   _np(tpt.tree_get(jopt.master, p)), rtol=1e-6, atol=1e-7)
        assert tpt.tree_get(to, p).dtype == tpt.tree_get(tother, p).dtype


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_parity_bound_is_tight_for_a_sign_flip():
    """Two runs whose gradients have opposite signs every step drift apart
    by the bound's leading term (no decay: wd = 0), and no further."""
    tc = TrainConfig(weight_decay=0.0)
    lrs = [1e-3, 2e-3, 3e-3]
    p = [torch.zeros(1), torch.zeros(1)]
    st = [tadam.init_state({"w": t}) for t in p]
    for i, lr in enumerate(lrs):
        tci = TrainConfig(lr=lr, warmup_steps=1, weight_decay=0.0)
        for r, sign in ((0, 1.0), (1, -1.0)):
            _, st[r] = tadam.apply_updates({"w": torch.full((1,), sign * 1e-3)}, st[r], tci)
    drift = float((st[0].master["w"] - st[1].master["w"]).abs())
    assert drift <= tadam.parity_bound(tc, lrs) * (1 + 1e-6)
    assert drift >= 0.99 * 2 * sum(lrs)


@pytest.mark.parametrize("use_fused", [False, True])
def test_apply_updates_matches_reference_across_warmup(use_fused):
    """Three steps with warmup_steps = 2 (lr ramps, then holds); the port's
    one path (``ops.fused_adam``, plain on the CPU) against the reference's
    jnp update and its Pallas kernel in interpret mode. f32 states agree to
    f32 rounding (the bias corrections' pow may differ by an ulp); bf16
    params to one bf16 ulp."""
    rng = np.random.default_rng(7)
    shapes = {"embed": {"tok": ((40, 24), "bfloat16")},
              "ln_f": {"scale": ((24,), "float32")}}
    tc_j, tc_t = JTrain(lr=1e-2, warmup_steps=2), TrainConfig(lr=1e-2, warmup_steps=2)
    params_np = {k: {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
                     for n, (s, _) in v.items()} for k, v in shapes.items()}
    jparams = {k: {n: jnp.asarray(params_np[k][n]).astype(dt)
                   for n, (_, dt) in v.items()} for k, v in shapes.items()}
    tparams = {k: {n: torch.from_numpy(params_np[k][n]).to(getattr(torch, dt))
                   for n, (_, dt) in v.items()} for k, v in shapes.items()}
    jst, tst = jadam.init_state(jparams), tadam.init_state(tparams)
    for _ in range(3):
        g = {k: {n: (rng.standard_normal(s) * 0.05).astype(np.float32)
                 for n, (s, _) in v.items()} for k, v in shapes.items()}
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), g)
        tg = tpt.tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), g)
        jparams, jst = jadam.apply_updates(jg, jst, tc_j, params_prev=jparams,
                                           use_fused=use_fused)
        tparams, tst = tadam.apply_updates(tg, tst, tc_t, params_prev=tparams)
        assert int(tst.step) == int(jst.step)
        for p in tpt.tree_paths(tparams):
            for jt, tt in ((jst.master, tst.master), (jst.m, tst.m), (jst.v, tst.v)):
                np.testing.assert_allclose(_np(tpt.tree_get(tt, p)),
                                           _np(tpt.tree_get(jt, p)), rtol=1e-5, atol=1e-8)
            got, want = _np(tpt.tree_get(tparams, p)), _np(tpt.tree_get(jparams, p))
            assert str(tpt.tree_get(tparams, p).dtype) == f"torch.{shapes[p[0]][p[1]][1]}"
            assert (np.abs(got - want) <= 2**-7 * np.abs(want) + 1e-12).all()
    np.testing.assert_allclose(float(tadam.lr_at(tc_t, tst.step)),
                               float(jadam.lr_at(tc_j, jst.step)), rtol=0)


def test_chunked_adam_offload_matches_reference_numpy_update(tmp_path):
    """Several chunks per key and a Future grad: the port's streamed update
    against the reference's numpy CPU-Adam, chunk for chunk."""
    store = toff.NvmeStore(str(tmp_path), workers=2)
    off = toff.ChunkedAdamOffload(store, chunk_elems=1000)
    rng = np.random.default_rng(9)
    params = {"a": rng.standard_normal((3, 700)).astype(np.float32),
              "b": rng.standard_normal(2500).astype(np.float32)}
    off.init_from_params({k: torch.from_numpy(v) for k, v in params.items()})
    want = {k: v.reshape(-1).copy() for k, v in params.items()}
    m = {k: np.zeros_like(v) for k, v in want.items()}
    v_ = {k: np.zeros_like(v) for k, v in want.items()}
    for step in range(1, 3):
        grads = {k: rng.standard_normal(p.shape).astype(np.float32)
                 for k, p in params.items()}
        fut = store.roundtrip("g/a", torch.from_numpy(grads["a"]))
        got = off.step({"a": fut, "b": torch.from_numpy(grads["b"])}, lr=1e-2)
        c1, c2 = 1 - 0.9 ** step, 1 - 0.95 ** step
        for k in want:
            joff._adam_update_numpy(want[k], m[k], v_[k], grads[k].reshape(-1),
                                    1e-2, 0.9, 0.95, 1e-8, 0.1, c1, c2)
            np.testing.assert_allclose(_np(got[k]).reshape(-1), want[k],
                                       rtol=1e-6, atol=1e-7)
    assert off.step_count == 2
    store.close()


def test_rows_take_the_host_adam_and_other_the_fused_path(tmp_path, monkeypatch):
    """Rows: the host Adam (``_adam_update``) with host-float bias
    corrections from ``step_count`` and lr = lr_at(step + 1); 'other':
    ``apply_updates`` through ``ops.fused_adam``, one launch per leaf."""
    _, trun = _runs(tmp_path)
    ex = texec.InfinityExecutor(trun, "cpu")
    calls = {"host": [], "fused": 0}
    real_host, real_fused = toff._adam_update, ops.fused_adam

    def host(p, m, v, g, lr, b1, b2, eps, wd, c1, c2):
        calls["host"].append((lr, c1, c2))
        return real_host(p, m, v, g, lr, b1, b2, eps, wd, c1, c2)

    def fused(*a):
        calls["fused"] += 1
        return real_fused(*a)

    monkeypatch.setattr(toff, "_adam_update", host)
    monkeypatch.setattr(ops, "fused_adam", fused)
    state = ex.init_state(torch.Generator().manual_seed(0))
    stream = tpipe.SyntheticStream(ex.input_specs(ShapeConfig("t", S, B, "train")),
                                   trun.model.vocab_size)
    step = ex.make_train_step()
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in stream.batch_at(i).items()}
        state, m = step(state, batch)
        n = i + 1
        lr = 3e-3 * min(n / 2, 1.0)
        assert calls["host"] == [(pytest.approx(lr), 1 - 0.9 ** n, 1 - 0.95 ** n)] * 2
        assert calls["fused"] == 2  # embed.tok and ln_f.scale
        assert float(m["lr"]) == pytest.approx(lr)
        calls["host"].clear()
        calls["fused"] = 0
    ex.close()


# ---------------------------------------------------------------------------
# the two host-link copies
# ---------------------------------------------------------------------------


class _FakeEvent:
    def __init__(self, on_sync=None):
        self.done = False
        self.on_sync = on_sync

    def query(self):
        return self.done

    def synchronize(self):
        if self.on_sync is not None:
            self.on_sync()
        self.done = True


def test_pinned_row_buffer_waits_for_its_copy_event():
    """A staged row's pinned buffer returns to the pool only after the
    non-blocking copy's event has completed; released earlier, the next row
    would overwrite it in flight."""
    pool = toff.PinnedBufferPool(1 << 20)
    stager = toff.PinnedStager(pool, "cpu")
    buf = pool.acquire(4096)
    ev = _FakeEvent()
    stager._pending.append((ev, buf))
    stager.retire()
    assert pool._outstanding == 4096  # copy in flight: the buffer is held
    assert pool.acquire(4096).data_ptr() != buf.data_ptr()
    ev.done = True
    stager.retire()
    assert pool._outstanding == 4096  # only the second buffer remains out
    ev2 = _FakeEvent()
    stager._pending.append((ev2, pool.acquire(8192)))
    stager.retire(wait=True)
    assert ev2.done and not stager._pending


def test_grad_drain_copies_after_the_ready_event(tmp_path):
    """The store worker waits on the event recorded behind the kernels that
    write the gradient before copying it: here the 'kernel' finishes only
    when the event is synchronized, and the store must hold the final
    values, never the half-written ones."""
    store = toff.NvmeStore(str(tmp_path), workers=2)
    g = torch.full((1000,), -1.0)  # half-written: still the old contents
    ev = _FakeEvent(on_sync=lambda: g.copy_(torch.arange(1000.0)))
    got = store.roundtrip("rank0/l0/g", g, ready=ev).result()
    assert torch.equal(got, torch.arange(1000.0))
    store.close()


# ---------------------------------------------------------------------------
# data, scheduler, CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_stream_bit_identical_to_reference(seed):
    jspecs = {"tokens": jax.ShapeDtypeStruct((4, 33), jnp.int32),
              "labels": jax.ShapeDtypeStruct((4, 33), jnp.int32)}
    tspecs = {k: tzero.TensorSpec((4, 33), torch.int32) for k in jspecs}
    js = jpipe.SyntheticStream(jspecs, 49152, seed=seed)
    ts = tpipe.SyntheticStream(tspecs, 49152, seed=seed)
    for step in range(4):
        jb, tb = js.batch_at(step), ts.batch_at(step)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])
    loader = tpipe.PrefetchLoader(ts, 1, 3, "cpu")
    got = [(step, b["tokens"]) for step, b in loader]
    assert [s for s, _ in got] == [1, 2]
    assert got[0][1].dtype == torch.int32
    np.testing.assert_array_equal(got[1][1].numpy(), js.batch_at(2)["tokens"])


@pytest.mark.parametrize("L,P,tokens", [(30, 3_540_096, 4096), (2, 1000, 32),
                                        (30, 3_540_096, 64), (1, 10, 10)])
def test_prefetch_window_equals_reference(L, P, tokens):
    assert (tsched.default_prefetch_layers(L, P, tokens)
            == jsched.default_prefetch_layers(L, P, tokens))
    for order in (None, [3, 1, 2, 0]):
        n = 4 if order else L
        win = tsched.default_prefetch_layers(L, P, tokens)
        jev = jsched.LayerSchedule(n, win, read_ahead=2).pass_events(order)
        tev = tsched.LayerSchedule(n, win, read_ahead=2).pass_events(order)
        assert [(e.op, e.unit) for e in tev] == [(e.op, e.unit) for e in jev]


BASE = ["--smoke", "--engine", "zero3", "--offload-param", "nvme",
        "--steps", "2", "--batch", "2", "--seq", "16"]


def test_cli_defaults_to_cuda_and_raises_without_it(tmp_path):
    args = ttrain.build_argparser().parse_args(BASE + ["--nvme-dir", str(tmp_path)])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train(args)


@pytest.mark.parametrize("extra", [
    ["--plan", "auto", "--hw-devices", "2"],
    ["--elastic"], ["--chaos", "fail@3"],
    ["--grad-compress", "int8"], ["--data-mesh", "2"], ["--model-mesh", "2"],
])
def test_cli_raises_on_every_unported_flag(tmp_path, extra):
    """What stays unported raises, naming its ROADMAP item; int8 gradient
    compression on the layered epoch (``BASE``) raises the reference's
    ``ValueError`` (the layered rows' reduce is not compressed there); a
    mesh of 2 in a run of one process, and a plan for 2 devices (whose
    ranks the mesh takes), raise, naming the torchrun launch that gives it
    its ranks (what stays unported on a mesh is held in
    ``tests/test_torch_dp.py`` and ``tests/test_torch_gspmd_mesh.py``)."""
    argv = (BASE + ["--device", "cpu", "--nvme-dir", str(tmp_path),
                    "--ckpt-dir", str(tmp_path / "ck")] + extra)
    error, match = ((ValueError, "grad_compression='int8'")
                    if extra == ["--grad-compress", "int8"]
                    else (ValueError, "torchrun --standalone --nproc-per-node 2")
                    if extra[0] in ("--data-mesh", "--model-mesh") or "--hw-devices" in extra
                    else (NotImplementedError, "ROADMAP"))
    with pytest.raises(error, match=match):
        ttrain.train(ttrain.build_argparser().parse_args(argv), argv)


# the card machine's capacities (device, host, NVMe bytes) and pinned rates,
# so both packages' planners see the same hardware
PLAN_HW = ["--hw-devices", "1", "--hw-device-mem", "85.02e9", "--hw-host-mem", "108.45e9",
           "--hw-nvme", "63.8e9", "--hw-nvme-bw", "2e9", "--hw-host-bw", "2e10",
           "--hw-peak-flops", "1e12"]


@pytest.mark.parametrize("arch,seq", [("seamless-m4t-medium", 48), ("mamba2-370m", 32)])
def test_cli_min_device_mem_trains_gspmd_on_nvme_as_the_reference(tmp_path, mesh, arch, seq):
    """``--plan auto --objective min_device_mem``: both planners put every
    state class on NVMe under the GSPMD engine (params through the leaf
    scheduler, the optimizer off-graph), and the port's CLI follows the
    reference CLI's losses from the same weights by TIER_TOL, each step
    reading and writing every leaf once."""
    common = (["--arch", arch, "--smoke", "--plan", "auto", "--objective", "min_device_mem",
               "--steps", "3", "--batch", "2", "--seq", str(seq), "--lr", "3e-3",
               "--log-every", "100", "--ckpt-every", "0"] + PLAN_HW)
    jargv = common + ["--nvme-dir", str(tmp_path / "jnv"), "--ckpt-dir", str(tmp_path / "jck")]
    targv = common + ["--device", "cpu", "--nvme-dir", str(tmp_path / "tnv"),
                      "--ckpt-dir", str(tmp_path / "tck")]
    jargs = jtrain.build_argparser().parse_args(jargv)
    jrun, _ = jtrain.make_run(jargs)
    init = jax.tree.map(np.asarray, jexec.make_engine(jrun, mesh).init_state(
        jax.random.PRNGKey(jargs.seed))["params"])
    jhist = jtrain.train(jargs)
    thist = ttrain.train(ttrain.build_argparser().parse_args(targv), targv,
                         init_state=lambda: {"params": bridge.params_from_numpy(init)})
    plan = thist["plan"]
    assert plan.engine == "pjit" and plan.feasible
    assert (plan.param_tier, plan.grad_tier, plan.opt_tier) == ("nvme", "nvme", "nvme")
    np.testing.assert_allclose(thist["losses"], jhist["losses"], **TIER_TOL)
    n = sum(math.prod(d.shape) * d.torch_dtype.itemsize
            for d in tpt.tree_leaves(treg.build(tconfigs.smoke(arch)).defs))
    for m in thist["metrics"]:
        assert m["param_in_bytes"] == m["param_out_bytes"] == m["param_total_bytes"] == n
        assert m["plan_residency_ok"] is True


def test_cli_trains_gspmd_nvme_params_in_graph_under_dots(tmp_path):
    """``--engine pjit --offload-param nvme --remat dots``: the leaf
    scheduler feeds the in-graph update, whose new leaves go back to the
    store each step; the loss falls."""
    hist = ttrain.main(["--smoke", "--device", "cpu", "--engine", "pjit",
                        "--offload-param", "nvme", "--remat", "dots", "--steps", "4",
                        "--batch", "2", "--seq", "16", "--lr", "3e-3", "--log-every", "100",
                        "--nvme-dir", str(tmp_path), "--ckpt-every", "0"])
    assert hist["run"].parallel.remat == "dots" and not hist["run"].opt_offgraph
    losses = hist["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    for m in hist["metrics"]:
        assert 0 < m["peak_resident_param_bytes"] < m["param_total_bytes"] \
            == m["param_in_bytes"] == m["param_out_bytes"]


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    hist = ttrain.main(BASE + ["--device", "cpu", "--offload-grad", "nvme",
                               "--offload-opt", "nvme", "--lr", "3e-3",
                               "--nvme-dir", str(tmp_path), "--steps", "3"])
    assert len(hist["losses"]) == 3 and np.isfinite(hist["losses"]).all()
    for rec in hist["metrics"]:
        assert rec["param_in_bytes"] > 0 and rec["grad_out_bytes"] > 0
        assert rec["opt_read_bytes"] > 0 and rec["step_time"] > 0
    assert hist["nvme_stats"]["bytes_written"] > 0
    assert "done in" in capsys.readouterr().out


def test_cli_trains_q4_rows_on_the_cpu_with_falling_loss(tmp_path):
    """``--param-quant q4``: rows cross the tier as q4 frames and decode on
    the host; the loss falls and the param tier moves ~0.31x of bf16."""
    hist = ttrain.main(BASE + ["--device", "cpu", "--offload-grad", "nvme",
                               "--offload-opt", "nvme", "--lr", "3e-3", "--param-quant",
                               "q4", "--nvme-dir", str(tmp_path), "--steps", "6"])
    losses = hist["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert hist["quantized_leaves"] == ()  # no kernel consumes q4 rows
    for rec in hist["metrics"]:
        assert 0 < rec["param_in_wire_bytes"] <= 0.35 * rec["param_in_bytes"]


# ---------------------------------------------------------------------------
# quantized tier transport (--param-quant q8 | q4)
# ---------------------------------------------------------------------------

# smoke smollm at d_model 64: every MLP leaf's offset and N are multiples of
# the 32-element quant block, so q8 rows feed all three projections as they
# are (at the smoke width 48, w_out's N is not)
QUANT_D = 64
MLP_LEAVES = (("mlp", "w_gate"), ("mlp", "w_in"), ("mlp", "w_out"))
# Bounds as multiples of the bf16 rows' (TIER_TOL on loss and grad norm,
# 2^-5 * sum(lr) on the rows' mean drift). After each update both packages
# re-encode their own rows: two masters a rounding apart can land one level
# apart. q8's 255 levels keep the gaps inside the bf16 bounds (measured on
# the CPU: loss 0.06, grad norm 0.82, rows 0.27 of them). A q4 block has 16
# levels, range/15 apart, so a flip moves ~2^-4 of the block's spread where
# a bf16 rounding moves 2^-8 of a value; measured loss 0.15, grad norm 3.3,
# rows 1.2 of the bf16 bounds. Each q4 bound sits between that gap and the
# one a planted fault opens (a layer's row never written back: loss 2.9,
# grad norm 20, rows 11; test_quantized_bounds_reject_a_row_never_written).
QUANT_FACTOR = {"q8": {"loss": 1, "grad_norm": 1, "lr": 1, "rows": 1},
                "q4": {"loss": 1, "grad_norm": 8, "lr": 1, "rows": 4}}


@pytest.fixture(scope="module", params=["q8", "q4"])
def quant_run(request, tmp_path_factory, mesh):
    out = _both_executors(tmp_path_factory.mktemp(request.param), mesh,
                          d_model=QUANT_D, param_quant=request.param)
    out.quant = request.param
    yield out
    out.tex.close()
    out.jex.close()


@pytest.mark.parametrize("step", range(STEPS))
def test_quantized_layered_step_matches_reference(quant_run, step):
    """The port's layered step against the reference executor's under the
    same ``param_quant``, loss and grad norm by TIER_TOL (scaled by
    ``QUANT_FACTOR``). Under q8 the port's MLP products take the
    dequantized weight in f32 (the TPU kernel's math) where the reference
    rounds it to bf16: a relative 2^-9 per weight, at or below the bf16
    rounding of the outputs."""
    jm, tm = quant_run.jm[step], quant_run.tm[step]
    for key in ("loss", "grad_norm", "lr"):
        tol = {k: v * QUANT_FACTOR[quant_run.quant][key] for k, v in TIER_TOL.items()}
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **tol, err_msg=key)


def _quantized_row_gap(quant_run, tex):
    """``tex``'s rows after the last step against the reference's: (|diff|,
    each element's bound, the mean's bound). Beyond the bf16 rows' bound,
    each package re-encodes its own updated row: values a hair apart may
    round to neighbouring quants, one quant step apart, and a block's scale
    follows its largest element; one step is at most the block's absmax/127
    (q8) or range/15 (q4), taken twice for the two encodes. In the bulk the
    flips average out to the values' own drift (``QUANT_FACTOR``)."""
    want = np.asarray(quant_run.jex._materialize_flat()).astype(np.float32)
    got = _np(tex.materialize_flat())
    assert got.shape == want.shape
    lrs = [float(m["lr"]) for m in quant_run.jm]
    blocks = np.pad(want, ((0, 0), (0, (-want.shape[1]) % 32))).reshape(want.shape[0], -1, 32)
    if quant_run.quant == "q8":
        step = np.abs(blocks).max(-1) / 127.0
    else:
        step = (blocks.max(-1) - blocks.min(-1)) / 15.0
    step = np.repeat(step, 32, axis=1)[:, :want.shape[1]]
    drift = tadam.parity_bound(quant_run.trun.train, lrs)
    return (np.abs(got - want), drift + 2**-8 * np.abs(want) + 2 * step,
            QUANT_FACTOR[quant_run.quant]["rows"] * 2**-5 * sum(lrs))


def test_quantized_rows_after_last_step_match_reference(quant_run):
    """Rows read back (decoded) after the last step (``_quantized_row_gap``)."""
    diff, allowed, mean_bound = _quantized_row_gap(quant_run, quant_run.tex)
    assert (diff <= allowed).all(), diff.max()
    assert diff.mean() <= mean_bound, diff.mean()


@contextlib.contextmanager
def _row_never_written(layer: int = 1):
    """A planted fault: ``layer``'s updated row is never written back (its
    master moves on in the host optimizer, the stored row stays as seeded)."""
    write_row = toff.ParamStreamer.write_row

    def drop(self, name, i, t):
        if i != layer:
            return write_row(self, name, i, t)
        done = Future()
        done.set_result(None)
        return done

    toff.ParamStreamer.write_row = drop
    try:
        yield
    finally:
        toff.ParamStreamer.write_row = write_row


def _quantized_gaps(quant_run, tex, tm) -> dict:
    """Each gap to the reference over its bf16 bound (QUANT_FACTOR's units):
    loss and grad norm per step, the rows' mean drift after the last."""
    out = {key: [abs(float(t[key]) - float(j[key]))
                 / (TIER_TOL["atol"] + TIER_TOL["rtol"] * abs(float(j[key])))
                 for t, j in zip(tm, quant_run.jm)] for key in ("loss", "grad_norm")}
    diff, _, mean_bound = _quantized_row_gap(quant_run, tex)
    out["rows"] = float(diff.mean() / mean_bound) * QUANT_FACTOR[quant_run.quant]["rows"]
    return out


def test_quantized_bounds_reject_a_row_never_written(quant_run, tmp_path):
    """The planted fault ``_row_never_written`` must leave the bounds: the
    last step's loss and grad norm and the rows' mean drift all do."""
    _, trun = _runs(tmp_path, d_model=QUANT_D, param_quant=quant_run.quant)
    with _row_never_written():
        tex, _, tm, _ = _port_steps(trun, quant_run.init)
    try:
        gaps = _quantized_gaps(quant_run, tex, tm)
    finally:
        tex.close()
    for key in ("loss", "grad_norm", "rows"):
        last = gaps[key][-1] if key != "rows" else gaps[key]
        assert last > QUANT_FACTOR[quant_run.quant][key], (key, gaps)


def test_quantized_rows_cross_the_tier_as_wire_bytes(quant_run):
    """Every tier still moves bytes every step; the param tier's wire bytes
    are the format's share of the logical bf16 bytes (q8 34/64, q4 20/64,
    plus a header per row)."""
    L, P = 2, quant_run.tex.engine.layout.padded
    share = {"q8": 0.6, "q4": 0.35}[quant_run.quant]
    for tm, jm in zip(quant_run.tm, quant_run.jm):
        assert tm["param_in_bytes"] == 2 * L * P * 2
        assert tm["param_out_bytes"] == L * P * 2
        assert 0 < tm["param_in_wire_bytes"] <= share * tm["param_in_bytes"]
        assert 0 < tm["param_out_wire_bytes"] <= share * tm["param_out_bytes"]
        for key in ("param_in_bytes", "param_in_wire_bytes", "param_out_bytes",
                    "param_out_wire_bytes", "grad_out_bytes", "opt_read_bytes"):
            assert tm[key] == jm[key], key
        assert tm["nvme_bytes_read"] == (tm["param_in_wire_bytes"] + tm["opt_read_bytes"]
                                         + tm["grad_out_bytes"])


def test_quantized_plan_takes_every_aligned_mlp_leaf(quant_run):
    """q8 at d_model 64: all three MLP weights go into the quantized
    product; q4 rows feed no kernel."""
    want = MLP_LEAVES if quant_run.quant == "q8" else ()
    assert quant_run.tex.engine.quantized_leaves == want


def test_quantized_prefetch_window_equals_reference():
    for quant in ("none", "q8", "q4"):
        for L, P, tokens in ((30, 3_540_096, 4096), (30, 3_540_096, 64), (2, 1000, 32)):
            assert (tsched.default_prefetch_layers(
                        L, P, tokens, compression_ratio=tqformat.compression_ratio(quant))
                    == jsched.default_prefetch_layers(
                        L, P, tokens, compression_ratio=jqformat.compression_ratio(quant)))
    assert (tsched.default_prefetch_layers(30, 3_540_096, 4096, compression_ratio=64 / 34)
            > tsched.default_prefetch_layers(30, 3_540_096, 4096))


@pytest.fixture(scope="module")
def wire_pieces(mesh, tmp_path_factory):
    """One q8 wire row (the reference's encoder) and its host decode, at
    the aligned width (d_model 64) and at the smoke width (48)."""
    out = {}
    for d in (QUANT_D, None):
        jrun, trun = _runs(tmp_path_factory.mktemp("wire"), d_model=d, param_quant="q8")
        jeng = jexec.make_engine(jrun, mesh)
        row = np.asarray(jeng.init_state(jax.random.PRNGKey(4))["flat"][1])
        wire = jqformat.encode_array(row, "q8")
        teng = tzero.ExplicitZero3Engine(trun, "cpu")
        stager = toff.PinnedStager(toff.PinnedBufferPool(1 << 20), "cpu")
        out[d] = types.SimpleNamespace(
            jeng=jeng, teng=teng, decoded=jqformat.decode_array(wire),
            wire=tqformat.wire_row_device(torch.from_numpy(wire.copy()), stager))
    return out


@pytest.mark.parametrize("d_model", [QUANT_D, None])
def test_wire_row_leaves_match_the_reference_host_decode(wire_pieces, d_model):
    """Every leaf outside the plan is the reference's host-decoded bf16
    value bit for bit; each planned leaf's quants and scales dequantize to
    it in f32. At the smoke width w_out (N = 48) takes the dequantized
    route, and nothing unaligned is planned."""
    wp = wire_pieces[d_model]
    plan = wp.teng.quantized_leaves
    if d_model is None:
        assert plan == (("mlp", "w_gate"), ("mlp", "w_in"))
    else:
        assert plan == MLP_LEAVES
    tree = tpt.unflatten_wire_row(*wp.wire, None, wp.teng.layout, plan)
    jtree = wp.jeng._unflatten_layer(jnp.asarray(wp.decoded))
    off = 0
    for path, shape, size in zip(wp.teng.layout.paths, wp.teng.layout.shapes,
                                 wp.teng.layout.sizes):
        leaf, want = tpt.tree_get(tree, path), _np(tpt.tree_get(jtree, path))
        if path in plan:
            assert isinstance(leaf, tpt.QWeight) and off % 32 == 0 and shape[1] % 32 == 0
            np.testing.assert_array_equal(
                tqformat.dequant_q8(leaf.q, leaf.s).to(torch.bfloat16).float().numpy(), want)
        else:
            assert leaf.dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(leaf), want)
        off += size


@pytest.mark.parametrize("d_model", [QUANT_D, None])
def test_wire_row_layer_pieces_match_reference(wire_pieces, d_model):
    """``layer_fwd`` and ``layer_vjp`` on the q8 wire row against the
    reference's on its host-decoded bf16 row (2e-2 of the largest element,
    as the bf16-row pieces): every leaf gets a gradient, the padding none,
    and the row gradient is a bf16 row's cotangent carried in f32."""
    wp = wire_pieces[d_model]
    d = wp.teng.run.model.d_model
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((B, S, d)) * 0.5).astype(np.float32)
    dy = (rng.standard_normal((B, S, d)) * 0.1).astype(np.float32)
    jx, tx = _bf16(x)
    jdy, tdy = _bf16(dy)
    jfns, tfns = wp.jeng.make_layer_fns(), wp.teng.make_layer_fns()
    row_j = jnp.asarray(wp.decoded)
    _close(tfns["layer_fwd"](tx, wp.wire), jfns["layer_fwd"](jx, row_j), 2e-2)
    jdx, jg = jfns["layer_vjp"](jx, row_j, jdy)
    tdx, tg = tfns["layer_vjp"](tx, wp.wire, tdy)
    assert tg.dtype == torch.float32 and torch.equal(tg, tg.to(torch.bfloat16).float())
    _close(tdx, jdx, 2e-2)
    _close(tg, jg, 2e-2)
    off = 0
    for size in wp.teng.layout.sizes:
        assert tg[off:off + size].abs().sum() > 0
        off += size
    assert tg[off:].abs().sum() == 0


if __name__ == "__main__":
    # The readings behind QUANT_FACTOR: each gap to the reference over its
    # bf16 bound, clean and under the planted fault, for q8 and q4 rows:
    #   JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_training.py
    import json
    import tempfile

    for fmt in ("q8", "q4"):
        with tempfile.TemporaryDirectory() as d:
            run = _both_executors(f"{d}/clean", make_local_mesh(1, 1), d_model=QUANT_D,
                                  param_quant=fmt)
            run.quant = fmt
            _, fault_run = _runs(f"{d}/fault", d_model=QUANT_D, param_quant=fmt)
            with _row_never_written():
                fault_tex, _, fault_tm, _ = _port_steps(fault_run, run.init)
            print(json.dumps({"param_quant": fmt, "bound": QUANT_FACTOR[fmt],
                              "clean": _quantized_gaps(run, run.tex, run.tm),
                              "row_never_written": _quantized_gaps(run, fault_tex, fault_tm)}))
            for ex in (fault_tex, run.tex, run.jex):
                ex.close()
