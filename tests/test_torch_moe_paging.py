"""MoE expert paging through the layer scheduler, on the port: the mirror of
``tests/test_moe_paging.py`` on the CPU.

With every state class on NVMe the explicit engine runs a granite-moe smoke
model as the layered epoch: each layer's dense row follows the static plan
while its router-selected expert rows page as ``("x", layer, expert)``
units in fixed-width waves. The paged trajectory must match the port's
all-resident GSPMD one and the reference's ``InfinityExecutor(engine=
"zero3")`` from the same weights and batches, with expert residency
strictly below all expert bytes; the hot cache, the routing metrics, the
construction gate, the schedule's MoE classes and a q8 run are held too.

Tolerances: the reference's own for the paged run against the
all-resident one (``tests/test_moe_paging.py``: ``LOSS_TOL`` rtol = atol =
2e-3, ``GNORM_TOL`` 1e-2; the wave-granular combine rounds to bf16 per
wave where the resident graph sums once), used for the reference's paged
run too. Rows after the last step against the reference's: AdamW's bounded
update, ``adam.parity_bound`` plus each side's bf16 rounding per element,
their mean within 2^-5 * sum(lr) (``tests/test_torch_training.py``).
"""
import dataclasses
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
from repro.core import schedule as jsched  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import RunConfig, ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.config import make_offload, make_parallel  # noqa: E402
from repro_torch.core import executor as texec  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core.zero import ExplicitZero3Engine  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402

LOSS_TOL = dict(rtol=2e-3, atol=2e-3)
GNORM_TOL = dict(rtol=1e-2, atol=1e-2)
ARCH = "granite-moe-1b-a400m"
STEPS = 3
B, S = 2, 16


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tiers(param):
    return dict(param_tier=param, grad_tier=param, opt_tier=param) if param == "nvme" \
        else {}


def _trun(nvme_dir, engine="zero3", param="nvme", hot_mb=0, quant="none", window=2):
    return RunConfig(model=tconfigs.smoke(ARCH), parallel=make_parallel(engine, remat="none"),
                     offload=make_offload(nvme_dir=str(nvme_dir), prefetch_layers=window,
                                          expert_hot_mb=hot_mb, param_quant=quant,
                                          **_tiers(param)),
                     train=TrainConfig(lr=3e-3, warmup_steps=2))


def _jrun(nvme_dir, quant="none"):
    return JRun(model=jconfigs.smoke(ARCH), parallel=jmake_parallel("zero3", remat="none"),
                offload=jmake_offload(nvme_dir=str(nvme_dir), prefetch_layers=2,
                                      param_quant=quant, **_tiers("nvme")),
                train=JTrain(lr=3e-3, warmup_steps=2))


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh(1, 1)


@pytest.fixture(scope="module")
def init(mesh, tmp_path_factory):
    """The reference explicit engine's initial MoE state, as numpy: the
    dense rows ``flat``, the expert rows ``eflat``, ``other`` (the f32
    router among them), ``other_opt``, ``step``."""
    jex = jexec.InfinityExecutor(_jrun(tmp_path_factory.mktemp("init")), mesh)
    state = jax.tree.map(np.asarray, jex.engine.init_state(jax.random.PRNGKey(0)))
    jex.close()
    return state


def _stream():
    cfg = tconfigs.smoke(ARCH)
    return tpipe.SyntheticStream(treg.build(cfg).input_specs(ShapeConfig("t", S, B, "train")),
                                 cfg.vocab_size, seed=0)


def _port_run(trun, init, steps=STEPS, batch_size=None):
    """The port's executor, ``steps`` steps from ``init`` on one batch, as
    the reference's test takes (``batch_size`` cuts it to its first
    rows)."""
    tex = texec.InfinityExecutor(trun, "cpu")
    state0 = bridge.zero3_state_from_numpy(init)
    if trun.parallel.engine == "zero3":
        state = tex.reseed(tex.engine.place_state(state0))
    else:
        eng = ExplicitZero3Engine(_trun("unused"), "cpu")
        state = tex.reseed(tex.engine.adopt_params(eng.params_from_state(state0)))
    stream, fn, ms = _stream(), tex.make_train_step(), []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v[:batch_size]) for k, v in stream.batch_at(0).items()}
        state, m = fn(state, batch)
        ms.append(m)
    return types.SimpleNamespace(ex=tex, state=state, m=ms,
                                 traj=np.asarray([(float(m["loss"]), float(m["grad_norm"]))
                                                  for m in ms]))


def _ref_run(mesh, nvme_dir, init, steps=STEPS, quant="none", batch_size=None):
    jex = jexec.InfinityExecutor(_jrun(nvme_dir, quant), mesh)
    state = jex.reseed(jax.tree.map(jnp.asarray, init))
    stream, fn, ms = _stream(), jex.make_train_step(), []
    for _ in range(steps):
        batch = {k: jnp.asarray(v[:batch_size]) for k, v in stream.batch_at(0).items()}
        state, m = fn(state, batch)
        ms.append(m)
    return types.SimpleNamespace(ex=jex, state=state, m=ms,
                                 traj=np.asarray([(float(m["loss"]), float(m["grad_norm"]))
                                                  for m in ms]))


@pytest.fixture(scope="module")
def resident(init, tmp_path_factory):
    """The port's all-resident GSPMD trajectory: the baseline every paged
    run must hit."""
    run = _port_run(_trun(tmp_path_factory.mktemp("dev"), engine="pjit", param="device"), init)
    yield run
    run.ex.close()


@pytest.fixture(scope="module")
def paged(init, tmp_path_factory):
    run = _port_run(_trun(tmp_path_factory.mktemp("nvme")), init)
    yield run
    run.ex.close()


@pytest.fixture(scope="module")
def reference(init, mesh, tmp_path_factory):
    run = _ref_run(mesh, tmp_path_factory.mktemp("ref"), init)
    yield run
    run.ex.close()


# ---------------------------------------------------------------------------
# the paged trajectory
# ---------------------------------------------------------------------------


def test_paged_trajectory_matches_the_all_resident_one(paged, resident):
    np.testing.assert_allclose(paged.traj[:, 0], resident.traj[:, 0], **LOSS_TOL)
    np.testing.assert_allclose(paged.traj[:, 1], resident.traj[:, 1], **GNORM_TOL)
    assert resident.traj[-1, 0] < resident.traj[0, 0]  # losses actually move


def test_paged_trajectory_matches_the_reference_zero3_run(paged, reference):
    """Loss and grad norm by the tolerances above; the routing metrics
    within one assignment per layer: after a step of training the two
    frameworks' bf16 activations may round one token's k-th and (k+1)-th
    gates apart (measured: one assignment, at the second step), which
    moves the drop fraction and an expert's load by 1 / (B * S * k) over
    the layers' mean."""
    np.testing.assert_allclose(paged.traj[:, 0], reference.traj[:, 0], **LOSS_TOL)
    np.testing.assert_allclose(paged.traj[:, 1], reference.traj[:, 1], **GNORM_TOL)
    one = 1.0 / (B * S * tconfigs.smoke(ARCH).top_k)
    for tm, jm in zip(paged.m, reference.m):
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
        np.testing.assert_allclose(tm["moe_dropped_token_fraction"],
                                   float(jm["moe_dropped_token_fraction"]), atol=one + 1e-6)
        np.testing.assert_allclose(_np(tm["moe_expert_load"]),
                                   np.asarray(jm["moe_expert_load"]), atol=one + 1e-6)


def test_rows_after_the_last_step_match_the_reference(paged, reference):
    """Dense and expert rows read back from the param store, and the f32
    router updated on the device, against the reference's."""
    jflat, jeflat = reference.ex._materialize_rows()
    rows = paged.ex.materialize_rows()
    lrs = [float(m["lr"]) for m in reference.m]
    drift = tadam.parity_bound(TrainConfig(lr=3e-3, warmup_steps=2), lrs)
    for got, want in ((rows["flat"], jflat), (rows["eflat"], jeflat),
                      (paged.state["other"]["router"], reference.state["other"]["router"])):
        got, want = _np(got), np.asarray(want).astype(np.float32)
        assert got.shape == want.shape
        diff = np.abs(got - want)
        assert (diff <= drift + 2**-8 * np.abs(want)).all(), diff.max()
        assert diff.mean() <= 2**-5 * sum(lrs), diff.mean()


def test_paged_params_drive_the_same_greedy_predictions(paged, resident):
    """The trained params reassembled from the stores (the engine's
    ``params_from_state``) give the all-resident run's argmax."""
    b = treg.build(tconfigs.smoke(ARCH))
    toks = torch.from_numpy(_stream().batch_at(0)["tokens"])
    params = paged.ex.engine.params_from_state(paged.ex.checkpoint_state(paged.state))
    lg_paged, _ = b.prefill(params, {"tokens": toks})
    lg_base, _ = b.prefill(resident.state["params"], {"tokens": toks})
    np.testing.assert_array_equal(lg_paged.float().argmax(-1).numpy(),
                                  lg_base.float().argmax(-1).numpy())


def test_expert_rows_page_below_all_expert_bytes(paged):
    ex, m = paged.ex, paged.m[-1]
    assert 0 < m["expert_peak_resident_bytes"] < m["expert_total_bytes"]
    assert m["expert_total_bytes"] == ex.expert_total_bytes
    assert 0.0 <= m["expert_prefetch_hit_rate"] <= 1.0
    assert m["expert_evictions"] > 0
    # the aggregate residency bound holds with the experts included
    assert 0 < m["peak_resident_param_bytes"] < ex.total_param_bytes == m["param_total_bytes"]
    # both carried leaves are placeholders: the stores hold the params
    for key in ("flat", "eflat"):
        assert not isinstance(paged.state[key], torch.Tensor)
    eng = ex.engine
    assert tuple(paged.state["eflat"].shape) == (eng.n_layers * eng.n_experts,
                                                 eng.elayout.padded)


def test_expert_residency_counts_match_the_reference(paged, reference):
    """The same routing pages the same rows: equal expert bytes, peak
    residency and evictions at every step (the hit rate depends on when
    each read lands, so only its range is held)."""
    for tm, jm in zip(paged.m, reference.m):
        for key in ("expert_total_bytes", "expert_peak_resident_bytes", "expert_evictions",
                    "peak_resident_param_bytes", "evictions", "param_total_bytes"):
            assert tm[key] == jm[key], key


def test_routing_health_metrics_on_both_engines(paged, resident):
    cfg = tconfigs.smoke(ARCH)
    for mm in (resident.m[0], paged.m[0]):
        assert 0.0 <= float(mm["moe_dropped_token_fraction"]) <= 1.0
        load = _np(mm["moe_expert_load"])
        assert load.shape == (cfg.n_experts,)
        assert np.all(load >= 0.0) and abs(float(load.sum()) - 1.0) < 1e-6


# ---------------------------------------------------------------------------
# the hot cache, unrouted experts, quantized rows, the gate
# ---------------------------------------------------------------------------


def test_hot_cache_holds_experts_across_steps(init, tmp_path):
    """A 1 MiB budget holds every expert row of the smoke model: after the
    first step every use is a hit and nothing is evicted."""
    run = _port_run(_trun(tmp_path, hot_mb=1), init, steps=2)
    m = run.m[-1]
    assert m["expert_prefetch_hit_rate"] == 1.0
    assert 0 < m["expert_peak_resident_bytes"] <= run.ex.expert_total_bytes
    assert m["expert_evictions"] == 0
    run.ex.close()


def test_hot_cache_serves_the_updated_rows(init, paged, tmp_path):
    """Hot rows are refreshed from the new masters after each write-back,
    so a run whose every expert row stays hot repeats the cold run bit for
    bit (a stale hot row would serve the step before's values)."""
    run = _port_run(_trun(tmp_path, hot_mb=1), init, steps=STEPS)
    np.testing.assert_array_equal(run.traj, paged.traj)
    got, want = run.ex.materialize_rows(), paged.ex.materialize_rows()
    for key in ("flat", "eflat"):
        assert torch.equal(got[key], want[key]), key
    run.ex.close()


def test_unrouted_experts_take_their_zero_gradient_adam_step(init, mesh, tmp_path,
                                                             monkeypatch):
    """One sequence of 4 tokens routes 8 assignments over 8 experts: some
    expert of some layer gets none, and still steps on a known-zero
    gradient. Two steps against the reference's rows show it (a skipped
    update shows only from the second step)."""
    fed = []
    step = texec.ChunkedAdamOffload.step

    def spy(self, grads, **kw):
        fed.append([k for k, g in grads.items() if k.startswith("xrank")
                    and isinstance(g, torch.Tensor) and not g.any()])
        return step(self, grads, **kw)

    monkeypatch.setattr(texec.ChunkedAdamOffload, "step", spy)
    run = _port_run(_trun(tmp_path / "t"), init, steps=2, batch_size=1)
    ref = _ref_run(mesh, tmp_path / "j", init, steps=2, batch_size=1)
    assert all(len(keys) > 0 for keys in fed), fed
    jflat, jeflat = ref.ex._materialize_rows()
    lrs = [float(m["lr"]) for m in ref.m]
    drift = tadam.parity_bound(TrainConfig(lr=3e-3, warmup_steps=2), lrs)
    got = _np(run.ex.materialize_rows()["eflat"])
    want = np.asarray(jeflat).astype(np.float32)
    diff = np.abs(got - want)
    assert (diff <= drift + 2**-8 * np.abs(want)).all(), diff.max()
    assert diff.mean() <= 2**-5 * sum(lrs)
    np.testing.assert_allclose(run.traj[:, 0], ref.traj[:, 0], **LOSS_TOL)
    run.ex.close()
    ref.ex.close()


def test_q8_moe_layered_run_matches_the_reference(init, mesh, tmp_path):
    """``param_quant="q8"``: rows cross the tier as q8 wire bytes; the
    expert rows arrive decoded by the store (the reference's path), the
    dense rows as wire operands. Two steps against the reference's q8 run."""
    run = _port_run(_trun(tmp_path / "t", quant="q8"), init, steps=2)
    ref = _ref_run(mesh, tmp_path / "j", init, steps=2, quant="q8")
    np.testing.assert_allclose(run.traj[:, 0], ref.traj[:, 0], **LOSS_TOL)
    np.testing.assert_allclose(run.traj[:, 1], ref.traj[:, 1], **GNORM_TOL)
    for m in run.m:
        assert 0 < m["param_in_wire_bytes"] <= 0.54 * m["param_in_bytes"]
        assert 0 < m["expert_peak_resident_bytes"] < m["expert_total_bytes"]
    run.ex.close()
    ref.ex.close()


@pytest.mark.parametrize("param", ["device", "host"])
def test_moe_zero3_requires_nvme_params(tmp_path, param):
    """No all-resident explicit MoE path: the gate raises at construction,
    with the reference's words."""
    run = RunConfig(model=tconfigs.smoke(ARCH), parallel=make_parallel("zero3", remat="none"),
                    offload=make_offload(param_tier=param, opt_tier="nvme",
                                         nvme_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="param_tier='nvme'") as got:
        texec.InfinityExecutor(run, "cpu")
    jrun = JRun(model=jconfigs.smoke(ARCH), parallel=jmake_parallel("zero3", remat="none"),
                offload=jmake_offload(param_tier=param, opt_tier="nvme",
                                      nvme_dir=str(tmp_path)))
    with pytest.raises(ValueError) as want:
        jexec.InfinityExecutor(jrun, make_local_mesh(1, 1))
    assert str(got.value) == str(want.value)


def test_monolithic_step_refuses_moe(tmp_path):
    eng = ExplicitZero3Engine(_trun(tmp_path), "cpu")
    with pytest.raises(NotImplementedError, match="layered epoch"):
        eng.make_train_step()


def test_engine_layout_and_counts_match_the_reference(init, mesh, tmp_path):
    """The dense and expert row layouts, the state's leaves and the active
    parameter count (top_k of E experts) are the reference's."""
    jex = jexec.InfinityExecutor(_jrun(tmp_path), mesh)
    teng = ExplicitZero3Engine(_trun(tmp_path), "cpu")
    jeng = jex.engine
    assert teng.layout.padded == jeng.layout.padded
    assert teng.elayout.padded == jeng.elayout.padded
    assert teng.elayout.shapes == [tuple(s) for s in jeng.elayout.shapes]
    assert teng.n_params_active() == jeng.n_params_active()
    state = bridge.zero3_state_from_numpy(init)
    assert tuple(state["eflat"].shape) == init["eflat"].shape
    assert sorted(teng.portable_keys) == sorted(jex.portable_state(
        jex.checkpoint_state(jex.engine.init_state(jax.random.PRNGKey(0)))))
    # full width: granite's 32 x 24 expert rows of 1,572,864 params each
    full = ExplicitZero3Engine(RunConfig(
        model=tconfigs.get(ARCH), parallel=make_parallel("zero3"),
        offload=make_offload(param_tier="nvme", grad_tier="nvme", opt_tier="nvme")), "cpu")
    assert full.elayout.padded == 1_572_864
    jex.close()


def test_expert_waves_are_the_reference_waves():
    for sel, W in (([0, 3, 5], 2), ([1], 2), ([0, 1, 2, 3], 2), ([4, 6, 7], 1)):
        got = texec.InfinityExecutor._expert_waves(sel, W)
        want = jexec.InfinityExecutor._expert_waves(sel, W)
        assert [(w, list(i), list(m)) for w, i, m in got] == \
            [(w, i.tolist(), m.tolist()) for w, i, m in want]


# ---------------------------------------------------------------------------
# the schedule's MoE classes against the reference's
# ---------------------------------------------------------------------------


def _engines(mod):
    def fetch(unit):
        f = Future()
        f.set_result(np.zeros(64, np.uint8) if mod is jsched else torch.zeros(64, dtype=torch.uint8))
        return [f]

    ws = mod.WorkingSetManager()
    return ws, mod.PrefetchEngine(fetch, ws, cls="expert")


def test_popularity_and_hot_cache_match_the_reference_on_one_offer_sequence():
    rng = np.random.default_rng(0)
    out = []
    for mod in (jsched, tsched):
        ws, pe = _engines(mod)
        pop = mod.ExpertPopularity()
        hot = mod.HotUnitCache(mod.resolve_expert_hot_bytes(0, 2, 64), pe)
        log = []
        r = np.random.default_rng(0)
        for step in range(4):
            ws.begin_step()
            for layer in range(2):
                load = r.dirichlet(np.ones(8))
                pop.update(layer, load)
                for e in pop.top(layer, 3) + [int(r.integers(8))]:
                    u = ("x", layer, e)
                    if hot.get(u) is None:
                        pe.prefetch(u)
                        pe.materialize(u)
                        if not hot.offer(u, f"{u}", 64, popularity=pop.score(layer, e)):
                            pe.evict(u)
            log.append((sorted(hot.units()), hot.bytes, ws.stats(),
                        [pop.top(l, 4) for l in range(2)]))
        out.append(log)
    assert rng is not None and out[0] == out[1]
    for mb, k, row in ((0, 8, 3 << 20), (64, 8, 3 << 20), (0, 1, 100)):
        assert tsched.resolve_expert_hot_bytes(mb, k, row) == \
            jsched.resolve_expert_hot_bytes(mb, k, row)


def test_working_set_counts_each_class_as_the_reference():
    out = []
    for mod in (jsched, tsched):
        ws = mod.WorkingSetManager()
        ws.on_materialize(10, True, "expert")
        ws.on_materialize(5, False)
        ws.on_hit("expert")
        ws.on_evict(10, "expert")
        ws.begin_step()
        ws.on_materialize(7, False, "expert")
        out.append(ws.stats())
    assert out[0] == out[1]
    assert out[1]["expert_peak_resident_bytes"] == 7


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def test_serve_moe_with_kv_paged_to_the_host_matches_the_all_device_run(tmp_path):
    """More sequences than slots, KV waiting on the host tier: each
    sequence's tokens are the all-device run's (a prompt routes as its own
    group, a decode token as its own)."""
    from repro_torch.launch import serve

    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "5",
            "--prompt-len", "16", "--new-tokens", "6"]
    paged = serve.run_serve(serve._parse(base + ["--kv-tier", "host", "--kv-slots", "2"]))
    full = serve.run_serve(serve._parse(base + ["--kv-slots", "5"]))
    assert paged["generated"] == full["generated"]
    assert all(paged["done"]) and paged["admissions"] == 3
    assert all(len(g) == 6 for g in paged["generated"])


def test_train_cli_runs_moe_under_the_plan_and_the_layered_epoch(tmp_path, capsys):
    """``--plan auto`` plans the smoke MoE all on the device (the GSPMD
    step); ``--engine zero3`` with NVMe tiers runs the layered epoch, its
    depth cut by ``--layers``. Both print the run's ``moe:`` line."""
    from repro_torch.launch import train as ttrain

    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "16", "--lr", "3e-3", "--ckpt-every", "0", "--log-every", "1",
            "--nvme-dir", str(tmp_path / "nv")]
    hist = ttrain.main(base + ["--plan", "auto"])
    assert hist["plan"].engine == "pjit" and hist["plan"].param_tier == "device"
    assert "moe: dropped" in capsys.readouterr().out
    m = hist["metrics"][-1]
    assert len(m["moe_expert_load"]) == tconfigs.smoke(ARCH).n_experts
    assert all(isinstance(v, float) for v in m["moe_expert_load"])
    hist = ttrain.main(base + ["--engine", "zero3", "--offload-param", "nvme",
                               "--offload-grad", "nvme", "--offload-opt", "nvme",
                               "--layers", "1"])
    out = capsys.readouterr().out
    assert "expert rows resident at peak" in out
    assert hist["run"].model.n_layers == 1
    assert 0 < hist["metrics"][-1]["expert_peak_resident_bytes"] < \
        hist["metrics"][-1]["expert_total_bytes"]
    assert np.isfinite(hist["losses"]).all()


def test_chip_smoke_moe_numerics_hold_two_cpu_runs_equal():
    """The card-against-CPU MoE check of ``chip_smoke.py`` on the smoke model
    with both sides on the CPU: the routing recorder sees the same plans,
    no expert is rerouted and every bound holds with nothing to spare."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = dataclasses.replace(tconfigs.smoke(ARCH), n_layers=2)
    for kind in ("gspmd", "layered"):
        rec = cs.phase_moe_numerics(kind, cfg=cfg, devices=("cpu", "cpu"))
        assert rec["routing_calls"] == 2 * cfg.n_layers
        assert rec["rerouted_experts"] == 0 and rec["params_max_abs_diff"] == 0.0
        assert rec["masters_max_abs_diff"] == 0.0


# ---------------------------------------------------------------------------
# the GSPMD step at every one-device placement
# ---------------------------------------------------------------------------

# placement -> (param tier, grad tier, opt tier, grad_accum, remat): the
# dense family's placements of tests/test_torch_gspmd.py
GSPMD_PLACEMENTS = {
    "all_device": ("device", "device", "device", 1, "none"),
    "opt_host": ("device", "device", "host", 1, "none"),
    "opt_nvme": ("device", "device", "nvme", 1, "none"),
    "grad_nvme": ("device", "nvme", "host", 1, "none"),
    "param_host": ("host", "device", "device", 1, "none"),
    "grad_accum_2": ("device", "device", "device", 2, "none"),
    "remat_full": ("device", "device", "device", 1, "full"),
}


@pytest.mark.parametrize("placement", list(GSPMD_PLACEMENTS))
def test_gspmd_moe_step_matches_the_reference_in_every_placement(placement, mesh, tmp_path):
    """The port's GSPMD step on the MoE smoke model against the reference's
    ``InfinityExecutor(engine="pjit")``, 2 steps from the same weights and
    batches: loss and grad norm by the cross-tier tolerance (rtol = atol =
    2e-3), the routing metrics (averaged over microbatches under
    grad_accum, as the reference's scan) within one assignment per layer,
    the params by the drift bound plus each side's bf16 rounding."""
    param, grad, opt, accum, remat = GSPMD_PLACEMENTS[placement]
    tiers = dict(param_tier=param, grad_tier=grad, opt_tier=opt)
    steps, bsz = 2, 4
    jrun = JRun(model=jconfigs.smoke(ARCH),
                parallel=jmake_parallel("pjit", remat=remat, grad_accum=accum),
                offload=jmake_offload(nvme_dir=str(tmp_path / "j"), **tiers),
                train=JTrain(lr=3e-3, warmup_steps=2))
    trun = RunConfig(model=tconfigs.smoke(ARCH),
                     parallel=make_parallel("pjit", remat=remat, grad_accum=accum),
                     offload=make_offload(nvme_dir=str(tmp_path / "t"), **tiers),
                     train=TrainConfig(lr=3e-3, warmup_steps=2))
    jex = jexec.InfinityExecutor(jrun, mesh)
    jstate = jex.init_state(jax.random.PRNGKey(0))
    tex = texec.InfinityExecutor(trun, "cpu")
    tstate = tex.reseed(tex.engine.adopt_params(
        bridge.params_from_numpy(jax.tree.map(np.asarray, jstate["params"]))))
    cfg = tconfigs.smoke(ARCH)
    stream = tpipe.SyntheticStream(treg.build(cfg).input_specs(
        ShapeConfig("t", S, bsz, "train")), cfg.vocab_size, seed=0)
    jstep, tstep = jex.make_train_step(), tex.make_train_step()
    one = 1.0 / (bsz // accum * S * cfg.top_k)
    lrs = []
    for i in range(steps):
        batch = stream.batch_at(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=2e-3, atol=2e-3,
                                       err_msg=key)
        np.testing.assert_allclose(float(tm["moe_dropped_token_fraction"]),
                                   float(jm["moe_dropped_token_fraction"]), atol=one + 1e-6)
        np.testing.assert_allclose(_np(tm["moe_expert_load"]),
                                   np.asarray(jm["moe_expert_load"]), atol=one + 1e-6)
        lrs.append(float(jm["lr"]))
    drift = tadam.parity_bound(trun.train, lrs)
    flat_t = texec.flatten_with_paths(tstate["params"])
    for path, jleaf in jax.tree_util.tree_flatten_with_path(jstate["params"])[0]:
        want = _np(jleaf)
        got = _np(flat_t[jax.tree_util.keystr(path)])
        diff = np.abs(got - want)
        assert (diff <= drift + 2**-8 * (np.abs(want) + np.abs(got))).all(), \
            (placement, jax.tree_util.keystr(path), diff.max())
    tex.close()
    jex.close()
