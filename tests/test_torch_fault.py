"""The port's fault runtime (``repro_torch/runtime/fault.py``, ``elastic.
wire_straggler``, ``metrics.elastic_step_metrics``) against the
reference's, and restart drills through ``repro_torch.launch.train`` on the
CPU.

Mirrors ``tests/test_fault_tolerance.py:28-118`` (injector, retry loop,
recovery budget, live stats, straggler detection and its wiring). The
drills inject a failure (``REPRO_FAIL_AT_STEP`` with a marker, so only the
first incarnation fails), checkpoint every 2 steps and resume with
``--resume auto``:

* in-graph (the explicit engine's f32 master/m/v in the checkpoint): the
  resumed steps repeat the uninterrupted run's losses bit for bit (the
  restore is bit-exact and the CPU's plain versions are deterministic);
* off-graph (the optimizer on NVMe): the checkpoint holds no moments, so
  the resume restarts them at zero, as the reference's does; the port's
  run is held against the reference CLI's resumed run from the same
  initial state (the reference engine's, carried over by the bridge), to
  the cross-package tolerance of ``tests/test_torch_zero3_step.py``
  (rtol = atol = 2e-3);
* a checkpoint without the in-graph optimizer resumed by an in-graph run
  takes the tier-migration path (``KeyError`` -> ``portable_state`` /
  ``adopt_state``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import executor as jexec  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.runtime import fault as jfault  # noqa: E402
from repro.runtime import metrics as jmetrics  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402
from repro_torch.runtime.elastic import wire_straggler  # noqa: E402
from repro_torch.runtime.fault import (FailureInjector,  # noqa: E402
                                       RecoveryBudgetExceeded,
                                       SimulatedFailure, StragglerMonitor,
                                       retry_loop)
from repro_torch.runtime.metrics import elastic_step_metrics  # noqa: E402

TIER_TOL = dict(rtol=2e-3, atol=2e-3)


def test_failure_injector_env(tmp_path, monkeypatch):
    marker = tmp_path / "marker"
    monkeypatch.setenv("REPRO_FAIL_AT_STEP", "3")
    monkeypatch.setenv("REPRO_FAIL_MARKER", str(marker))
    inj = FailureInjector()
    inj.maybe_fail(2)
    with pytest.raises(SimulatedFailure):
        inj.maybe_fail(3)
    FailureInjector().maybe_fail(3)  # second incarnation: the marker exists


def test_retry_loop_restarts():
    calls = []

    def run_once():
        calls.append(1)
        if len(calls) < 3:
            raise SimulatedFailure("boom")

    assert retry_loop(run_once, max_restarts=5, backoff_s=0.0) == 2
    assert len(calls) == 3


def test_retry_loop_gives_up_past_max_restarts():
    def always_fail():
        raise SimulatedFailure("down")

    with pytest.raises(SimulatedFailure):
        retry_loop(always_fail, max_restarts=2, backoff_s=0.0)


def test_retry_loop_recovery_budget():
    def always_fail():
        raise SimulatedFailure("link down")

    with pytest.raises(RecoveryBudgetExceeded):
        retry_loop(always_fail, max_restarts=1000, backoff_s=0.01,
                   recovery_budget_s=0.05)


def test_retry_loop_surfaces_stats():
    stats, calls = {}, []

    def run_once():
        calls.append(1)
        if len(calls) < 3:
            raise SimulatedFailure("boom")

    restarts = retry_loop(run_once, max_restarts=5, backoff_s=0.001, jitter=0.5,
                          seed=7, stats=stats, recovery_budget_s=30.0)
    assert restarts == 2 and stats["restarts"] == 2 and stats["recovery_s"] > 0.0


def test_retry_loop_backoff_is_the_reference_sequence(monkeypatch):
    """The seeded jitter draws the reference's delays, one for one."""
    def delays(mod):
        slept = []
        monkeypatch.setattr(mod.time, "sleep", slept.append)
        n = [0]

        def run_once():
            n[0] += 1
            if n[0] < 5:
                raise mod.SimulatedFailure("x")

        mod.retry_loop(run_once, max_restarts=9, backoff_s=0.1, jitter=0.25, seed=3)
        return slept

    from repro_torch.runtime import fault as tfault

    assert delays(tfault) == delays(jfault) and len(delays(tfault)) == 4


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(factor=3.0, warmup=5)
    events = []
    mon.on_straggler = lambda step, dt, base: events.append(step)
    for s in range(10):
        mon.observe(s, 0.1)
    mon.observe(10, 0.9)  # 9x the median
    mon.observe(11, 0.11)
    assert mon.flagged == [10] and events == [10]


def test_straggler_step_metrics():
    mon = StragglerMonitor(factor=3.0, warmup=5)
    for s in range(8):
        mon.observe(s, 0.1)
    assert mon.step_metrics() == {"straggler_flagged": 0, "straggler_slowdown": 1.0}
    mon.observe(8, 0.9)
    m = mon.step_metrics()
    assert m["straggler_flagged"] == 1
    assert m["straggler_slowdown"] == pytest.approx(9.0, abs=0.01)


def test_wire_straggler_logs_and_traces():
    trace.enable()
    trace.clear()
    try:
        logs = []
        mon = wire_straggler(StragglerMonitor(factor=3.0, warmup=5), log=logs.append)
        for s in range(8):
            mon.observe(s, 0.05)
        mon.observe(8, 0.5)
        assert logs and "straggler" in logs[0]
        ours = [ev for ev in trace.TRACER.events() if ev[0] == "straggler"]
        assert ours and ours[0][1] == "elastic"
    finally:
        trace.disable()
        trace.clear()


@pytest.mark.parametrize("kw", [{}, {"restarts": 2, "recovery_s": 1.23456, "n_alive": 1}])
def test_elastic_step_metrics_match_reference(kw):
    assert elastic_step_metrics(**kw) == jmetrics.elastic_step_metrics(**kw)


# ---------------------------------------------------------------------------
# restart drills through the training CLI
# ---------------------------------------------------------------------------

SMOKE = ["--smoke", "--device", "cpu", "--engine", "zero3", "--steps", "5",
         "--batch", "2", "--seq", "16", "--lr", "3e-3", "--log-every", "1"]


def _run(argv, tmp_path, monkeypatch, fail_at=None, init_state=None):
    monkeypatch.delenv("REPRO_FAIL_AT_STEP", raising=False)
    monkeypatch.delenv("REPRO_FAIL_MARKER", raising=False)
    if fail_at is not None:
        monkeypatch.setenv("REPRO_FAIL_AT_STEP", str(fail_at))
        monkeypatch.setenv("REPRO_FAIL_MARKER", str(tmp_path / "marker"))
    return ttrain.train(ttrain.build_argparser().parse_args(argv), argv,
                        init_state=init_state)


def test_in_graph_restart_drill_repeats_the_uninterrupted_losses(tmp_path, monkeypatch,
                                                                 capsys):
    ref = _run(SMOKE + ["--ckpt-every", "0", "--ckpt-dir", str(tmp_path / "ref")],
               tmp_path, monkeypatch)
    argv = SMOKE + ["--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ck"),
                    "--resume", "auto"]
    hist = _run(argv, tmp_path, monkeypatch, fail_at=3)
    out = capsys.readouterr().out
    assert "restart #1 after: injected failure at step 3" in out
    assert "resumed from checkpoint at step 2" in out
    assert hist["restarts"] == 1 and hist["recovery_s"] > 0
    # steps 0-2, then 2-4 again from the step-2 checkpoint
    assert [m["step"] for m in hist["metrics"]] == [0, 1, 2, 2, 3, 4]
    assert hist["losses"][3:] == ref["losses"][2:]
    assert hist["metrics"][-1]["loss"] == ref["metrics"][-1]["loss"]
    for key in ("flat", "master", "m", "v"):
        assert torch.equal(hist["final_state"][key], ref["final_state"][key]), key


def test_cli_main_prints_the_drill_and_its_restarts(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_FAIL_AT_STEP", "1")
    monkeypatch.setenv("REPRO_FAIL_MARKER", str(tmp_path / "m"))
    hist = ttrain.main(SMOKE + ["--steps", "3", "--ckpt-every", "1", "--resume", "auto",
                                "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 1" in out
    assert f"last loss {hist['losses'][-1]:.4f} | restarts 1" in out


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh(1, 1)


def _reference_init(mesh, argv):
    """The reference engine's initial state for ``argv``'s placement, as
    the reference CLI draws it (``PRNGKey(seed)``), as numpy."""
    args = jtrain.build_argparser().parse_args(argv)
    run, _ = jtrain.make_run(args)
    eng = jexec.make_engine(run, mesh)
    return jax.tree.map(np.asarray, eng.init_state(jax.random.PRNGKey(args.seed)))


def test_off_graph_resume_matches_the_reference_cli(tmp_path, monkeypatch, mesh):
    """The optimizer on NVMe: the resume restarts the moments at zero in
    both packages, so the port's resumed run follows the reference CLI's
    resumed run (not an uninterrupted one)."""
    common = ["--arch", "smollm-135m", "--smoke", "--engine", "zero3", "--steps", "5",
              "--batch", "2", "--seq", "16", "--lr", "3e-3", "--log-every", "100",
              "--offload-opt", "nvme"]
    drill = ["--ckpt-every", "2", "--resume", "auto"]
    jargv = common + drill + ["--nvme-dir", str(tmp_path / "jnv"),
                              "--ckpt-dir", str(tmp_path / "jck")]
    targv = common + drill + ["--device", "cpu", "--nvme-dir", str(tmp_path / "tnv"),
                              "--ckpt-dir", str(tmp_path / "tck")]
    init = _reference_init(mesh, jargv)
    start = lambda: bridge.zero3_state_from_numpy(init)  # noqa: E731
    monkeypatch.setenv("REPRO_FAIL_AT_STEP", "3")
    monkeypatch.setenv("REPRO_FAIL_MARKER", str(tmp_path / "jmark"))
    jhist = jtrain.train(jtrain.build_argparser().parse_args(jargv))
    monkeypatch.setenv("REPRO_FAIL_MARKER", str(tmp_path / "tmark"))
    thist = ttrain.train(ttrain.build_argparser().parse_args(targv), targv, init_state=start)
    assert thist["restarts"] == jhist["restarts"] == 1
    assert len(thist["losses"]) == len(jhist["losses"]) == 3 + 3
    np.testing.assert_allclose(thist["losses"], jhist["losses"], **TIER_TOL)
    # and the resumed run is not the uninterrupted one: its moments restarted
    unbroken = _run(common + ["--device", "cpu", "--ckpt-every", "0",
                              "--nvme-dir", str(tmp_path / "unv"),
                              "--ckpt-dir", str(tmp_path / "u")],
                    tmp_path, monkeypatch, init_state=start)
    assert thist["losses"][-1] != unbroken["losses"][-1]


def test_resume_into_an_in_graph_run_migrates_an_off_graph_checkpoint(tmp_path, monkeypatch,
                                                                      capsys):
    """An off-graph checkpoint has no ``master``/``m``/``v``: an in-graph
    resume meets the ``KeyError`` and adopts the portable leaves (f32
    master from the flat, zero moments), then trains on."""
    base = SMOKE + ["--ckpt-dir", str(tmp_path / "ck"), "--nvme-dir", str(tmp_path / "nv")]
    _run(base + ["--offload-opt", "nvme", "--steps", "2", "--ckpt-every", "2"],
         tmp_path, monkeypatch)
    hist = _run(base + ["--steps", "4", "--ckpt-every", "0", "--resume", "auto"],
                tmp_path, monkeypatch)
    assert "resumed from checkpoint at step 2" in capsys.readouterr().out
    assert [m["step"] for m in hist["metrics"]] == [2, 3]
    st = hist["final_state"]
    assert int(st["step"]) == 4 and st["m"].abs().sum() > 0
    assert np.isfinite(hist["losses"]).all()
