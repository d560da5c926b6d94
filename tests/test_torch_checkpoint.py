"""The port's checkpoint manager (``repro_torch/checkpoint/manager.py``)
against the reference's (``repro/checkpoint/manager.py``), on the CPU.

Mirrors ``tests/test_checkpoint.py`` (atomic commit, async save, gc,
bit-exact restore, a missing leaf raising ``KeyError``, and the five tier
migrations on the port's executor) and the corruption fallbacks of
``tests/test_fault_tolerance.py``; then holds the on-disk format byte for
byte against the reference in both directions (keys, file names, file
bytes, manifest md5s; bf16, f32 and int32 leaves; the GSPMD and the
explicit engine's in-graph states, a MoE layered run's rows with its
expert rows and f32 router), and shows that a leaf updated in place after
``save()`` returns does not reach the persisted bytes; a MoE layered run
resumes from its checkpoint.
"""
import dataclasses
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import manager as jman  # noqa: E402
from repro.config import RunConfig as JRun  # noqa: E402
from repro.config import make_offload as jmake_offload  # noqa: E402
from repro.config import make_parallel as jmake_parallel  # noqa: E402
from repro.core import executor as jexec  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import manager as tman  # noqa: E402
from repro_torch.checkpoint.manager import (CheckpointCorruptError,  # noqa: E402
                                            CheckpointManager)
from repro_torch.config import RunConfig, TrainConfig, make_offload, make_parallel  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core.executor import InfinityExecutor  # noqa: E402
from repro_torch.optim.adam import AdamState  # noqa: E402


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.randn((4,), generator=g)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    st = _state()
    mgr.save(7, st, {"next_step": 7, "cursor": 123}).result()
    restored, extra = mgr.restore(st)
    assert torch.equal(restored["params"]["w"], st["params"]["w"])
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 7
    assert extra == {"next_step": 7, "cursor": 123}
    assert mgr.latest_step() == 7


def test_gc_keeps_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s), {}).result()
    assert mgr.all_steps() == [3, 4]


def test_atomic_commit_ignores_partial(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, _state(), {}).result()
    os.makedirs(tmp_path / "step-00000009.tmp")  # a crash mid-save
    assert mgr.latest_step() == 5
    os.makedirs(tmp_path / "step-00000011")  # committed dir without manifest
    assert mgr.latest_step() == 5


def test_restore_missing_leaf_raises_key_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(3)}, {}).result()
    with pytest.raises(KeyError):
        mgr.restore({"a": torch.zeros(3), "b": torch.zeros(2)})


def test_async_save_persists_on_the_worker(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1, async_save=True)
    f = mgr.save(1, _state(), {})
    path = f.result()
    assert os.path.exists(os.path.join(path, "manifest.json"))
    assert mgr.last_bytes == 8 * 4 * 4 + 4 * 4 + 4 and mgr.last_persist_s > 0


def _ckpt_tree(v: float) -> dict:
    return {"w": torch.full((4, 4), v), "b": torch.arange(8, dtype=torch.float32) * v}


def _first_leaf(mgr, step):
    d = mgr._step_dir(step)
    return os.path.join(d, sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0])


def test_truncated_leaf_falls_back_to_the_newest_intact(tmp_path, capsys):
    mgr = CheckpointManager(str(tmp_path), keep=4, async_save=False)
    mgr.save(1, _ckpt_tree(1.0), {"next_step": 1})
    mgr.save(2, _ckpt_tree(2.0), {"next_step": 2})
    path = _first_leaf(mgr, 2)
    data = open(path, "rb").read()
    open(path, "wb").write(data[: len(data) // 2])  # a torn write
    tree, extra = mgr.restore(_ckpt_tree(0.0))
    assert extra["next_step"] == 1 and torch.equal(tree["w"], torch.full((4, 4), 1.0))
    assert "failed verification" in capsys.readouterr().out
    with pytest.raises(CheckpointCorruptError):  # an explicit step never lies
        mgr.restore(_ckpt_tree(0.0), step=2)


def test_bit_flip_falls_back_and_nothing_intact_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=4, async_save=False)
    mgr.save(1, _ckpt_tree(1.0), {"next_step": 1})
    mgr.save(2, _ckpt_tree(2.0), {"next_step": 2})
    path = _first_leaf(mgr, 2)
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0xFF  # same length, one payload byte flipped
    open(path, "wb").write(bytes(data))
    _, extra = mgr.restore(_ckpt_tree(0.0))
    assert extra["next_step"] == 1
    with open(os.path.join(mgr._step_dir(1), "manifest.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(CheckpointCorruptError, match="no intact"):
        mgr.restore(_ckpt_tree(0.0))


def test_leaf_updated_in_place_after_save_does_not_reach_the_disk(tmp_path, monkeypatch):
    """``save()`` copies every leaf on the caller's thread: the worker is
    held until the caller has overwritten the leaf in place (as the next
    step overwrites a pinned host-tier leaf), and the checkpoint still
    holds the values at ``save()``."""
    gate = threading.Event()
    real = CheckpointManager._persist

    def held(self, *a):
        gate.wait(10)
        return real(self, *a)

    monkeypatch.setattr(CheckpointManager, "_persist", held)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    leaf = torch.arange(1000, dtype=torch.float32).to(torch.bfloat16)
    want = leaf.clone()
    fut = mgr.save(1, {"flat": leaf}, {})
    leaf.fill_(-1.0)  # the next step's in-place write
    gate.set()
    fut.result()
    got, _ = mgr.restore({"flat": leaf})
    assert torch.equal(got["flat"], want)


# ---------------------------------------------------------------------------
# the on-disk format against the reference, both directions
# ---------------------------------------------------------------------------


def _mixed_numpy(seed=0):
    """bf16, f32 and int32 leaves, nested dicts and an AdamState-shaped
    tuple, as numpy (the reference side) — the key spellings of both
    engines' states."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    w = rng.standard_normal((5, 3)).astype(np.float32)
    return {"flat": rng.standard_normal((2, 7)).astype(ml_dtypes.bfloat16),
            "other": {"embed": {"tok": w.astype(ml_dtypes.bfloat16)}},
            "other_opt": (np.int32(3), {"embed": {"tok": w}}, {"embed": {"tok": w * 0.1}},
                          {"embed": {"tok": w * w}}),
            "step": np.asarray(3, np.int32)}


def _as_jax(tree):
    import repro.optim.adam as jadam

    out = {k: jax.tree.map(jnp.asarray, v) for k, v in tree.items() if k != "other_opt"}
    out["other_opt"] = jadam.AdamState(*(jax.tree.map(jnp.asarray, t)
                                         for t in tree["other_opt"]))
    return out


def _as_torch(tree):
    return bridge.zero3_state_from_numpy(tree)


def _same_files(a: str, b: str) -> None:
    ma = json.load(open(os.path.join(a, "manifest.json")))
    mb = json.load(open(os.path.join(b, "manifest.json")))
    assert list(ma["leaves"]) == list(mb["leaves"])
    for key, la in ma["leaves"].items():
        lb = mb["leaves"][key]
        assert la == lb, key  # file, shape, dtype, bytes, md5
        assert open(os.path.join(a, la["file"]), "rb").read() == \
            open(os.path.join(b, lb["file"]), "rb").read(), key
    assert ma["step"] == mb["step"] and ma["extra"] == mb["extra"]


def test_both_packages_write_the_same_bytes(tmp_path):
    tree = _mixed_numpy()
    jman.CheckpointManager(str(tmp_path / "j"), async_save=False).save(
        3, _as_jax(tree), {"next_step": 3})
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(
        3, _as_torch(tree), {"next_step": 3})
    _same_files(str(tmp_path / "j" / "step-00000003"), str(tmp_path / "t" / "step-00000003"))
    keys = list(json.load(open(tmp_path / "t" / "step-00000003" / "manifest.json"))["leaves"])
    assert "other_opt/master/embed/tok" in keys and "other_opt/step" in keys
    assert "flat" in keys


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_port_restores_a_reference_checkpoint_bit_for_bit(tmp_path):
    tree = _mixed_numpy(1)
    jman.CheckpointManager(str(tmp_path)).save(5, _as_jax(tree), {"next_step": 5}).result()
    like = _as_torch(_mixed_numpy(2))
    got, extra = CheckpointManager(str(tmp_path)).restore(like)
    assert extra == {"next_step": 5} and isinstance(got["other_opt"], AdamState)
    want = tman.flatten_with_keys(_as_torch(tree))
    for key, leaf in tman.flatten_with_keys(got).items():
        assert leaf.dtype == want[key].dtype and leaf.shape == want[key].shape, key
        assert torch.equal(_bits(leaf), _bits(want[key])), key


def test_reference_restores_a_port_checkpoint_bit_for_bit(tmp_path):
    tree = _mixed_numpy(3)
    CheckpointManager(str(tmp_path)).save(4, _as_torch(tree), {"next_step": 4}).result()
    got, extra = jman.CheckpointManager(str(tmp_path)).restore(_as_jax(_mixed_numpy(4)))
    assert extra == {"next_step": 4}
    jgot = jman._flatten_with_keys(got)
    for key, want in jman._flatten_with_keys(_as_jax(tree)).items():
        want = np.asarray(want)
        assert jgot[key].dtype == want.dtype and jgot[key].shape == want.shape, key
        assert jgot[key].tobytes() == want.tobytes(), key


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh(1, 1)


@pytest.mark.parametrize("engine", ["pjit", "zero3"])
def test_in_graph_engine_states_cross_read_in_both_directions(tmp_path, mesh, engine):
    """Each engine's in-graph state (the GSPMD ``params``/``opt``; the
    explicit ``flat``/``master``/``m``/``v``/``other``/``other_opt``/
    ``step``), as the reference's engine draws it: the same files from
    both packages, and each restores the other's bit for bit."""
    jcfg = dataclasses.replace(jconfigs.smoke("smollm-135m"), n_layers=2)
    jeng = jexec.make_engine(JRun(model=jcfg, parallel=jmake_parallel(engine),
                                  offload=jmake_offload()), mesh)
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jstate)
    if engine == "zero3":
        tstate = bridge.zero3_state_from_numpy(init)
    else:
        p = bridge.params_from_numpy(init["params"])
        step, master, m, v = init["opt"]
        tstate = {"params": p, "opt": AdamState(bridge.tensor_from_numpy(step),
                                                bridge.params_from_numpy(master),
                                                bridge.params_from_numpy(m),
                                                bridge.params_from_numpy(v))}
    jman.CheckpointManager(str(tmp_path / "j"), async_save=False).save(1, jstate, {"next_step": 1})
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(1, tstate, {"next_step": 1})
    _same_files(str(tmp_path / "j" / "step-00000001"), str(tmp_path / "t" / "step-00000001"))
    got, _ = CheckpointManager(str(tmp_path / "j")).restore(tstate)
    for key, leaf in tman.flatten_with_keys(got).items():
        assert torch.equal(_bits(leaf), _bits(tman.flatten_with_keys(tstate)[key])), key
    jgot, _ = jman.CheckpointManager(str(tmp_path / "t")).restore(jstate)
    for key, want in jman._flatten_with_keys(jstate).items():
        assert jman._flatten_with_keys(jgot)[key].tobytes() == np.asarray(want).tobytes(), key


# ---------------------------------------------------------------------------
# tier migration through the portable view, on the port's executor
# ---------------------------------------------------------------------------

# the reference's MIGRATIONS (tests/test_checkpoint.py), and the GSPMD
# engine with every state class on NVMe (its leaves materialized from the
# param store) to the device and back
MIGRATIONS = [
    ("zero3", ("device", "device", "device"), ("nvme", "nvme", "nvme")),
    ("zero3", ("nvme", "nvme", "nvme"), ("device", "device", "device")),
    ("zero3", ("device", "device", "host"), ("device", "device", "nvme")),
    ("pjit", ("device", "device", "device"), ("device", "nvme", "nvme")),
    ("pjit", ("device", "device", "nvme"), ("device", "device", "device")),
    ("pjit", ("nvme", "nvme", "nvme"), ("device", "device", "device")),
    ("pjit", ("device", "device", "device"), ("nvme", "nvme", "nvme")),
]


def _batch(cfg):
    g = torch.Generator().manual_seed(1)
    t = torch.randint(0, cfg.vocab_size, (2, 16), generator=g, dtype=torch.int32)
    return {"tokens": t, "labels": t}


def _executor(engine, tiers, nvme_dir):
    cfg = dataclasses.replace(tconfigs.smoke("smollm-135m"), n_layers=2)
    param, grad, opt = tiers
    run = RunConfig(model=cfg, parallel=make_parallel(engine, remat="none"),
                    offload=make_offload(opt_tier=opt, param_tier=param, grad_tier=grad,
                                         nvme_dir=str(nvme_dir)),
                    train=TrainConfig(lr=3e-3, warmup_steps=2))
    return InfinityExecutor(run, "cpu")


def _leaves(tree) -> dict:
    return tman.flatten_with_keys(tree)


@pytest.mark.parametrize("engine,src,dst", MIGRATIONS)
def test_checkpoint_restores_across_tiers(tmp_path, engine, src, dst):
    """Save the portable view under ``src``, restore it into an executor at
    ``dst``: the portable leaves round-trip bit for bit, the moments
    restart at zero, and the destination trains."""
    ex_src = _executor(engine, src, tmp_path / "src")
    state = ex_src.init_state(torch.Generator().manual_seed(0))
    step = ex_src.make_train_step()
    batch = _batch(ex_src.run.model)
    for _ in range(2):
        state, _ = step(state, batch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=1)
    mgr.save(2, ex_src.portable_state(state), {"next_step": 2}).result()
    src_leaves = _leaves(ex_src.portable_state(state))

    ex_dst = _executor(engine, dst, tmp_path / "dst")
    init = ex_dst.init_state(torch.Generator().manual_seed(3))
    restored, extra = mgr.restore(ex_dst.portable_state(init))
    new_state = ex_dst.adopt_state(restored, step=extra["next_step"])
    dst_leaves = _leaves(ex_dst.portable_state(new_state))
    assert list(src_leaves) == list(dst_leaves)
    for key in src_leaves:
        assert torch.equal(src_leaves[key], dst_leaves[key]), key
    if "m" in new_state:
        assert not new_state["m"].any() and not new_state["v"].any()
    if "opt" in new_state:
        assert int(new_state["opt"].step) == 2
        assert not any(t.any() for t in tpt.tree_leaves(new_state["opt"].m))
    _, metrics = ex_dst.make_train_step()(new_state, batch)
    assert np.isfinite(float(metrics["loss"]))
    ex_src.close()
    ex_dst.close()


def test_adopted_state_trains_identically_across_destinations(tmp_path):
    """One checkpoint adopted at two tiers continues on the same losses
    (within the streamed Adam's rounding): the tier never leaks into the
    numbers after a migration."""
    ex_src = _executor("zero3", ("device", "device", "device"), tmp_path / "s")
    state = ex_src.init_state(torch.Generator().manual_seed(0))
    batch = _batch(ex_src.run.model)
    state, _ = ex_src.make_train_step()(state, batch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=1)
    mgr.save(1, ex_src.portable_state(state), {"next_step": 1}).result()
    trajs = {}
    for name, tiers in [("device", ("device", "device", "device")),
                        ("nvme", ("nvme", "nvme", "nvme"))]:
        ex = _executor("zero3", tiers, tmp_path / f"d_{name}")
        restored, extra = mgr.restore(ex.portable_state(
            ex.init_state(torch.Generator().manual_seed(9))))
        st = ex.adopt_state(restored, step=extra["next_step"])
        fn = ex.make_train_step()
        traj = []
        for _ in range(2):
            st, m = fn(st, batch)
            traj.append(float(m["loss"]))
        trajs[name] = np.asarray(traj)
        ex.close()
    np.testing.assert_allclose(trajs["nvme"], trajs["device"], rtol=2e-3, atol=2e-3)


def test_checkpoint_state_materializes_the_layered_rows(tmp_path):
    ex = _executor("zero3", ("nvme", "nvme", "nvme"), tmp_path)
    state = ex.init_state(torch.Generator().manual_seed(0))
    assert not isinstance(state["flat"], torch.Tensor)
    full = ex.checkpoint_state(state)
    assert torch.equal(full["flat"], ex.materialize_flat())
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    mgr.save(1, full, {"next_step": 1})
    got, _ = mgr.restore(state)  # a placeholder leaf restores by its key
    assert torch.equal(got["flat"], full["flat"])
    ex.close()


# ---------------------------------------------------------------------------
# a MoE layered run: the expert rows (``eflat``) and the f32 router
# ---------------------------------------------------------------------------

MOE = "granite-moe-1b-a400m"


def _moe_runs(tmp_path):
    jrun = JRun(model=jconfigs.smoke(MOE), parallel=jmake_parallel("zero3", remat="none"),
                offload=jmake_offload(param_tier="nvme", grad_tier="nvme", opt_tier="nvme",
                                      nvme_dir=str(tmp_path / "jnv")))
    trun = RunConfig(model=tconfigs.smoke(MOE), parallel=make_parallel("zero3", remat="none"),
                     offload=make_offload(param_tier="nvme", grad_tier="nvme",
                                          opt_tier="nvme", nvme_dir=str(tmp_path / "tnv")))
    return jrun, trun


def test_moe_layered_checkpoint_holds_the_reference_files_byte_for_byte(tmp_path, mesh):
    """The layered MoE state as each executor checkpoints it (the dense and
    expert rows materialized from its param store, the f32 router among
    the 'other' leaves): the same files from both packages, and each
    restores the other's bit for bit."""
    jrun, trun = _moe_runs(tmp_path)
    jex = jexec.InfinityExecutor(jrun, mesh)
    jstate = jex.reseed(jex.engine.init_state(jax.random.PRNGKey(0)))
    tex = InfinityExecutor(trun, "cpu")
    init = jax.tree.map(np.asarray, jex.checkpoint_state(jstate))
    tstate = tex.reseed(tex.engine.place_state(bridge.zero3_state_from_numpy(init)))
    jfull, tfull = jex.checkpoint_state(jstate), tex.checkpoint_state(tstate)
    keys = list(tman.flatten_with_keys(tfull))
    assert "eflat" in keys and "other/router" in keys and "other_opt/m/router" in keys
    jman.CheckpointManager(str(tmp_path / "j"), async_save=False).save(1, jfull, {"next_step": 1})
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(1, tfull, {"next_step": 1})
    _same_files(str(tmp_path / "j" / "step-00000001"), str(tmp_path / "t" / "step-00000001"))
    got, _ = CheckpointManager(str(tmp_path / "j")).restore(tstate)  # placeholders by key
    for key, leaf in tman.flatten_with_keys(got).items():
        assert torch.equal(_bits(leaf), _bits(tman.flatten_with_keys(tfull)[key])), key
    jgot, _ = jman.CheckpointManager(str(tmp_path / "t")).restore(jfull)
    for key, want in jman._flatten_with_keys(jfull).items():
        assert jman._flatten_with_keys(jgot)[key].tobytes() == np.asarray(want).tobytes(), key
    # the port's executor takes the reference's checkpoint back into its stores
    back = tex.restore_state(got, step=1)
    assert torch.equal(tex.materialize_rows()["eflat"], tfull["eflat"])
    assert not isinstance(back["eflat"], torch.Tensor)
    jex.close()
    tex.close()


def test_moe_layered_run_resumes_from_its_checkpoint(tmp_path, monkeypatch, capsys):
    """``--resume auto`` on the MoE layered epoch: a failure at step 3
    restarts from the step-2 checkpoint (rows, router and 'other' states
    restored bit for bit, the streamed moments at zero), so the redone
    step 2 repeats the uninterrupted run's loss to the bit and the run
    trains on."""
    from repro_torch.launch import train as ttrain

    argv = ["--arch", MOE, "--smoke", "--device", "cpu", "--engine", "zero3",
            "--offload-param", "nvme", "--offload-grad", "nvme", "--offload-opt", "nvme",
            "--steps", "5", "--batch", "2", "--seq", "16", "--lr", "3e-3", "--log-every", "1"]

    def run(extra, fail_at=None):
        monkeypatch.delenv("REPRO_FAIL_AT_STEP", raising=False)
        if fail_at is not None:
            monkeypatch.setenv("REPRO_FAIL_AT_STEP", str(fail_at))
            monkeypatch.setenv("REPRO_FAIL_MARKER", str(tmp_path / "marker"))
        a = argv + extra
        return ttrain.train(ttrain.build_argparser().parse_args(a), a)

    ref = run(["--ckpt-every", "0", "--nvme-dir", str(tmp_path / "rnv"),
               "--ckpt-dir", str(tmp_path / "rck")])
    hist = run(["--ckpt-every", "2", "--resume", "auto", "--nvme-dir", str(tmp_path / "nv"),
                "--ckpt-dir", str(tmp_path / "ck")], fail_at=3)
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 2" in out and hist["restarts"] == 1
    assert [m["step"] for m in hist["metrics"]] == [0, 1, 2, 2, 3, 4]
    assert hist["losses"][:3] == ref["losses"][:3]
    assert hist["losses"][3] == ref["losses"][2]
    assert np.isfinite(hist["losses"]).all()
    for m in hist["metrics"]:
        assert 0 < m["expert_peak_resident_bytes"] < m["expert_total_bytes"]
        assert len(m["moe_expert_load"]) == tconfigs.smoke(MOE).n_experts
