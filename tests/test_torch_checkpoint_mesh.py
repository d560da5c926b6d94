"""Checkpoints on ranks: the port's ranks (``torch.distributed``, gloo, on
the CPU) save, resume and re-shard the reference's checkpoint format,
against the JAX package's ``InfinityExecutor`` and ``launch.train`` on a
mesh of host devices.

The module's fixture saves the initial states (the reference's draws at
one device, as the port's tensors), then runs two phases, each the
reference (``tests/torch_dp_reference.py ckpt_mesh`` / ``ckpt_restore``,
one subprocess with four host devices) beside the port's ranks
(``tests/torch_dp_worker.py ckpt_mesh`` / ``ckpt_restore``, 2 and 4 ranks):

1. every case of ``torch_dp_worker.CKPT_CASES`` checkpoints its initial
   state on both sides (the GSPMD engine at (2, 1) and (1, 2), params on
   the device and on NVMe; the explicit engine at dp 2 with the int8
   residual, its layered epoch at dp 2, and at dp 4 with d_model 47, its
   rows padded); both sides' CLIs train 3 steps on (2, 1) with a
   checkpoint at step 2; the ranks run the restart drill (a checkpoint
   every step, a failure at step 2) beside the uninterrupted run;
2. the reference resumes the ranks' CLI checkpoint and the ranks the
   reference's, one step each; the ranks re-shard the case checkpoints
   onto other meshes (and the test process onto one rank) by restoring
   each and checkpointing it again at once; the ranks resume past a
   corrupt newest checkpoint, and resume an off-graph checkpoint into an
   in-graph run (a tier migration).

Held: the ranks' checkpoint files are the reference's for the same state
(keys, file names, shapes, dtypes, bytes, md5 and the files' bytes; not
the manifest's time); a resumed step agrees with the other side's
uninterrupted one by ``TIER_TOL``; the drill restarts once on every rank
and redoes its steps bit for bit; a re-shard is lossless (the GSPMD
engine's files identical, the explicit engine's rows equal up to their
zero pad, its int8 residual zero at another dp); the fallback and the
migration on ranks; ``params_from_state`` at dp 2 is dp 1's; ``--elastic``
and ``--chaos`` still raise, naming the supervisor's item.
"""
import concurrent.futures
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_dp_worker as W  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.config import RunConfig as JRun  # noqa: E402
from repro.config import make_parallel as jmake_parallel  # noqa: E402
from repro.core import executor as jexec  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.runtime.fault import FailureInjector, SimulatedFailure  # noqa: E402
from test_torch_gspmd import TIER_TOL  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = list(W.CKPT_CASES)
TIMEOUT = 300.0
ROW_KEYS = ("flat", "master", "m", "v")


def _save_inits(tmp: str) -> None:
    """The GSPMD cases' whole params (the reference bundle's init at one
    device) and each explicit case's tier-independent leaves (the
    reference engine's draw at one device, its rows padded with zeros for
    the case's dp, as the reference pads them)."""
    for case in CASES:
        engine, dp = W.CKPT_CASES[case][:2]
        cfg = W.ckpt_cfg(case, jconfigs)
        if engine == "pjit":
            params = jax.jit(jreg.build(cfg).init)(jax.random.PRNGKey(0))
            state = bridge.params_from_numpy(jax.tree.map(np.asarray, params))
        else:
            eng = jexec.make_engine(JRun(model=cfg, parallel=jmake_parallel("zero3")),
                                    make_local_mesh(1, 1))
            init = jax.tree.map(np.asarray, eng.init_state(jax.random.PRNGKey(0)))
            state = bridge.zero3_state_from_numpy(
                {k: init[k] for k in ("flat", "other", "other_opt", "step")})
            state["flat"] = torch.nn.functional.pad(state["flat"],
                                                    (0, (-state["flat"].shape[1]) % dp))
        torch.save(state, W.ckpt_init_path(tmp, case))


def _phase(tmp: str, job: str, in_process=None):
    """The reference's ``job`` and the port's ranks' (2 and 4), together;
    ``in_process`` runs in the test process meanwhile."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    path = os.path.join(tmp, f"ref_{job}.npz")
    ref = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dp_reference.py"),
                            tmp, path, job], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = {world: pool.submit(W.spawn, job, world, tmp, TIMEOUT) for world in (2, 4)}
            mine = in_process() if in_process else None
            out = {world: f.result() for world, f in runs.items()}
        log, _ = ref.communicate(timeout=TIMEOUT)
    except BaseException:
        ref.kill()
        ref.communicate()
        raise
    assert ref.returncode == 0, log[-4000:]
    return dict(np.load(path)), out, mine


def _corrupt_newest(path: str) -> int:
    """Flip a byte in the newest checkpoint's first leaf; its step."""
    step = max(int(n.split("-")[1]) for n in os.listdir(path) if n.startswith("step-"))
    d = os.path.join(path, f"step-{step:08d}")
    leaf = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
    with open(os.path.join(d, leaf), "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    return step


@pytest.fixture(scope="module")
def ck(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ckpt_mesh"))
    _save_inits(tmp)
    ref1, ranks1, _ = _phase(tmp, "ckpt_mesh")
    cli = os.path.join(tmp, "cli")
    shutil.copytree(os.path.join(cli, "jax"), os.path.join(cli, "jax_into_torch"))
    shutil.copytree(os.path.join(cli, "torch"), os.path.join(cli, "torch_into_jax"))
    shutil.copytree(os.path.join(cli, "drill"), os.path.join(cli, "fallback"))
    corrupt = _corrupt_newest(os.path.join(cli, "fallback"))
    shutil.copytree(W.ckpt_path(tmp, "g_nvme_2x1", "torch"), os.path.join(cli, "migration"))

    def one_rank():
        mesh = mesh_mod.make_local_mesh(1, 1, "cpu")
        return {f"{case}/1x1": W.reshard(case, tmp, mesh)
                for case, D, M in W.RESHARDS if D * M == 1}

    ref2, ranks2, _ = _phase(tmp, "ckpt_restore", one_rank)
    yield types.SimpleNamespace(tmp=tmp, ref={**ref1, **ref2}, one=ranks1, two=ranks2,
                                corrupt=corrupt)


def _manifest(path: str) -> dict:
    with open(os.path.join(path, "step-00000000", "manifest.json")) as f:
        return json.load(f)


def _files_equal(a: str, b: str) -> None:
    ma, mb = _manifest(a), _manifest(b)
    assert sorted(ma["leaves"]) == sorted(mb["leaves"])
    for key, la in ma["leaves"].items():
        assert la == mb["leaves"][key], key  # file, shape, dtype, bytes, md5
        with open(os.path.join(a, "step-00000000", la["file"]), "rb") as fa, \
                open(os.path.join(b, "step-00000000", la["file"]), "rb") as fb:
            assert fa.read() == fb.read(), key
    assert (ma["step"], ma["extra"]) == (mb["step"], mb["extra"])


@pytest.mark.parametrize("case", CASES)
def test_rank_checkpoints_hold_the_references_files(ck, case):
    """From the same initial state, rank 0 writes the files the
    reference's checkpoint of that state on its mesh holds: the global
    leaves under the same keys, shapes and dtypes, byte for byte (the
    GSPMD leaves gathered over both axes, params on NVMe read from the
    ranks' stores; the explicit rows gathered, their pad included, the
    int8 residual as the reference's (dp, ...) stack)."""
    _, D, M = W.CKPT_CASES[case][:3]
    assert ck.one[D * M][0][case]["saved"]
    assert not any(r[case]["saved"] for r in ck.one[D * M][1:])  # rank 0 alone writes
    _files_equal(W.ckpt_path(ck.tmp, case, "jax"), W.ckpt_path(ck.tmp, case, "torch"))
    keys = _manifest(W.ckpt_path(ck.tmp, case, "torch"))["leaves"]
    if case == "z_int8_dp2":
        assert keys["g_err/ln_f/scale"]["shape"][0] == 2
    if case == "z_dp4":
        assert keys["flat"]["shape"][1] == 24_160


def test_each_side_resumes_the_others_two_rank_checkpoint(ck):
    """The ranks resume the reference's CLI checkpoint at step 2 and its
    one step agrees with the reference's uninterrupted step 2; the
    reference resumes the ranks' and agrees with theirs (``TIER_TOL``)."""
    ranks, unbroken = ck.two[2], ck.one[2][0]["cli"]
    for r in ranks:
        assert r["cross"]["steps"] == [2]
        np.testing.assert_allclose(r["cross"]["losses"][0], ck.ref["cli/jax/losses"][2],
                                   **TIER_TOL)
    got = ck.ref["cli/torch_into_jax/losses"]
    assert len(got) == 1
    np.testing.assert_allclose(got[0], unbroken["losses"][2], **TIER_TOL)


def test_restart_drill_on_ranks_restarts_every_rank_and_redoes_steps_bit_for_bit(ck):
    """A failure injected at step 2 (a checkpoint after every step): each
    rank fails under its own marker (``<marker>.rank<r>``), every rank
    restarts once, resumes the checkpoint at step 2 and redoes steps 2-3
    with the uninterrupted run's losses bit for bit."""
    for rank, r in enumerate(ck.one[2]):
        assert r["drill"]["restarts"] == 1, rank
        assert r["drill"]["steps"] == [0, 1, 2, 3]
        assert r["drill"]["losses"] == r["unbroken"]["losses"], rank
        assert os.path.exists(os.path.join(ck.tmp, f"drill_marker.rank{rank}"))
    assert not os.path.exists(os.path.join(ck.tmp, "drill_marker"))
    assert ck.one[2][0]["drill"]["checkpoint"]["saves"] > 0
    assert ck.one[2][1]["drill"]["checkpoint"]["saves"] == 0  # rank 0 alone writes


def test_ranks_resume_past_a_corrupt_newest_checkpoint(ck):
    """The drill's newest checkpoint with a flipped byte: rank 0 falls
    back to the one before, and every rank resumes that step (3), whose
    step repeats the uninterrupted run's bit for bit."""
    assert ck.corrupt == 4
    for r in ck.two[2]:
        assert r["fallback"]["steps"] == [3, 4]
        assert r["fallback"]["losses"][0] == ck.one[2][0]["unbroken"]["losses"][3]


def _leaves(path: str) -> dict:
    m = _manifest(path)
    out = {}
    for key, meta in m["leaves"].items():
        arr = np.load(os.path.join(path, "step-00000000", meta["file"]))
        out[key] = arr.view(np.uint16) if meta["dtype"] == "bfloat16" else arr
    return out


@pytest.mark.parametrize("case,D,M", W.RESHARDS)
def test_a_checkpoint_reshards_losslessly(ck, case, D, M):
    """A checkpoint written on one mesh restores on another (another data
    or model size, one rank; the explicit engine at another dp, its rows
    re-padded) and checkpoints again at once: the GSPMD engine's files
    are the source's byte for byte (the one-rank checkpoint of the same
    state); the explicit engine's rows equal up to the zero pad, the
    other leaves byte for byte, and the int8 residual, rank-local,
    restarts at zero at another dp."""
    src = W.ckpt_path(ck.tmp, case, "torch")
    dst = W.ckpt_path(ck.tmp, case, W.reshard_name(D, M))
    if W.CKPT_CASES[case][0] == "pjit":
        _files_equal(src, dst)
        return
    a, b = _leaves(src), _leaves(dst)
    assert sorted(a) == sorted(b)
    for key in a:
        if key in ROW_KEYS:
            n = min(a[key].shape[1], b[key].shape[1])
            np.testing.assert_array_equal(a[key][:, :n], b[key][:, :n], err_msg=key)
            for arr in (a[key], b[key]):
                assert not arr[:, n:].any(), key  # only the zero pad was cut or grown
            assert b[key].shape[1] % D == 0
        elif key.startswith("g_err/"):
            assert b[key].shape[0] == D and not b[key].any(), key
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_tier_migration_on_ranks_takes_the_portable_path(ck):
    """An off-graph checkpoint (params alone) resumed by an in-graph run on
    ranks meets the ``KeyError`` on rank 0, and every rank adopts the
    global params (``adopt_state``: fresh masters and moments), then
    trains."""
    for r in ck.two[2]:
        mig = r["migration"]
        assert mig["adopted"] == [["params"]]
        assert mig["steps"] == [0] and np.isfinite(mig["losses"]).all()


def test_params_from_state_at_dp2_is_dp1s(ck):
    """The explicit engine's ``params_from_state`` on each rank's rows at
    dp 2 (all-gathered over the ranks first) is the one-rank engine's on
    the global rows, leaf for leaf."""
    for r in ck.one[2]:
        u = r["params_from_state"]
        paths = tpt.tree_paths(u["dp1"])
        assert paths == tpt.tree_paths(u["dp2"])
        for path in paths:
            assert torch.equal(tpt.tree_get(u["dp2"], path), tpt.tree_get(u["dp1"], path)), path


@pytest.mark.parametrize("flag", [["--elastic"], ["--chaos", "kill:0.5"]])
def test_elastic_and_chaos_still_raise_naming_item_5(flag):
    args = ttrain.build_argparser().parse_args(["--smoke"] + flag)
    with pytest.raises(NotImplementedError, match="item 5: the elastic supervisor"):
        ttrain._unported(args)


def test_failure_marker_is_each_ranks_own_on_a_mesh(tmp_path):
    """On a mesh each rank's injector writes and reads its own marker, so
    the first rank's failure does not stop the others'; at one rank the
    marker is the reference's path."""
    marker = str(tmp_path / "m")
    assert FailureInjector(2, marker).marker == marker
    injectors = [FailureInjector(2, marker, rank=r) for r in range(2)]
    for r, inj in enumerate(injectors):
        assert inj.marker == f"{marker}.rank{r}"
        with pytest.raises(SimulatedFailure):
            inj.maybe_fail(2)
    for inj in injectors:  # the next incarnation runs on
        inj.maybe_fail(2)


def test_gspmd_gather_and_shard_are_the_identity_at_one_rank():
    """At one rank ``checkpoint_state`` hands the state itself on (the
    snapshot copies it) and a restore places it as it is."""
    from repro_torch import configs as tconfigs
    from repro_torch.config import RunConfig, make_parallel
    from repro_torch.core.engine import ZeroInfinityEngine

    cfg = dataclasses.replace(tconfigs.smoke("smollm-135m"), n_layers=2)
    eng = ZeroInfinityEngine(RunConfig(model=cfg, parallel=make_parallel("pjit")), "cpu")
    state = eng.init_state(torch.Generator().manual_seed(0))
    assert eng.gather_state(state) is state
    shard = eng.shard_state(state)
    assert shard["params"] is state["params"]


@pytest.mark.parametrize("width", [6, 8, 10])
def test_repad_last_is_the_references(width):
    """``runtime/elastic._repad_last`` grows the last axis with zeros or
    cuts its zero pad, as the reference's does on numpy; and
    ``adapt_state_layout`` re-pads an explicit state's rows (and master /
    m / v) to the executor's padded width, leaving a GSPMD state as it
    is."""
    from repro.runtime import elastic as jelastic
    from repro_torch import configs as tconfigs
    from repro_torch.config import RunConfig, make_parallel
    from repro_torch.core.executor import InfinityExecutor
    from repro_torch.runtime import elastic as telastic

    rows = np.zeros((3, 8), np.float32)
    rows[:, :6] = np.arange(18, dtype=np.float32).reshape(3, 6) + 1
    got = telastic._repad_last(torch.from_numpy(rows), width)
    np.testing.assert_array_equal(got.numpy(), jelastic._repad_last(rows, width))
    cfg = dataclasses.replace(tconfigs.smoke("smollm-135m"), n_layers=2, d_model=47)
    ex = InfinityExecutor(RunConfig(model=cfg, parallel=make_parallel("zero3")), "cpu",
                          mesh=mesh_mod.LocalMesh(4, 1, 0, 4, torch.device("cpu"), None, "gloo"))
    P = ex.engine.layout.padded
    assert P == 24_160
    state = {k: torch.ones(2, 24_158) for k in ("flat", "master", "m", "v")}
    state["step"] = torch.zeros((), dtype=torch.int32)
    out = telastic.adapt_state_layout(state, ex)
    for k in ("flat", "master", "m", "v"):
        assert out[k].shape == (2, P) and not out[k][:, 24_158:].any()
    assert out["step"] is state["step"]
    gspmd = InfinityExecutor(RunConfig(model=cfg, parallel=make_parallel("pjit")), "cpu")
    assert telastic.adapt_state_layout(state, gspmd) is state
