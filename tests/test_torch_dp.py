"""The port's explicit ZeRO-3 engine at dp > 1, one process per rank over
``torch.distributed`` (gloo, on the CPU), against the JAX package's
``InfinityExecutor(engine="zero3")`` on a mesh of as many host devices.

Two sides, started together by the module's fixture:

* the reference (``tests/torch_dp_reference.py``): one subprocess with four
  host devices (this process keeps one, ``tests/conftest.py``), every case
  of ``torch_dp_worker.CASES`` on a mesh of its dp, and
  ``psum_compressed`` under ``shard_map`` on 2 devices;
* the port (``tests/torch_dp_worker.py``, which imports no JAX): 2 ranks
  for the dp-2 cases and the units, 4 for the dp-4 case, each rank its
  own process joined through a file store, each spawn killed and failed
  after 120 s.

Both start from the reference engine's initial state (drawn here at one
device, its rows padded for the case's dp and handed to the ranks, each
keeping its shard), on the same global batches (each rank its rows). The
model is the smoke smollm cut to 2 layers (``CASES`` widens nothing; the
dp-4 case narrows d_model to 47 so its row pads: P = 24,158 -> 24,160).
Cases, each for ``STEPS`` steps: the monolithic step in allgather mode at
dp 2 and dp 4 with every state on the device, broadcast mode at dp 2, int8
compression at dp 2, the optimizer on NVMe off-graph with the gradients
drained there at dp 2, and the layered epoch at dp 2 with params, grads and
optimizer on NVMe.

Tolerances are ``tests/test_torch_zero3_step.py``'s, imported from it
(``TIER_TOL`` for loss and grad norm, ``INT8_NORM_TOL`` for the grad norm
under int8, ``adam.parity_bound`` for the flat, the masters and 'other',
``MOMENT_REL`` for m and v); the tier counters summed over the ranks
equal the reference's exactly, as does ``psum_compressed``, bit for bit.
"""
import concurrent.futures
import dataclasses
import os
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
from repro.core.zero import ExplicitZero3Engine as JEngine  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import RunConfig, make_offload, make_parallel  # noqa: E402
from repro_torch.core import executor as texec  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core.zero import ExplicitZero3Engine  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from test_torch_zero3_step import INT8_NORM_TOL, MOMENT_REL, TIER_TOL  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = list(W.CASES)
IN_GRAPH = [c for c in CASES if W.CASES[c][4] == "device"]
WITH_COUNTERS = [c for c in CASES if c not in IN_GRAPH]
TIMEOUT = 120.0


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _save_init(tmp: str, case: str) -> None:
    """The reference engine's initial state at one device, its rows padded
    to the case's dp (zeros, as the reference pads), as the port's
    tensors: what every rank of both sides starts from."""
    dp, d_model = W.CASES[case][:2]
    wide = {} if d_model is None else {"d_model": d_model}
    cfg = dataclasses.replace(jconfigs.smoke("smollm-135m"), n_layers=2, **wide)
    eng = JEngine(JRun(model=cfg, parallel=jmake_parallel("zero3")), make_local_mesh(1, 1))
    init = jax.tree.map(np.asarray, eng.init_state(jax.random.PRNGKey(0)))
    state = bridge.zero3_state_from_numpy({k: init[k] for k in ("flat", "other", "other_opt",
                                                                 "step")})
    state["flat"] = torch.nn.functional.pad(state["flat"], (0, (-state["flat"].shape[1]) % dp))
    torch.save(state, W.init_path(tmp, case))


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Both sides' results: the reference's ``.npz`` and, per world size,
    each rank's saved dict; the port at one rank on the dp-2 allgather
    case's global batches beside them."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    ref_path = os.path.join(tmp, "ref.npz")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    ref = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dp_reference.py"),
                            tmp, ref_path], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        for case in ("allgather_dp2", "allgather_dp4"):
            _save_init(tmp, case)
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = {world: pool.submit(W.spawn, "dp", world, tmp, TIMEOUT) for world in (2, 4)}
            one = W.run_case("allgather_dp2", tmp, mesh_mod.make_local_mesh(1, 1, "cpu"))
            ranks = {world: f.result() for world, f in runs.items()}
        out, _ = ref.communicate(timeout=TIMEOUT)
    except BaseException:
        ref.kill()
        ref.communicate()
        raise
    assert ref.returncode == 0, out[-4000:]
    yield types.SimpleNamespace(ref=dict(np.load(ref_path)), ranks=ranks, one=one, tmp=tmp)


def _ranks(dp, case):
    return [r[case] for r in dp.ranks[W.CASES[case][0]]]


def _assemble(case, shards) -> np.ndarray:
    """The ranks' (L, P/dp) or (L/dp, P) shards as the global (L, P)."""
    axis = 1 if W.CASES[case][6] == "allgather" else 0
    return np.concatenate([_np(s) for s in shards], axis=axis)


def _drift(dp, case) -> float:
    run = W._runs(case, "")
    return tadam.parity_bound(run.train, list(dp.ref[f"{case}/lr"]))


@pytest.mark.parametrize("case", CASES)
def test_both_sides_start_from_the_same_rows(dp, case):
    """The reference's own init at the case's dp is the rows the ranks
    shard, bit for bit: the same draw, padded with the same zeros."""
    init = torch.load(W.init_path(dp.tmp, case), weights_only=False)
    want = dp.ref[f"{case}/init_flat"]
    assert want.shape[1] % W.CASES[case][0] == 0
    np.testing.assert_array_equal(_np(init["flat"]), want)
    if case == "allgather_dp4":
        assert want.shape[1] == 24_160 and not want[:, 24_158:].any()


@pytest.mark.parametrize("step", range(W.STEPS))
@pytest.mark.parametrize("case", CASES)
def test_step_matches_reference_loss_grad_norm_and_lr(dp, case, step):
    ranks = _ranks(dp, case)
    for key in ("loss", "grad_norm", "lr"):
        got = [r["metrics"][step][key] for r in ranks]
        assert len(set(got)) == 1, (case, key, got)  # summed over the ranks: one value
        tol = INT8_NORM_TOL if (case.startswith("int8") and key == "grad_norm") else TIER_TOL
        np.testing.assert_allclose(got[0], dp.ref[f"{case}/{key}"][step], **tol,
                                   err_msg=f"{case} {key}")


@pytest.mark.parametrize("case", CASES)
def test_flat_after_last_step_matches_reference(dp, case):
    """The ranks' rows (from the param store on the layered epoch)
    gathered, against the reference's global flat: the drift bound plus
    each side's bf16 rounding, the mean by 2^-5 * sum(lr)."""
    got, want = _assemble(case, [r["flat"] for r in _ranks(dp, case)]), dp.ref[f"{case}/flat"]
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert (diff <= _drift(dp, case) + 2**-8 * (np.abs(want) + np.abs(got))).all(), \
        (case, diff.max())
    assert diff.mean() <= 2**-5 * sum(dp.ref[f"{case}/lr"]), (case, diff.mean())


@pytest.mark.parametrize("case", CASES)
def test_in_graph_optimizer_states_match_reference(dp, case):
    """Masters gathered to the drift bound, m and v to ``MOMENT_REL`` in
    norm; off-graph cases carry none on either side."""
    ranks = _ranks(dp, case)
    if case not in IN_GRAPH:
        assert all("master" not in r for r in ranks) and f"{case}/master" not in dp.ref
        return
    diff = np.abs(_assemble(case, [r["master"] for r in ranks]) - dp.ref[f"{case}/master"])
    assert diff.max() <= _drift(dp, case), (case, diff.max())
    for name in ("m", "v"):
        got, want = _assemble(case, [r[name] for r in ranks]), dp.ref[f"{case}/{name}"]
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= MOMENT_REL, (case, name, rel)


@pytest.mark.parametrize("case", CASES)
def test_other_states_and_step_match_reference(dp, case):
    """The embedding and final norm, the same on every rank and within the
    drift bound of the reference's; both step counts."""
    ranks = _ranks(dp, case)
    for path in tpt.tree_paths(ranks[0]["other"]):
        got = [_np(tpt.tree_get(r["other"], path)) for r in ranks]
        assert all(np.array_equal(g, got[0]) for g in got), (case, path)
        want = dp.ref[f"{case}/other/" + "".join(f"[{k!r}]" for k in path)]
        diff = np.abs(got[0] - want)
        assert (diff <= _drift(dp, case) + 2**-8 * np.abs(want)).all(), (case, path, diff.max())
    assert all(r["step"] == W.STEPS for r in ranks) and int(dp.ref[f"{case}/step"]) == W.STEPS


@pytest.mark.parametrize("case", CASES)
def test_int8_residuals_are_each_ranks_slice(dp, case):
    """``g_err``: each rank holds its (1, ...) slice of the reference's
    (dp, ...) residual; the slices agree in size with the reference's
    rank for rank (largest element within 2x, as at one rank: element for
    element they decorrelate)."""
    ranks = _ranks(dp, case)
    if not case.startswith("int8"):
        assert all("g_err" not in r for r in ranks)
        assert not [k for k in dp.ref if k.startswith(f"{case}/g_err")]
        return
    for path in tpt.tree_paths(ranks[0]["g_err"]):
        want = dp.ref[f"{case}/g_err/" + "".join(f"[{k!r}]" for k in path)]
        assert want.shape[0] == len(ranks)
        for rank, r in enumerate(ranks):
            got = tpt.tree_get(r["g_err"], path)
            assert got.dtype == torch.float32 and tuple(got.shape) == (1,) + want.shape[1:]
            g, w = np.abs(_np(got)).max(), np.abs(want[rank]).max()
            assert 0 < g <= 2 * w and w <= 2 * g, (path, rank, g, w)


@pytest.mark.parametrize("case", CASES)
def test_tier_counters_summed_over_ranks_match_reference(dp, case):
    """Each rank counts its own bytes, half (a dp-th) of the step's; their
    sum over the ranks (``<counter>_all_ranks``) is the reference's, which
    counts every rank's in one process. The opt store keys, the ranks'
    together, are the reference's (``rank<r>/flat``, ``rank<r>/l<i>``)."""
    ranks = _ranks(dp, case)
    keys = sorted(k[len(f"{case}/ctr/"):] for k in dp.ref if k.startswith(f"{case}/ctr/"))
    if case not in WITH_COUNTERS:
        assert not keys and not [k for k in ranks[0]["metrics"][0] if k.endswith("_bytes")]
        return
    assert {"opt_read_bytes", "opt_write_bytes", "grad_out_bytes"} <= set(keys)
    for step in range(W.STEPS):
        for key in keys:
            mine = [r["metrics"][step][key] for r in ranks]
            assert all(r["metrics"][step][f"{key}_all_ranks"] == sum(mine) for r in ranks), key
            assert sum(mine) == int(dp.ref[f"{case}/ctr/{key}"][step]), (case, step, key)
            if "peak" not in key:  # every rank moves its equal shard
                assert len(set(mine)) == 1, (case, key, mine)
    assert sorted(k for r in ranks for k in r["opt_keys"]) == list(dp.ref[f"{case}/opt_keys"])


def test_row_gather_backward_is_reduce_scatter(dp):
    """``RowGather`` on 2 ranks: its forward is ``all_gather_into_tensor``
    of the slices, the slice's gradient ``reduce_scatter_tensor`` of the
    row's cotangent, bit for bit, in bf16."""
    for r in dp.ranks[2]:
        u = r["row_gather"]
        assert u["grad"].dtype == torch.bfloat16
        assert torch.equal(u["row"], u["want_row"]) and torch.equal(u["grad"], u["want_grad"])


@pytest.mark.parametrize("case", W.PSUM_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_psum_compressed_across_two_ranks_is_bit_exact(dp, case):
    """Reduced value and each rank's new residual, bit for bit against the
    reference under ``shard_map`` on 2 devices, over three steps."""
    shape, dtype = case
    for rank, r in enumerate(dp.ranks[2]):
        for i, (red, err) in enumerate(r["psum"][case]):
            want_red = dp.ref[f"psum/{shape}/{dtype}/{i}/red"][rank]
            want_err = dp.ref[f"psum/{shape}/{dtype}/{i}/err"][rank]
            np.testing.assert_array_equal(_np(red), want_red, err_msg=f"{case} {rank} {i}")
            assert err.dtype == torch.float32
            np.testing.assert_array_equal(_np(err), want_err, err_msg=f"{case} {rank} {i}")


@pytest.mark.parametrize("step", range(W.STEPS))
def test_dp2_equals_one_rank_on_the_same_global_batch(dp, step):
    """The port at dp 2 against the port at one rank on the same global
    batches: loss and grad norm within ``TIER_TOL`` each step, the rows
    after the last within the drift bound plus the bf16 rounding."""
    two, one = _ranks(dp, "allgather_dp2")[0], dp.one
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(two["metrics"][step][key], one["metrics"][step][key],
                                   **TIER_TOL, err_msg=key)
    if step == W.STEPS - 1:
        got = _assemble("allgather_dp2", [r["flat"] for r in _ranks(dp, "allgather_dp2")])
        want = _np(one["flat"])
        diff = np.abs(got - want)
        assert (diff <= _drift(dp, "allgather_dp2")
                + 2**-8 * (np.abs(want) + np.abs(got))).all(), diff.max()


# ---------------------------------------------------------------------------
# the transport rule and what stays unported at dp > 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device,local,cards,want", [
    ("cpu", 2, 0, "gloo"), ("cpu", 4, 4, "gloo"), ("cuda", 2, 1, "gloo"),
    ("cuda", 4, 4, "nccl"), ("cuda", 1, 1, "nccl")])
def test_backend_rule(monkeypatch, device, local, cards, want):
    """NCCL when each local rank has a card of its own, gloo when ranks
    share one (two ranks on one H100) or run on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert mesh_mod.choose_backend(device, local) == want


def test_one_rank_mesh_and_a_mismatched_world_size():
    mesh = mesh_mod.make_local_mesh(1, 1, "cpu")
    assert (mesh.world, mesh.rank, mesh.backend, mesh.group) == (1, 0, "none", None)
    t = torch.arange(4.0)
    assert mesh.all_gather(t) is t and mesh.reduce_scatter(t) is t and mesh.all_reduce(t) is t
    with pytest.raises(ValueError, match="torchrun --standalone --nproc-per-node 4"):
        mesh_mod.make_local_mesh(2, 2, "cpu")


class _FakeMesh(mesh_mod.LocalMesh):
    """A rank's mesh with no process group, its object gather every rank's
    own: enough for what runs before the first tensor collective."""

    def gather_objects(self, obj) -> list:
        return [obj] * self.world


def _fake_mesh(world=2):
    """A rank's mesh with no process group: enough for what refuses
    before the first collective."""
    return _FakeMesh(world, 1, 0, world, torch.device("cpu"), None, "gloo")


def _run(arch="smollm-135m", engine="zero3", **offload):
    return RunConfig(model=tconfigs.smoke(arch), parallel=make_parallel(engine),
                     offload=make_offload(**offload))


@pytest.mark.parametrize("what,build,match", [
    ("gspmd", lambda m: texec.InfinityExecutor(_run(engine="pjit", param_tier="nvme"), "cpu",
                                               mesh=m), None),
    # MoE's expert rows and q8/q4 rows run at dp > 1 (tests/test_torch_dp_moe.py);
    # around them, assembling a MoE engine's params from the ranks' slices
    # gathers its rows (``params_from_state``: expert rows by columns), and
    # the GSPMD engine's --param-quant runs on a mesh (8f), MoE on a model
    # axis among them
    ("moe", lambda m: ExplicitZero3Engine(_run("granite-moe-1b-a400m", param_tier="nvme"),
                                          "cpu", m)._row_dim("eflat"), None),
    ("q8", lambda m: texec.InfinityExecutor(_run(engine="pjit", param_quant="q8"), "cpu",
                                            mesh=m), None),
    ("q4", lambda m: texec.InfinityExecutor(
        _run("granite-moe-1b-a400m", engine="pjit", param_quant="q4"), "cpu",
        mesh=mesh_mod.LocalMesh(1, 2, 0, 2, torch.device("cpu"), None, "gloo")), None)])
def test_engine_refuses_what_stays_unported_at_dp2(what, build, match):
    """Nothing of these stays unported at dp 2 (items 5's checkpoint half
    and 8f): each builds on a rank of a fake mesh, MoE's expert rows join
    along their columns."""
    out = build(_fake_mesh())
    if what == "moe":
        assert out == 1
    else:
        assert out.dp == 2 and out.param_store is None


BASE = ["--smoke", "--device", "cpu", "--engine", "zero3", "--data-mesh", "2",
        "--steps", "1", "--batch", "2", "--seq", "16", "--ckpt-every", "0"]


class _Built(Exception):
    """Raised where a run on a fake mesh asks for its train step: it got
    past every refusal, built its executor and its state."""


@pytest.mark.parametrize("extra,error,match", [
    (["--engine", "pjit", "--offload-param", "nvme"], _Built, "pjit"),
    (["--plan", "auto"], ValueError, "a plan for 1 device.*this run has 2"),
    (["--arch", "granite-moe-1b-a400m", "--offload-param", "nvme", "--ckpt-every", "2"],
     _Built, "zero3"),
    (["--engine", "pjit", "--param-quant", "q8"], _Built, "pjit"),
    (["--ckpt-every", "2"], _Built, "zero3"),
    (["--resume", "auto"], _Built, "zero3")])
def test_cli_refuses_what_stays_unported_at_dp2(monkeypatch, tmp_path, extra, error, match):
    """``launch.train`` on a 2-rank mesh: a plan for the one device the CPU
    detects raises (ValueError, naming both counts); the GSPMD engine with
    params on NVMe or ``--param-quant`` (8f), checkpoints (a MoE run's
    too) and resume (item 5's checkpoint half) build their executor and
    state and ask for the train step, which the fake mesh stops before any
    collective. (They run on ranks: ``tests/test_torch_nvme_mesh.py``,
    ``tests/test_torch_checkpoint_mesh.py``.)"""
    monkeypatch.setattr(mesh_mod, "make_local_mesh", lambda *a: _fake_mesh())

    def make_train_step(self, **kw):
        raise _Built(self.run.parallel.engine)

    monkeypatch.setattr(texec.InfinityExecutor, "make_train_step", make_train_step)
    argv = BASE + ["--nvme-dir", str(tmp_path), "--ckpt-dir", str(tmp_path / "ck")] + extra
    with pytest.raises(error, match=match):
        ttrain.train(ttrain.build_argparser().parse_args(argv), argv)


def test_plan_for_two_devices_and_profile_on_a_mesh_raise(tmp_path):
    """A plan for 2 devices on one rank raises, naming both counts, and
    ``profile_train --data-mesh 2`` in one process names the launch that
    gives it its ranks (on a mesh both run: tests/test_torch_gspmd_mesh.py
    and the card)."""
    run = _run()
    with pytest.raises(ValueError, match="a plan for 2 device.*this run has 1"):
        texec.check_ported(run, n_devices=2)
    from repro_torch.launch import profile_train

    with pytest.raises(ValueError, match="torchrun --standalone --nproc-per-node 2"):
        profile_train.main(["--smoke", "--data-mesh", "2", "--nvme-dir", str(tmp_path)])


def test_checkpoint_views_refuse_at_dp2(tmp_path):
    """The views no longer refuse at dp 2 (item 5's checkpoint half): a
    restore cuts the rank's part of the global leaves with no collective.
    On rank 0 of 2, ``restore_state`` and ``adopt_state`` of a global
    state give the rank's columns of the rows (in-graph: masters and
    moments too), the small states whole; the portable structure is read
    without a gather."""
    ex = texec.InfinityExecutor(_run(), "cpu", mesh=_fake_mesh())
    one = texec.InfinityExecutor(_run(), "cpu")
    whole = one.engine.init_state(torch.Generator().manual_seed(3))
    half = whole["flat"].shape[1] // 2
    for state in (ex.restore_state(whole, step=0), ex.adopt_state(
            {k: whole[k] for k in one.engine.portable_keys})):
        assert torch.equal(state["flat"], whole["flat"][:, :half])
        assert torch.equal(state["master"], whole["flat"][:, :half].float())
        assert torch.equal(state["other"]["embed"]["tok"], whole["other"]["embed"]["tok"])
    assert sorted(ex.portable_like(state)) == sorted(one.engine.portable_keys)


def test_rank_slices_and_row_shards_tile_the_global_arrays():
    """Rank r's rows of a global batch and its shard of the (L, P) rows,
    over every rank, are the whole in rank order (allgather: columns,
    broadcast: layers); an uneven split raises."""
    from repro_torch.data import pipeline as tpipe

    batch = {"tokens": np.arange(24, dtype=np.int32).reshape(4, 6)}
    for dp_ in (1, 2, 4):
        parts = [tpipe.rank_slice(batch, r, dp_)["tokens"] for r in range(dp_)]
        np.testing.assert_array_equal(np.concatenate(parts), batch["tokens"])
    with pytest.raises(ValueError, match="do not split over 3 ranks"):
        tpipe.rank_slice(batch, 0, 3)
    rows = torch.arange(4 * 12, dtype=torch.float32).reshape(4, 12)
    for mode, axis in (("allgather", 1), ("broadcast", 0)):
        shards = [tpt.row_shard(rows, r, 4, mode) for r in range(4)]
        assert torch.equal(torch.cat(shards, dim=axis), rows)
    with pytest.raises(ValueError, match="do not split over 8 ranks"):
        tpt.row_shard(rows, 0, 8, "broadcast")
