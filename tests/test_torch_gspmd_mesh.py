"""The port's GSPMD engine on data-parallel ranks, one process per rank over
``torch.distributed`` (gloo, on the CPU), against the JAX package's
``InfinityExecutor(engine="pjit")`` on a mesh of as many host devices.

* **The rules.** For every config of ``repro/configs``, at data 2 and 4
  (model 1), each state class (param, grad, opt, act) and ZeRO stages
  0-3: the port's ``make_rules`` + ``spec_tree`` give each leaf the
  reference's ``PartitionSpec`` entry for entry, and ``split_dim`` the dim
  the reference's spec puts on the data axis (no process needed: the rules
  read the mesh's axis sizes).
* **The step on ranks.** The module's fixture saves each case's initial
  params (the reference bundle's init at one device, as the port's whole
  tensors), then starts the reference (``tests/torch_dp_reference.py gspmd``:
  one subprocess with four host devices, every case of
  ``torch_dp_worker.GSPMD_CASES`` on a mesh of its dp) and the port's ranks
  (``tests/torch_dp_worker.py``: 2 ranks for the dp-2 cases, 4 for the dp-4
  one, each a process joined through a file store, each spawn killed and
  failed after ``TIMEOUT`` s) together. Both sides start from those params
  (each rank its shards, ``bridge.shard_gspmd_state``) on the same global
  batches (each rank its rows, ``data/pipeline.rank_batch``), for
  ``GSPMD_STEPS`` steps. Cases: ZeRO-3 in-graph at dp 2 and dp 4; stages 0,
  1 and 2 at dp 2; the host tier; the optimizer on NVMe off-graph with the
  gradients drained there; two microbatches; d_model 47, which splits over
  no rank (every leaf whole: the divisibility guard and the norm's whole
  leaves); a global batch of 3, which every rank takes whole; and the smoke
  vlm, hybrid, ssm and encdec configs at stage 3.
* **The plan.** ``launch.train --plan auto --hw-devices 2`` on the 2-rank
  mesh (its hardware pinned by ``--hw-*``): the reference's plan for the
  same hardware, byte for byte, and its ``RunConfig``; it trains.
* **Refusals.** A plan for another number of devices than the ranks
  (ValueError, naming both). A model axis is ported for every family
  (ROADMAP item 8g: the encoder-decoder builds and runs up to its first
  collective here, ``tests/test_torch_encdec_tp.py`` runs it), and on a
  GSPMD mesh params on NVMe and ``--param-quant`` (8f: they build here,
  ``tests/test_torch_nvme_mesh.py`` runs them). (The MoE family on a
  GSPMD mesh runs: ``tests/test_torch_dp_moe.py``.)

Tolerances are ``tests/test_torch_gspmd.py``'s, imported from it:
``TIER_TOL`` (rtol = atol = 2e-3) for loss, grad norm and lr each step;
``adam.parity_bound`` (the drift of two AdamW runs from equal starts) plus
each side's bf16 rounding (2^-8 of the value) for the params, their mean by
2^-5 * sum(lr); the drift bound alone for the f32 masters; ``MOMENT_REL``
(2^-5 in relative norm) for m and v. Each rank's shard is held to the same
bounds against the reference's addressable shard on the device of its rank.
The tier counters summed over the ranks equal the reference's exactly; each
rank's state bytes equal ``ZeroInfinityEngine.shard_bytes``.
"""
import concurrent.futures
import dataclasses
import functools
import math
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
from repro import plan as jplan  # noqa: E402
from repro.config import make_parallel as jmake_parallel  # noqa: E402
from repro.core import partition as jpt  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import RunConfig, make_offload, make_parallel  # noqa: E402
from repro_torch.core import executor as texec  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core.engine import ZeroInfinityEngine  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from test_torch_gspmd import MOMENT_REL, TIER_TOL  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = list(W.GSPMD_CASES)
ARCHS = sorted(jconfigs._MODULES)
STATES = ("param", "grad", "opt", "act")
TIMEOUT = 300.0


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


# ---------------------------------------------------------------------------
# the rules against the reference's, per leaf
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _defs(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return (jcfg, jreg.FAMILY_MODULES[jcfg.family].param_defs(jcfg),
            tcfg, treg.FAMILY_MODULES[tcfg.family].param_defs(tcfg))


@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("for_state", STATES)
@pytest.mark.parametrize("dp", (2, 4))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_give_each_leaf_the_references_spec(arch, dp, for_state, stage):
    """Every leaf's spec equals the reference's ``PartitionSpec`` on a
    ``data x model`` = ``dp x 1`` mesh, and its split dim is the dim that
    spec puts on the data axis (None where the divisibility guard or the
    stage leaves it whole)."""
    jcfg, jdefs, tcfg, tdefs = _defs(arch)
    sizes = {"data": dp, "model": 1}
    fake_mesh = types.SimpleNamespace(axis_names=("data", "model"), shape=sizes)
    jrules = jpt.make_rules(jcfg, fake_mesh, jmake_parallel("pjit", zero_stage=stage),
                            for_state=for_state)
    trules = tpt.make_rules(tcfg, sizes, make_parallel("pjit", zero_stage=stage),
                            for_state=for_state)
    jspecs = {jax.tree_util.keystr(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        jpt.spec_tree(jdefs, jrules), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    tspecs = tpt.spec_tree(tdefs, trules)
    paths = tpt.tree_paths(tspecs)
    assert sorted(_keystr(p) for p in paths) == sorted(jspecs)
    split_any = False
    for path in paths:
        want = tuple(jspecs[_keystr(path)])
        got = tpt.tree_get(tspecs, path)
        assert got == want, (path, got, want)
        on_data = [i for i, e in enumerate(want)
                   if e == "data" or (isinstance(e, tuple) and "data" in e)]
        assert tpt.split_dim(got, trules) == (on_data[0] if on_data else None), path
        split_any |= bool(on_data)
    # MoE's expert weights take their own stage (moe_zero_stage, 3)
    stages = (stage, 3) if tcfg.family == "moe" else (stage,)
    least = {"param": 3, "grad": 2, "opt": 1, "act": 5}[for_state]
    assert split_any == any(s >= least for s in stages), (arch, for_state, stage)


# ---------------------------------------------------------------------------
# the step on ranks against the reference on host devices
# ---------------------------------------------------------------------------


def _save_inits(tmp: str) -> None:
    """Each case's initial params: the reference bundle's init at one
    device (one draw per config), as the port's tensors."""
    drawn = {}
    for case in CASES:
        cfg = W.gspmd_cfg(case, jconfigs)
        key = repr(cfg)
        if key not in drawn:
            params = jax.jit(jreg.build(cfg).init)(jax.random.PRNGKey(0))
            drawn[key] = bridge.params_from_numpy(jax.tree.map(np.asarray, params))
        torch.save(drawn[key], W.gspmd_init_path(tmp, case))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's ``.npz`` and, per world size, each rank's results."""
    tmp = str(tmp_path_factory.mktemp("gspmd_mesh"))
    ref_path = os.path.join(tmp, "ref.npz")
    _save_inits(tmp)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    ref = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dp_reference.py"),
                            tmp, ref_path, "gspmd"], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = {world: pool.submit(W.spawn, "gspmd", world, tmp, TIMEOUT)
                    for world in (2, 4)}
            out = {world: f.result() for world, f in runs.items()}
        log, _ = ref.communicate(timeout=TIMEOUT)
    except BaseException:
        ref.kill()
        ref.communicate()
        raise
    assert ref.returncode == 0, log[-4000:]
    yield types.SimpleNamespace(ref=dict(np.load(ref_path)), ranks=out, tmp=tmp)


def _ranks(ranks, case):
    return [r[case] for r in ranks.ranks[W.GSPMD_CASES[case][0]]]


def _lrs(ranks, case):
    return list(ranks.ref[f"{case}/lr"])


def _drift(ranks, case) -> float:
    return tadam.parity_bound(W._gspmd_run(case, "").train, _lrs(ranks, case))


def _whole(shards, splits, cls, path) -> np.ndarray:
    return _np(tpt.unshard_leaf([tpt.tree_get(s, path) for s in shards],
                                tpt.tree_get(splits[cls], path)))


def _params_within(got, want, drift, lrs, what):
    diff = np.abs(got - want)
    assert (diff <= drift + 2**-8 * (np.abs(want) + np.abs(got))).all(), (what, diff.max())
    assert diff.mean() <= 2**-5 * sum(lrs), (what, diff.mean())


@pytest.mark.parametrize("step", range(W.GSPMD_STEPS))
@pytest.mark.parametrize("case", CASES)
def test_step_matches_reference_loss_grad_norm_and_lr(ranks, case, step):
    """Loss and grad norm, each summed over the ranks (one value on every
    rank), and the lr, against the reference's global step by
    ``TIER_TOL``."""
    rs = _ranks(ranks, case)
    for key in ("loss", "grad_norm", "lr"):
        got = [r["metrics"][step][key] for r in rs]
        assert len(set(got)) == 1, (case, key, got)
        np.testing.assert_allclose(got[0], ranks.ref[f"{case}/{key}"][step], **TIER_TOL,
                                   err_msg=f"{case} {key}")


@pytest.mark.parametrize("case", CASES)
def test_params_after_last_step_match_reference(ranks, case):
    """The ranks' param shards put back together, leaf by leaf, against
    the reference's global params: the drift bound plus each side's bf16
    rounding, the mean by 2^-5 * sum(lr)."""
    rs = _ranks(ranks, case)
    splits, drift, lrs = rs[0]["splits"], _drift(ranks, case), _lrs(ranks, case)
    for path in tpt.tree_paths(rs[0]["params"]):
        got = _whole([r["params"] for r in rs], splits, "param", path)
        want = ranks.ref[f"{case}/params/{_keystr(path)}"]
        assert got.shape == want.shape, (path, got.shape, want.shape)
        _params_within(got, want, drift, lrs, (case, path))


@pytest.mark.parametrize("case", CASES)
def test_optimizer_states_match_reference(ranks, case):
    """In-graph: the step count, the masters put back together within the
    drift bound, m and v within ``MOMENT_REL`` in norm; off-graph: no
    optimizer in the state on either side."""
    rs = _ranks(ranks, case)
    if "opt" not in rs[0]:
        assert W._gspmd_run(case, "").opt_offgraph
        assert f"{case}/step" not in ranks.ref
        return
    splits, drift = rs[0]["splits"], _drift(ranks, case)
    assert all(int(r["opt"][0]) == W.GSPMD_STEPS for r in rs)
    assert int(ranks.ref[f"{case}/step"]) == W.GSPMD_STEPS
    for path in tpt.tree_paths(rs[0]["opt"][1]):
        name = _keystr(path)
        master = _whole([r["opt"][1] for r in rs], splits, "opt", path)
        diff = np.abs(master - ranks.ref[f"{case}/master/{name}"])
        assert diff.max() <= drift, (case, path, diff.max())
        for i, moment in ((2, "m"), (3, "v")):
            got = _whole([r["opt"][i] for r in rs], splits, "opt", path)
            want = ranks.ref[f"{case}/{moment}/{name}"]
            rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
            assert rel <= MOMENT_REL, (case, path, moment, rel)


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_the_references_shard(ranks, case):
    """Rank r's param shard (and in-graph master shard) has the shape of
    the reference's addressable shard on the mesh's r-th device, and its
    values within the same bounds: the port cuts each leaf where XLA
    does."""
    rs = _ranks(ranks, case)
    drift, lrs = _drift(ranks, case), _lrs(ranks, case)
    for rank, r in enumerate(rs):
        for path in tpt.tree_paths(r["params"]):
            name = _keystr(path)
            got = _np(tpt.tree_get(r["params"], path))
            want = ranks.ref[f"{case}/params_shard{rank}/{name}"]
            assert got.shape == want.shape, (rank, path, got.shape, want.shape)
            _params_within(got, want, drift, lrs, (case, rank, path))
            if "opt" in r:
                got = _np(tpt.tree_get(r["opt"][1], path))
                want = ranks.ref[f"{case}/master_shard{rank}/{name}"]
                assert got.shape == want.shape, (rank, path)
                assert np.abs(got - want).max() <= drift, (case, rank, path)


@pytest.mark.parametrize("case", CASES)
def test_rank_bytes_and_their_sums(ranks, case):
    """Each rank's state bytes are its shards' (``shard_bytes``), equal on
    every rank; summed over the ranks (``<counter>_all_ranks``) a split
    class holds the global bytes once. The tier counters summed over the
    ranks equal the reference's, every rank moving its equal part; the opt
    store's keys are the reference's under each rank's prefix."""
    rs = _ranks(ranks, case)
    dp = len(rs)
    for step in range(W.GSPMD_STEPS):
        ms = [r["metrics"][step] for r in rs]
        for key in ("param_shard_bytes", "grad_shard_bytes", "opt_shard_bytes"):
            if key == "opt_shard_bytes" and "opt" not in rs[0]:
                assert key not in ms[0]
                continue
            assert all(m[key] == rs[0]["shard_bytes"][key] for m in ms), (case, key)
            assert all(m[f"{key}_all_ranks"] == dp * ms[0][key] for m in ms), (case, key)
        keys = sorted(k[len(f"{case}/ctr/"):] for k in ranks.ref if k.startswith(f"{case}/ctr/"))
        for key in keys:
            mine = [m[key] for m in ms]
            assert all(m[f"{key}_all_ranks"] == sum(mine) for m in ms), key
            assert sum(mine) == int(ranks.ref[f"{case}/ctr/{key}"][step]), (case, step, key)
            if "peak" not in key:
                assert len(set(mine)) == 1, (case, key, mine)
    if f"{case}/opt_keys" in ranks.ref:
        want = list(ranks.ref[f"{case}/opt_keys"])
        assert want
        for rank, r in enumerate(rs):
            assert r["opt_keys"] == sorted(f"rank{rank}/{k}" for k in want)


def test_zero3_ranks_hold_half_of_every_state_class(ranks):
    """ZeRO-3 at dp 2 on the smoke smollm (every "embed" dim even): each
    rank's param, grad and opt bytes are exactly half of one device's;
    d_model 47 splits nothing, so each rank holds them all."""
    one = ZeroInfinityEngine(W._gspmd_run("stage3_dp2", ""), "cpu").shard_bytes()
    for case, parts in (("stage3_dp2", 2), ("unsplit_dp2", 1)):
        rs = _ranks(ranks, case)
        base = ZeroInfinityEngine(W._gspmd_run(case, ""), "cpu").shard_bytes()
        for key, whole in base.items():
            assert all(r["metrics"][-1][key] * parts == whole for r in rs), (case, key)
        if case == "stage3_dp2":
            assert base == one
    quarter = _ranks(ranks, "stage3_dp4")[0]["metrics"][-1]
    assert all(quarter[k] * 4 == one[k] for k in one)


def test_leaf_gather_backward_is_a_reduce_scatter_along_the_dim(ranks):
    """``LeafGather`` on 2 ranks along dim 1: its forward is the ranks'
    shards concatenated on that dim, the shard's gradient the sum of the
    ranks' cotangents' parts on it, bit for bit, in bf16."""
    for r in ranks.ranks[2]:
        u = r["leaf_gather"]
        assert u["grad"].dtype == torch.bfloat16
        assert torch.equal(u["leaf"], u["want_leaf"]) and torch.equal(u["grad"], u["want_grad"])


def test_plan_for_two_devices_runs_on_two_ranks(ranks):
    """``--plan auto --hw-devices 2`` on 2 ranks: the reference's plan for
    the same hardware (the ranks' pinned ``--hw-*`` fields, the rest as
    both packages detect them on the CPU), byte for byte, and its
    ``RunConfig``; both ranks train on it, the plan's per-device state
    bytes beside each rank's."""
    import json

    from repro.config import ShapeConfig as JShape

    rs = [r["plan"] for r in ranks.ranks[2]]
    assert rs[0]["plan"] == rs[1]["plan"]
    args = ttrain.build_argparser().parse_args(W.PLAN_ARGV)
    hw = jplan.HardwareSpec(**json.loads(rs[0]["plan"])["hardware"])
    assert (hw.n_devices, hw.device_mem) == (2, 4e9)
    want = jplan.resolve_plan(args, jconfigs.smoke("smollm-135m"), JShape("cli", 16, 4, "train"),
                              argv=W.PLAN_ARGV, quiet=True, hardware=hw)
    assert rs[0]["plan"] == want.to_json()
    want_run = want.to_run_config(nvme_dir="nv")
    n = want.predictions["n_params"] / 2
    for r in rs:
        run = r["run"]
        assert run["parallel"] == dict(dataclasses.asdict(want_run.parallel), zero_stage=3)
        assert dict(run["offload"], nvme_dir="nv") == dataclasses.asdict(want_run.offload)
        assert np.isfinite(r["losses"]).all()
        for m in r["metrics"]:
            assert (m["plan_param_shard_bytes"], m["plan_opt_shard_bytes"]) == (2 * n, 12 * n)
            assert m["param_shard_bytes_all_ranks"] == 2 * m["param_shard_bytes"]
    assert rs[0]["losses"] == rs[1]["losses"]


# ---------------------------------------------------------------------------
# what raises on a GSPMD mesh, and the pieces without a process group
# ---------------------------------------------------------------------------


class _FakeMesh(mesh_mod.LocalMesh):
    """A rank's mesh with no process group, its object gather every rank's
    own: enough for what runs before the first tensor collective."""

    def gather_objects(self, obj) -> list:
        return [obj] * self.world


def _fake_mesh(data=2, model=1):
    """A rank's mesh with no process group: enough for what refuses
    before the first collective."""
    return _FakeMesh(data, model, 0, data * model, torch.device("cpu"), None, "gloo")


def _run(arch="smollm-135m", **offload):
    return RunConfig(model=tconfigs.smoke(arch), parallel=make_parallel("pjit"),
                     offload=make_offload(**offload))


@pytest.mark.parametrize("n_devices,dp", [(4, 2), (2, 1), (1, 2)])
def test_a_plan_for_another_device_count_raises_naming_both(n_devices, dp):
    with pytest.raises(ValueError, match=f"a plan for {n_devices} device.*this run has {dp}"):
        texec.check_ported(_run(), n_devices=n_devices, dp=dp)
    texec.check_ported(_run(), n_devices=dp, dp=dp)  # as many ranks as devices: runs


@pytest.mark.parametrize("what,run,mesh,match", [
    ("model_axis", _run("seamless-m4t-medium"), (1, 2), "tp"),
    ("moe", _run("granite-moe-1b-a400m", param_quant="q8"), (2, 1), None),
    ("param_nvme", _run(param_tier="nvme"), (2, 1), None)])
def test_gspmd_mesh_refuses_what_stays_unported(what, run, mesh, match):
    """Nothing here stays unported: the encoder-decoder on a model axis
    (item 8g.4) builds under tensor parallelism, and ``--param-quant`` and
    params on NVMe (item 8f) build on a data mesh, each rank's param specs
    its shards (half of every leaf the rules split)."""
    ex = texec.InfinityExecutor(run, "cpu", mesh=_fake_mesh(*mesh))
    if match is not None:
        assert ex.engine.mp.strategy == match
        return
    whole, mine = ex.engine.param_specs(whole=True), ex.engine.param_specs()
    for path in tpt.tree_paths(whole):
        n, m = (math.prod(tpt.tree_get(t, path).shape) for t in (whole, mine))
        split = tpt.tree_get(ex.engine.splits["param"], path) is not None
        assert m * (2 if split else 1) == n, path
    if what == "param_nvme":
        assert ex.total_param_bytes == sum(math.prod(s.shape) * s.dtype.itemsize
                                           for s in tpt.tree_leaves(mine))


BASE = ["--smoke", "--device", "cpu", "--engine", "pjit", "--steps", "1", "--batch", "2",
        "--seq", "16", "--ckpt-every", "0"]


class _Built(Exception):
    """Raised, with the engine's attention strategy, where a run on a fake
    mesh asks for its train step: it got past every refusal and built its
    executor."""


@pytest.mark.parametrize("extra,error,match", [
    (["--data-mesh", "1", "--model-mesh", "2", "--arch", "seamless-m4t-medium"],
     _Built, "^tp$"),
    (["--data-mesh", "2", "--arch", "granite-moe-1b-a400m", "--param-quant", "q4"],
     _Built, "^dp$"),
    (["--data-mesh", "2", "--offload-param", "nvme"], _Built, "^dp$"),
    (["--plan", "auto", "--hw-devices", "4", "--data-mesh", "2"], ValueError,
     "a plan for 4 device.*this run has 2")])
def test_cli_on_a_gspmd_mesh_refuses_naming_the_item(monkeypatch, tmp_path, extra, error, match):
    """``launch.train`` on a 2-rank mesh (a fake one: each refusal comes
    before the first collective). A plan for another number of devices
    raises. The encoder-decoder on a model axis (item 8g.4, ported), and
    ``--param-quant`` and params on NVMe on a data mesh (item 8f, ported),
    meet no refusal: each builds its executor and its state and asks for
    the train step, which the fake mesh stops before any collective."""
    monkeypatch.setattr(mesh_mod, "make_local_mesh", lambda d, m, dev: _fake_mesh(d, m))

    def make_train_step(self, **kw):
        raise _Built(self.engine.mp.strategy if self.engine.mp is not None else "dp")

    monkeypatch.setattr(texec.InfinityExecutor, "make_train_step", make_train_step)
    argv = BASE + ["--nvme-dir", str(tmp_path), "--ckpt-dir", str(tmp_path / "ck")] + extra
    with pytest.raises(error, match=match):
        ttrain.train(ttrain.build_argparser().parse_args(argv), argv)


def test_the_plan_sets_the_mesh_and_a_flag_overrides_it():
    ap = ttrain.build_argparser()
    assert ttrain.data_mesh(ap.parse_args(["--plan", "auto", "--hw-devices", "2"])) == 2
    assert ttrain.data_mesh(ap.parse_args(["--hw-devices", "2"])) == 1  # manual: no plan
    assert ttrain.data_mesh(ap.parse_args(["--plan", "auto", "--hw-devices", "2",
                                           "--data-mesh", "4"])) == 4
    assert ttrain.data_mesh(ap.parse_args([])) == 1


def test_rank_batch_splits_microbatches_or_replicates():
    """Rank r's rows: its ``rank_slice`` of each microbatch, so the ranks'
    local microbatch i is the global microbatch i; the whole batch where
    the rows do not split over dp x accum."""
    batch = {"tokens": np.arange(8 * 3, dtype=np.int32).reshape(8, 3)}
    for dp, accum in ((1, 1), (2, 1), (4, 1), (2, 2), (2, 4)):
        parts = [tpipe.rank_batch(batch, r, dp, accum)["tokens"] for r in range(dp)]
        for i in range(accum):
            micro = np.concatenate([p.reshape(accum, -1, 3)[i] for p in parts])
            np.testing.assert_array_equal(micro, batch["tokens"].reshape(accum, -1, 3)[i])
    for dp, accum in ((3, 1), (4, 4)):
        assert tpipe.rank_batch(batch, 1, dp, accum)["tokens"] is batch["tokens"]


def test_shards_tile_each_leaf_and_the_bridge_cuts_by_the_rules():
    """``shard_leaf`` over the ranks is the leaf again (``unshard_leaf``);
    ``shard_gspmd_state`` cuts the params by the param rules and Adam's
    state by the opt rules (stage 2: params whole, masters split)."""
    t = torch.arange(2 * 6 * 4, dtype=torch.float32).reshape(2, 6, 4)
    for dim in (None, 0, 1, 2):
        parts = 1 if dim is None else 2
        shards = [tpt.shard_leaf(t, dim, r, parts) for r in range(parts)]
        assert all(s.is_contiguous() for s in shards)
        assert torch.equal(tpt.unshard_leaf(shards, dim), t)
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        tpt.shard_leaf(t, 1, 0, 4)
    run = RunConfig(model=tconfigs.smoke("smollm-135m"),
                    parallel=make_parallel("pjit", zero_stage=2))
    eng = ZeroInfinityEngine(run, "cpu")
    state = eng.init_state(torch.Generator().manual_seed(0))
    shard = bridge.shard_gspmd_state(state, run, 1, 2)
    for path in tpt.tree_paths(state["params"]):
        assert torch.equal(tpt.tree_get(shard["params"], path),
                           tpt.tree_get(state["params"], path))
        dim = tpt.leaf_splits(eng.bundle.defs, run.model, {"data": 2, "model": 1},
                              run.parallel, "opt")
        assert torch.equal(tpt.tree_get(shard["opt"].master, path), tpt.shard_leaf(
            tpt.tree_get(state["opt"].master, path), tpt.tree_get(dim, path), 1, 2))
    assert bridge.shard_gspmd_state(state, run, 0, 1) is state


def test_one_rank_collectives_along_any_dim_are_the_identity():
    mesh = mesh_mod.make_local_mesh(1, 1, "cpu")
    t = torch.arange(12.0).reshape(3, 4)
    assert mesh.all_gather(t, 1) is t and mesh.reduce_scatter(t, 1) is t
    assert mesh.axis_sizes() == {"data": 1, "model": 1}


def test_a_rank_on_the_card_without_one_raises():
    """``make_local_mesh(..., "cuda")`` where CUDA is absent names it (it
    divided by the card count, 0, before); what ``profile_train`` meets on
    the CPU once its world size matches."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_mod.make_local_mesh(1, 1, "cuda")


def test_transformer_refuses_a_window_and_names_no_missing_item():
    """The dense/vlm module refuses a local window (no dense config sets
    one); the family check the registry made dead, and its citation of a
    ROADMAP item that no longer exists, are gone."""
    from repro_torch.models import transformer

    cfg = dataclasses.replace(tconfigs.smoke("smollm-135m"), window=8)
    with pytest.raises(NotImplementedError, match="local attention window") as err:
        transformer.make_fns(cfg)
    assert "ROADMAP" not in str(err.value)
    transformer.make_fns(tconfigs.smoke("llava-next-34b"))  # the vlm family builds
