"""Tensor and context parallelism: the port's GSPMD engine on a ``data x
model`` mesh of ranks, one process each over ``torch.distributed`` (gloo,
on the CPU), against the JAX package's ``InfinityExecutor(engine="pjit")``
on a mesh of as many host devices.

* **The rules.** For every config of ``repro/configs`` on the (1, 2),
  (1, 4) and (2, 2) meshes, each state class and ZeRO stages 0-3: the
  port's ``spec_tree`` gives each leaf the reference's ``PartitionSpec``
  entry for entry, and ``split_axes`` the dim each axis of more than one
  rank splits in it (a leaf may be cut along two dims).
* **The step on ranks.** The fixture saves each case's initial params
  (the reference bundle's init at one device), then starts the reference
  (``tests/torch_dp_reference.py tp``: one subprocess with four host
  devices, every case of ``torch_dp_worker.TP_CASES`` on its mesh) and the
  port's ranks (``tests/torch_dp_worker.py tp``: 2 ranks for the
  two-rank meshes, 4 for the others) together. Both sides start from those
  params (each rank its shards along both axes, ``bridge.
  shard_gspmd_state``) on the same global batches (each data row its rows,
  every model rank of it the same), for ``GSPMD_STEPS`` steps. Cases:
  llama under tensor parallelism at (1, 2) (the KV heads split), (1, 4)
  (they do not: each rank its query head's) and ZeRO-3 at (2, 2) (2-D
  shards: ``wq`` cut on ``embed`` over data and ``heads`` over model);
  smollm under context parallelism (3 heads over 2 model ranks) at (1, 2)
  and (2, 2); llava under tensor (1, 4) and context (1, 2, forced)
  parallelism (its first chunk all vision positions: no label); gemma
  (1, 2) and nemotron (1, 4: layer norm, relu2, untied unembedding);
  stages 0-2, the host tier, the optimizer on NVMe off-graph and two
  microbatches once each.
* **Refusals and units.** The other families build on a model axis (item
  8g is ported); what the port does not lay out raises; the model axis'
  autograd functions against the ranks' draws combined by hand.

Tolerances are ``tests/test_torch_gspmd.py``'s, imported from it, none
loosened: ``TIER_TOL`` for loss, grad norm and lr each step; the drift
bound of two AdamW runs plus each side's bf16 rounding for the params (the
mean by 2^-5 * sum(lr)); the drift bound for the f32 masters; ``MOMENT_REL``
for m and v. Each rank's shard is held to the same bounds against the
reference's addressable shard on device r (rank r at data r // M, model r
% M: the reference's device order), and each rank's state bytes equal
``shard_bytes``.
"""
import concurrent.futures
import dataclasses
import functools
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
from repro.config import make_parallel as jmake_parallel  # noqa: E402
from repro.core import partition as jpt  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import RunConfig, make_offload, make_parallel  # noqa: E402
from repro_torch.core import executor as texec  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core.engine import ZeroInfinityEngine  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from test_torch_gspmd import MOMENT_REL, TIER_TOL  # noqa: E402
from test_torch_gspmd_mesh import _keystr, _np, _params_within  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = list(W.TP_CASES)
ARCHS = sorted(jconfigs._MODULES)
STATES = ("param", "grad", "opt", "act")
MESHES = ((1, 2), (1, 4), (2, 2))
TIMEOUT = 300.0


# ---------------------------------------------------------------------------
# the rules against the reference's, per leaf, on a model axis
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _defs(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return (jcfg, jreg.FAMILY_MODULES[jcfg.family].param_defs(jcfg),
            tcfg, treg.FAMILY_MODULES[tcfg.family].param_defs(tcfg))


@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("for_state", STATES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_give_each_leaf_the_references_spec_on_a_model_axis(arch, mesh, for_state,
                                                                    stage):
    """Every leaf's spec equals the reference's on a ``data x model``
    mesh, and ``split_axes`` is ``{axis: dim}`` for each axis of more
    than one rank that spec names (none where the guard leaves a dim
    whole)."""
    jcfg, jdefs, tcfg, tdefs = _defs(arch)
    sizes = {"data": mesh[0], "model": mesh[1]}
    fake_mesh = types.SimpleNamespace(axis_names=("data", "model"), shape=sizes)
    jrules = jpt.make_rules(jcfg, fake_mesh, jmake_parallel("pjit", zero_stage=stage),
                            for_state=for_state)
    trules = tpt.make_rules(tcfg, sizes, make_parallel("pjit", zero_stage=stage),
                            for_state=for_state)
    jspecs = {jax.tree_util.keystr(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        jpt.spec_tree(jdefs, jrules), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    tspecs = tpt.spec_tree(tdefs, trules)
    on_model = 0
    for path in tpt.tree_paths(tspecs):
        want = tuple(jspecs[_keystr(path)])
        got = tpt.tree_get(tspecs, path)
        assert got == want, (path, got, want)
        axes = {a: i for i, e in enumerate(want) if e is not None
                for a in ((e,) if isinstance(e, str) else e) if sizes[a] > 1}
        assert tpt.split_axes(got, trules) == axes, path
        on_model += "model" in axes
    assert on_model, (arch, mesh)  # every config splits something over the model axis


# ---------------------------------------------------------------------------
# the step on a data x model mesh against the reference on host devices
# ---------------------------------------------------------------------------


def _save_inits(tmp: str) -> None:
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
    tmp = str(tmp_path_factory.mktemp("tp_mesh"))
    ref_path = os.path.join(tmp, "ref.npz")
    _save_inits(tmp)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    ref = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dp_reference.py"),
                            tmp, ref_path, "tp"], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = {world: pool.submit(W.spawn, "tp", world, tmp, TIMEOUT) for world in (2, 4)}
            out = {world: f.result() for world, f in runs.items()}
        log, _ = ref.communicate(timeout=TIMEOUT)
    except BaseException:
        ref.kill()
        ref.communicate()
        raise
    assert ref.returncode == 0, log[-4000:]
    yield types.SimpleNamespace(ref=dict(np.load(ref_path)), ranks=out, tmp=tmp)


def _ranks(ranks, case):
    D, M = W.TP_CASES[case][:2]
    return [r[case] for r in ranks.ranks[D * M]]


def _lrs(ranks, case):
    return list(ranks.ref[f"{case}/lr"])


def _drift(ranks, case) -> float:
    return tadam.parity_bound(W._gspmd_run(case, "").train, _lrs(ranks, case))


def _whole(rs, tree, cls, path) -> np.ndarray:
    """A leaf joined from every rank's shard of it (``tree`` picks the
    rank's tree from its record)."""
    r0 = rs[0]
    dims = {"data": tpt.tree_get(r0["splits"][cls], path),
            "model": tpt.tree_get(r0["model_splits"], path)}
    return _np(tpt.join_leaf([tpt.tree_get(tree(r), path) for r in rs], dims, r0["sizes"]))


def test_each_case_runs_the_references_strategy(ranks):
    """The strategy every rank ran is ``choose_attn_strategy``'s on the
    reference's mesh, and the cases cover both with 2-D shards among
    them."""
    seen = set()
    for case in CASES:
        D, M, *_, strategy = W.TP_CASES[case]
        cfg = W.gspmd_cfg(case, jconfigs)
        want = jpt.choose_attn_strategy(
            cfg, types.SimpleNamespace(shape={"data": D, "model": M}),
            jmake_parallel("pjit", attn_strategy=strategy))
        assert all(r["strategy"] == want for r in _ranks(ranks, case)), case
        seen.add(want)
    assert seen == {"tp", "cp"}
    two_d = _ranks(ranks, "llama_tp_2x2")[0]
    assert (tpt.tree_get(two_d["splits"]["param"], ("blocks", "attn", "wq")),
            tpt.tree_get(two_d["model_splits"], ("blocks", "attn", "wq"))) == (1, 2)


@pytest.mark.parametrize("step", range(W.GSPMD_STEPS))
@pytest.mark.parametrize("case", CASES)
def test_step_matches_reference_loss_grad_norm_and_lr(ranks, case, step):
    """Loss and grad norm (one value on every rank) and the lr against the
    reference's global step by ``TIER_TOL``."""
    rs = _ranks(ranks, case)
    for key in ("loss", "grad_norm", "lr"):
        got = [r["metrics"][step][key] for r in rs]
        assert len(set(got)) == 1, (case, key, got)
        np.testing.assert_allclose(got[0], ranks.ref[f"{case}/{key}"][step], **TIER_TOL,
                                   err_msg=f"{case} {key}")


@pytest.mark.parametrize("case", CASES)
def test_params_after_last_step_match_reference(ranks, case):
    """The ranks' param shards joined along both axes against the
    reference's global params."""
    rs = _ranks(ranks, case)
    drift, lrs = _drift(ranks, case), _lrs(ranks, case)
    for path in tpt.tree_paths(rs[0]["params"]):
        got = _whole(rs, lambda r: r["params"], "param", path)
        want = ranks.ref[f"{case}/params/{_keystr(path)}"]
        assert got.shape == want.shape, (path, got.shape, want.shape)
        _params_within(got, want, drift, lrs, (case, path))


@pytest.mark.parametrize("case", CASES)
def test_optimizer_states_match_reference(ranks, case):
    """In-graph: the step count, the masters joined within the drift
    bound, m and v within ``MOMENT_REL`` in norm; off-graph: no optimizer
    in the state on either side."""
    rs = _ranks(ranks, case)
    if "opt" not in rs[0]:
        assert W._gspmd_run(case, "").opt_offgraph
        assert f"{case}/step" not in ranks.ref
        return
    drift = _drift(ranks, case)
    assert all(int(r["opt"][0]) == W.GSPMD_STEPS for r in rs)
    assert int(ranks.ref[f"{case}/step"]) == W.GSPMD_STEPS
    for path in tpt.tree_paths(rs[0]["opt"][1]):
        name = _keystr(path)
        master = _whole(rs, lambda r: r["opt"][1], "opt", path)
        assert np.abs(master - ranks.ref[f"{case}/master/{name}"]).max() <= drift, (case, path)
        for i, moment in ((2, "m"), (3, "v")):
            got = _whole(rs, lambda r: r["opt"][i], "opt", path)
            want = ranks.ref[f"{case}/{moment}/{name}"]
            rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
            assert rel <= MOMENT_REL, (case, path, moment, rel)


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_the_references_shard(ranks, case):
    """Rank r's param shard (and in-graph master shard) has the shape of
    the reference's addressable shard on the mesh's r-th device and its
    values within the same bounds: the port cuts each leaf where XLA
    does, along both axes."""
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
def test_rank_bytes_and_the_tier_counters(ranks, case):
    """Each rank's state bytes are its shards' (``shard_bytes``), summed
    over the ranks in ``<counter>_all_ranks``; a tier counter summed over
    the ranks is the reference's scaled by the ranks' share of the
    optimizer's elements (the leaves whole over the model axis are on
    every model rank); the opt store's keys the reference's under each
    rank's prefix."""
    rs = _ranks(ranks, case)
    n = len(rs)
    opt_share = (sum(r["shard_bytes"]["opt_shard_bytes"] for r in rs),
                 ZeroInfinityEngine(W._gspmd_run(case, ""), "cpu").shard_bytes()[
                     "opt_shard_bytes"])
    for step in range(W.GSPMD_STEPS):
        ms = [r["metrics"][step] for r in rs]
        for key in ("param_shard_bytes", "grad_shard_bytes", "opt_shard_bytes"):
            if key == "opt_shard_bytes" and "opt" not in rs[0]:
                assert key not in ms[0]
                continue
            assert all(m[key] == r["shard_bytes"][key] for m, r in zip(ms, rs)), (case, key)
            assert all(m[f"{key}_all_ranks"] == sum(x[key] for x in ms) for m in ms)
        keys = sorted(k[len(f"{case}/ctr/"):] for k in ranks.ref if k.startswith(f"{case}/ctr/"))
        for key in keys:
            mine = [m[key] for m in ms]
            want = int(ranks.ref[f"{case}/ctr/{key}"][step])
            if "peak" not in key:
                assert sum(mine) * opt_share[1] == want * opt_share[0], (case, step, key)
    if f"{case}/opt_keys" in ranks.ref:
        want = list(ranks.ref[f"{case}/opt_keys"])
        assert want and len(rs) == n
        for rank, r in enumerate(rs):
            assert r["opt_keys"] == sorted(f"rank{rank}/{k}" for k in want)


def test_full_smollm_bytes_a_rank_under_tp3_and_cp2():
    """Full smollm-135m's 269,100,288 param bytes: 89,793,792 a rank at
    (1, 3) (tensor parallelism: every leaf but the f32 norms a third) and
    161,162,496 at (1, 2) (context parallelism: the attention weights and
    norms, 53,224,704 bytes, whole; the MLP and vocab halved)."""
    run = RunConfig(model=tconfigs.get("smollm-135m"), parallel=make_parallel("pjit"))
    one = ZeroInfinityEngine(run, "cpu").shard_bytes()["param_shard_bytes"]
    assert one == 269_100_288
    got = {}
    for M in (3, 2):
        eng = ZeroInfinityEngine(run, "cpu", mesh=_fake_mesh(1, M))
        got[M] = (eng.mp.strategy, eng.shard_bytes()["param_shard_bytes"])
        whole = sum(2 * np.prod(d.shape) if d.dtype == "bfloat16" else 4 * np.prod(d.shape)
                    for p, d in zip(tpt.tree_paths(eng.bundle.defs),
                                    tpt.tree_leaves(eng.bundle.defs))
                    if tpt.tree_get(eng.model_splits, p) is None)
        if M == 2:
            assert whole == 53_224_704
    assert got == {3: ("tp", 89_793_792), 2: ("cp", 161_162_496)}


def test_model_axis_functions_against_the_ranks_draws(ranks):
    """``enter``: the identity, its backward the ranks' cotangents summed;
    ``join``: the sum, backward the identity; ``gather`` along dim 1:
    the concatenation, backward the sum of the ranks' cotangents' parts
    on this rank's columns; bit for bit, in bf16."""
    for r in ranks.ranks[2]:
        u = r["model_axis"]
        for key in ("entered", "gx", "joined", "gy", "gathered", "gs"):
            assert u[key].dtype == torch.bfloat16 and torch.equal(u[key], u[f"want_{key}"]), key


# ---------------------------------------------------------------------------
# what raises, and the pieces without a process group
# ---------------------------------------------------------------------------


def _fake_mesh(data=1, model=2, rank=0):
    """A rank's mesh with no process group: enough for what the engine
    decides before the first collective."""
    return mesh_mod.LocalMesh(data, model, rank, data * model, torch.device("cpu"), None, "gloo")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-370m", "recurrentgemma-9b",
                                  "seamless-m4t-medium"])
def test_other_families_on_a_model_axis_raise_naming_item_8g(arch):
    """No family on a model axis raises any longer: item 8g is ported.
    MoE's experts (``tests/test_torch_moe_tp.py``): granite builds, its
    experts split over the model ranks under tensor parallelism; the SSM's
    and the hybrid's ``inner`` channels (``tests/test_torch_recurrent_
    tp.py``): mamba2 builds under context parallelism, recurrentgemma
    under tensor parallelism, each with its ``inner`` leaves split; the
    encoder-decoder (``tests/test_torch_encdec_tp.py``): seamless builds
    under tensor parallelism, its cross-attention's K/V heads split. The
    executor builds on the mesh too."""
    run = RunConfig(model=tconfigs.smoke(arch), parallel=make_parallel("pjit"),
                    offload=make_offload())
    split = {"granite-moe-1b-a400m": ("tp", ("blocks", "moe", "w_in"), 1),
             "mamba2-370m": ("cp", ("blocks", "w_x"), 2),
             "recurrentgemma-9b": ("tp", ("groups", "rec1", "w_in"), 2),
             "seamless-m4t-medium": ("tp", ("dec", "cross_attn", "wk"), 2)}
    strategy, leaf, dim = split[arch]
    texec.check_ported(run, dp=2)
    for eng in (ZeroInfinityEngine(run, "cpu", mesh=_fake_mesh()),
                texec.InfinityExecutor(run, "cpu", mesh=_fake_mesh()).engine):
        assert eng.mp.strategy == strategy
        assert tpt.tree_get(eng.model_splits, leaf) == dim


class _Built(Exception):
    """Raised where a run on a fake mesh asks for its train step: it got
    past every refusal and built its executor."""


def test_the_cli_trains_a_model_axis_and_refuses_8g(monkeypatch, tmp_path):
    """``launch.train --model-mesh 2`` on a fake two-rank mesh takes the
    encdec family (item 8g.4 is ported): it builds its executor under
    tensor parallelism and asks for the train step, which the fake mesh
    stops before any collective; the plan's devices cover both axes
    (``data_mesh``: ``--hw-devices`` over ``--model-mesh``)."""
    monkeypatch.setattr(mesh_mod, "make_local_mesh", lambda d, m, dev: _fake_mesh(d, m))
    built = []

    def make_train_step(self, **kw):
        built.append(self.engine.mp.strategy)
        raise _Built

    monkeypatch.setattr(texec.InfinityExecutor, "make_train_step", make_train_step)
    argv = ["--smoke", "--device", "cpu", "--engine", "pjit", "--arch", "seamless-m4t-medium",
            "--model-mesh", "2", "--steps", "1", "--batch", "2", "--seq", "16",
            "--ckpt-every", "0", "--nvme-dir", str(tmp_path)]
    with pytest.raises(_Built):
        ttrain.train(ttrain.build_argparser().parse_args(argv), argv)
    assert built == ["tp"]
    ap = ttrain.build_argparser()
    assert ttrain.data_mesh(ap.parse_args(["--plan", "auto", "--hw-devices", "4",
                                           "--model-mesh", "2"])) == 2


def test_what_the_port_does_not_lay_out_raises():
    """Tensor parallelism forced where the heads do not split, ``pure_dp``
    with a model axis, and a context-parallel sequence that does not split
    over the model ranks."""
    smollm = tconfigs.smoke("smollm-135m")
    with pytest.raises(ValueError, match="3 heads do not split over 2"):
        ZeroInfinityEngine(RunConfig(model=smollm, parallel=make_parallel(
            "pjit", attn_strategy="tp")), "cpu", mesh=_fake_mesh())
    with pytest.raises(NotImplementedError, match="pure_dp"):
        ZeroInfinityEngine(RunConfig(model=smollm, parallel=make_parallel(
            "pjit", pure_dp=True)), "cpu", mesh=_fake_mesh())
    eng = ZeroInfinityEngine(RunConfig(model=smollm, parallel=make_parallel("pjit")), "cpu",
                             mesh=_fake_mesh())
    assert eng.mp.strategy == "cp"
    batch = {"tokens": torch.zeros((1, 15), dtype=torch.int32),
             "labels": torch.zeros((1, 15), dtype=torch.int32)}
    params = tpt.tree_map(lambda d: torch.zeros(d.shape), eng.bundle.defs)
    with pytest.raises(ValueError, match="15 positions does not split over 2"):
        eng.bundle.loss(params, batch)


@pytest.mark.parametrize("heads,kv,size,want", [
    (4, 2, 4, [(0, 1), (0, 1), (1, 2), (1, 2)]),  # llama / llava smoke at M = 4
    (8, 2, 4, [(0, 1), (0, 1), (1, 2), (1, 2)]),  # nemotron smoke
    (3, 1, 3, [(0, 1)] * 3),  # smollm smoke at M = 3
    (8, 4, 2, [(0, 2), (2, 4)])])  # KV heads that split
def test_each_tp_rank_keeps_the_kv_heads_its_query_heads_read(heads, kv, size, want):
    """``tp_kv_heads``: rank m's query heads ``[m * H/M, (m+1) * H/M)``
    read KV heads ``h // (H/KV)``; the rank keeps that range, and the
    cache (``local_kv_heads``) holds as many."""
    got = [tcm.tp_kv_heads(heads, kv, size, m) for m in range(size)]
    assert got == want
    cfg = dataclasses.replace(tconfigs.smoke("llama3.2-3b"), n_heads=heads, n_kv_heads=kv)
    for m, (lo, hi) in enumerate(want):
        mp = types.SimpleNamespace(tp=True, size=size, rank=m)
        assert ttf.local_kv_heads(cfg, mp) == hi - lo


def test_uneven_kv_grouping_raises():
    """6 query heads on 3 KV heads over 2 model ranks: rank 0's heads 0-2
    read KV heads 0, 0 and 1, two and one, which the flash kernel's even
    GQA groups cannot hold (no config here has such a split)."""
    with pytest.raises(ValueError, match="do not group evenly"):
        tcm.tp_kv_heads(6, 3, 2, 0)


def test_cut_and_join_tile_a_leaf_over_both_axes():
    """``cut_leaf`` at every coordinate of a (2, 3) mesh and ``join_leaf``
    of the cuts in rank order give the leaf back; the cut is the
    reference's: data's part along its dim, model's along its own."""
    t = torch.arange(4 * 6 * 5, dtype=torch.float32).reshape(4, 6, 5)
    sizes = {"data": 2, "model": 3}
    for dims in ({"data": 0, "model": 1}, {"data": None, "model": 1}, {"data": 0},
                 {"data": None, "model": None}):
        cuts = [tpt.cut_leaf(t, dims, {"data": r // 3, "model": r % 3}, sizes)
                for r in range(6)]
        assert torch.equal(tpt.join_leaf(cuts, dims, sizes), t)
    cut = tpt.cut_leaf(t, {"data": 0, "model": 1}, {"data": 1, "model": 2}, sizes)
    assert torch.equal(cut, t[2:4, 4:6])


def test_a_rank_sits_at_the_references_device_coordinates():
    """Rank r of a (D, M) mesh at data r // M, model r % M; a one-rank
    axis's collectives are the identity."""
    for r in range(6):
        assert _fake_mesh(2, 3, r).coords() == {"data": r // 3, "model": r % 3}
    mesh = mesh_mod.make_local_mesh(1, 1, "cpu")
    t = torch.arange(6.0).reshape(2, 3)
    for axis in (None, "data", "model"):
        assert mesh.all_gather(t, 1, axis) is t and mesh.reduce_scatter(t, 1, axis) is t
        assert mesh.all_reduce(t, axis, op="max") is t
