"""MoE on the model axis: the port's GSPMD engine and ``launch.serve`` on
granite-moe's smoke config over ``data x model`` ranks, one process each
over ``torch.distributed`` (gloo, on the CPU), against the JAX package's
``InfinityExecutor(engine="pjit")`` and ``launch.serve`` on a mesh of as
many host devices; the rules and the expert-parallel partials on their
own.

* **The rules.** granite's leaves at (1, 2), (1, 3) and (1, 4), full and
  smoke, every state class and ZeRO stage: the port's spec is the
  reference's entry for entry (``experts`` on ``model`` where they divide,
  else ``mlp``; a mesh axis once per spec). Full granite's bytes a rank,
  the numbers the card's phases hold: 1,339,232,256 at (1, 2) and
  671,289,344 at (1, 4) under tensor parallelism, all 2,675,118,080 at
  (1, 3) under context parallelism (32 experts, 512 columns and 51,200
  vocab rows split over none).
* **The step on ranks.** The fixture saves the initial params (the
  reference bundle's init at one device), starts the reference
  (``tests/torch_dp_reference.py moe_tp``) and the port's ranks
  (``tests/torch_dp_worker.py moe_tp``, at 2, 3 and 4 ranks) together,
  and runs the port's one-rank baselines in this process meanwhile. Cases
  (``torch_dp_worker.MOE_TP_CASES``): tensor parallelism at (1, 2), (2, 2)
  and (1, 4), context parallelism at (1, 3) on 18 tokens. Held as
  ``tests/test_torch_dp_moe.py`` holds the GSPMD engine's MoE on data
  ranks: loss, grad norm and lr by ``TIER_TOL``; the routing statistics
  one value on every rank, no further from the reference's than the
  one-rank run is from the reference on one device, plus one assignment
  (so not ``M`` times the global batch's); the params joined from the
  ranks' shards and each rank's shard against XLA's addressable shard by
  the drift bound plus each side's bf16 rounding, their mean and the
  moments beyond the one-rank gap; the masters within the drift bound;
  each rank's state bytes its shards'. The router, whole on every rank,
  reaches the reference's params only with its gradient summed over the
  model ranks (each rank's gates see its experts alone).
* **Serving.** granite at (1, 2) (tensor parallelism: 4 experts a rank)
  and at (1, 3) (context parallelism: the prompt chunked, 4 cache
  positions a rank), held as ``tests/test_torch_cp_serve.py`` holds the
  dense families.
* **The partials.** Each model rank's part of ``moe_ffn`` (its experts'
  slots, or every expert's columns) summed over the ranks in the combine
  dtype equals the one-rank combine.
"""
import concurrent.futures
import dataclasses
import functools
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
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from test_torch_cp_serve import (TIMEOUT, check_forced_logits, check_kv_bytes,  # noqa: E402
                                 check_resident, check_tokens, finish_reference,
                                 save_serve_inits, start_reference)
from test_torch_dp_moe import _rel, _within  # noqa: E402
from test_torch_gspmd import MOMENT_REL, TIER_TOL  # noqa: E402
from test_torch_gspmd_mesh import _keystr, _np  # noqa: E402
from test_torch_tp import _whole  # noqa: E402

ARCH = "granite-moe-1b-a400m"
TRAIN = [c for c, spec in W.MOE_TP_CASES.items() if spec[1] > 1]
ONE_RANK = [c for c, spec in W.MOE_TP_CASES.items() if spec[1] == 1]
SERVE = list(W.MOE_SERVE_CASES)
STATES = ("param", "grad", "opt", "act")


# ---------------------------------------------------------------------------
# the rules and the bytes a rank
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _defs(smoke: bool):
    get = (lambda pkg: pkg.smoke(ARCH)) if smoke else (lambda pkg: pkg.get(ARCH))
    jcfg, tcfg = get(jconfigs), get(tconfigs)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return (jcfg, jreg.FAMILY_MODULES["moe"].param_defs(jcfg),
            tcfg, tmoe.param_defs(tcfg))


@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("for_state", STATES)
@pytest.mark.parametrize("M", [2, 3, 4])
@pytest.mark.parametrize("smoke", [False, True])
def test_rules_give_granites_leaves_the_references_specs(smoke, M, for_state, stage):
    """Every leaf's spec equals the reference's at (1, M), and the expert
    leaves put ``experts`` on ``model`` where E divides by M, else
    ``mlp`` where d_ff does, else nothing."""
    jcfg, jdefs, tcfg, tdefs = _defs(smoke)
    sizes = {"data": 1, "model": M}
    fake = types.SimpleNamespace(axis_names=("data", "model"), shape=sizes)
    jrules = jpt.make_rules(jcfg, fake, jmake_parallel("pjit", zero_stage=stage),
                            for_state=for_state)
    trules = tpt.make_rules(tcfg, sizes, make_parallel("pjit", zero_stage=stage),
                            for_state=for_state)
    jspecs = {jax.tree_util.keystr(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        jpt.spec_tree(jdefs, jrules),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    tspecs = tpt.spec_tree(tdefs, trules)
    for path in tpt.tree_paths(tspecs):
        assert tpt.tree_get(tspecs, path) == tuple(jspecs[_keystr(path)]), path
    w_in = tpt.split_axes(tpt.tree_get(tspecs, ("blocks", "moe", "w_in")), trules)
    E, f = tcfg.n_experts, tcfg.d_ff
    want = 1 if E % M == 0 else (3 if f % M == 0 else None)
    assert w_in.get("model") == want, (smoke, M, w_in)


def _fake_mesh(data=1, model=2, rank=0):
    return mesh_mod.LocalMesh(data, model, rank, data * model, torch.device("cpu"), None, "gloo")


def test_full_granites_bytes_a_rank():
    """Full granite-moe-1b-a400m's 2,675,118,080 param bytes: 1,339,232,256
    a rank at (1, 2) and 671,289,344 at (1, 4) (tensor parallelism: the
    experts, vocab, heads and KV heads split), all of them at (1, 3)
    (context parallelism, nothing divides by 3)."""
    run = RunConfig(model=tconfigs.get(ARCH), parallel=make_parallel("pjit"))
    assert ZeroInfinityEngine(run, "cpu").shard_bytes()["param_shard_bytes"] == 2_675_118_080
    got = {}
    for M in (2, 4, 3):
        eng = ZeroInfinityEngine(run, "cpu", mesh=_fake_mesh(1, M))
        got[M] = (eng.mp.strategy, eng.shard_bytes()["param_shard_bytes"])
    assert got == {2: ("tp", 1_339_232_256), 4: ("tp", 671_289_344), 3: ("cp", 2_675_118_080)}


def test_the_router_gradient_is_summed_over_the_model_ranks():
    """The router is whole on every model rank: its gradient is each
    rank's part (its gates through its experts, or under context
    parallelism its chunk) summed over them; the expert leaves' are the
    rank's own; nothing of MoE is gathered whole under context
    parallelism but the whole leaves."""
    router, w_in = ("blocks", "moe", "router"), ("blocks", "moe", "w_in")
    for M in (2, 4, 3):
        run = RunConfig(model=tconfigs.smoke(ARCH), parallel=make_parallel("pjit"))
        eng = ZeroInfinityEngine(run, "cpu", mesh=_fake_mesh(1, M))
        assert eng._partial_over_model(router), M
        assert eng._partial_over_model(w_in) == (M == 3), M  # whole at 3: its chunk's part
        assert eng._whole_over_model(w_in) is None
    cp2 = ZeroInfinityEngine(RunConfig(model=tconfigs.smoke(ARCH), parallel=make_parallel(
        "pjit", attn_strategy="cp")), "cpu", mesh=_fake_mesh(1, 2))
    assert cp2.mp.strategy == "cp" and tpt.tree_get(cp2.model_splits, w_in) == 1
    assert cp2._whole_over_model(w_in) is None and not cp2._partial_over_model(w_in)
    assert cp2._whole_over_model(("embed", "tok")) == 0 and cp2._partial_over_model(router)


def test_moe_on_a_mesh_passes_the_executors_check_and_nvme_params_still_raise_8f():
    """The GSPMD engine takes MoE on a model axis, and the SSM and the
    hybrid (8g.3) and the encoder-decoder (8g.4); since item 8f params on
    NVMe and ``--param-quant`` pass the check there too, for every family
    (``tests/test_torch_nvme_mesh.py`` runs them); only a plan for another
    number of devices than the ranks raises."""
    mk = lambda arch, **off: RunConfig(model=tconfigs.smoke(arch), parallel=make_parallel("pjit"),
                                       offload=make_offload(**off))
    for arch in (ARCH, "mamba2-370m", "recurrentgemma-9b", "seamless-m4t-medium"):
        texec.check_ported(mk(arch), dp=2)
    for arch in (ARCH, "seamless-m4t-medium"):
        for off in ({"param_tier": "nvme"}, {"param_quant": "q8"}):
            texec.check_ported(mk(arch, **off), dp=2)
            with pytest.raises(ValueError, match="a plan for 4 device"):
                texec.check_ported(mk(arch, **off), n_devices=4, dp=2)


# ---------------------------------------------------------------------------
# the expert-parallel partials
# ---------------------------------------------------------------------------


class _Rank:
    """A model rank under tensor parallelism whose ``join`` keeps the
    partial it is given: the ranks' partials are summed by hand."""

    tp, seq = True, False

    def __init__(self, rank, size):
        self.rank, self.size, self.partial = rank, size, None

    def enter(self, x):
        return x

    def join(self, y):
        self.partial = y
        return y


@pytest.mark.parametrize("M,dim", [(2, 0), (4, 0), (2, 3)])
def test_the_ranks_partials_summed_in_the_combine_dtype_are_moe_ffn(M, dim):
    """The smoke granite's layer: each rank's experts (``dim`` 0) or
    every expert's columns (``dim`` 3, the rules' fallback where the
    experts do not divide), its partial ``y`` in the combine dtype, summed
    over the ranks in that dtype, against the one-rank combine (before
    the cast): within the f32 sum's rounding for the experts, within the
    bf16 rounding of each rank's partial products for the columns; the
    one-rank ``moe_ffn`` is unchanged by a context without a split."""
    cfg = tconfigs.smoke(ARCH)
    gen = torch.Generator().manual_seed(5)
    defs = tmoe.moe_defs(cfg)
    p = {k: (torch.randn(d.shape, generator=gen) * 0.2).to(d.torch_dtype)
         for k, d in defs.items()}
    x = torch.randn(2, 16, cfg.d_model, generator=gen).to(torch.bfloat16)
    xg = tmoe._groups(x, tmoe.DEFAULT_GROUP)
    r = tmoe.route_tokens(p["router"], xg, cfg)
    want = tmoe._mix_and_combine(xg, p, r["tok_ec"], r["valid_ec"], r["w_ec"], r["inv"],
                                 cfg).reshape(x.shape)
    cdt = getattr(torch, cfg.moe_combine_dtype)
    total = torch.zeros(x.shape, dtype=cdt)
    for m in range(M):
        if dim == 0:
            mine = {k: v if k == "router" else tpt.shard_leaf(v, 0, m, M) for k, v in p.items()}
        else:  # the columns: w_in / w_gate (E, d, f) on f, w_out (E, f, d) on f
            mine = {k: v if k == "router" else tpt.shard_leaf(v, 1 if k == "w_out" else 2, m, M)
                    for k, v in p.items()}
        rank = _Rank(m, M)
        assert tmoe.model_split(mine, cfg)
        y = tmoe.moe_ffn(mine, x, cfg, mp=rank)
        assert rank.partial.dtype == cdt and y.dtype == x.dtype
        total = total + rank.partial
    # a rank's experts' outputs are whole products: the sum in f32 alone
    # rounds apart; a rank's columns give bf16 partial products (the
    # reference's psum of the column-parallel einsum is in bf16 too)
    tol = 1e-5 if dim == 0 else 2 ** -6
    assert (total.float() - want.float()).abs().max() <= tol * want.float().abs().max()
    assert torch.equal(tmoe.moe_ffn(p, x, cfg), tmoe.moe_ffn(p, x, cfg, mp=_Rank(0, 1)))


# ---------------------------------------------------------------------------
# training and serving on ranks against the reference on host devices
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's ``.npz``, per world size each rank's results, the
    port's one-rank baselines and the reference's serving params."""
    tmp = str(tmp_path_factory.mktemp("moe_tp"))
    params = jax.jit(jreg.build(W.gspmd_cfg(TRAIN[0], jconfigs)).init)(jax.random.PRNGKey(0))
    whole = bridge.params_from_numpy(jax.tree.map(np.asarray, params))
    for case in W.MOE_TP_CASES:
        torch.save(whole, W.gspmd_init_path(tmp, case))
    serve_params = save_serve_inits(tmp, SERVE)
    ref, path = start_reference(tmp, "moe_tp")
    try:
        worlds = sorted({D * M for D, M, *_ in W.MOE_TP_CASES.values() if M > 1})
        with concurrent.futures.ThreadPoolExecutor(len(worlds)) as pool:
            runs = {w: pool.submit(W.spawn, "moe_tp", w, tmp, TIMEOUT) for w in worlds}
            one_mesh = mesh_mod.make_local_mesh(1, 1, "cpu")
            one = {case: W.run_gspmd_case(case, tmp, one_mesh) for case in ONE_RANK}
            out = {w: f.result() for w, f in runs.items()}
        npz = finish_reference(ref, path)
    except BaseException:
        ref.kill()
        ref.communicate()
        raise
    yield types.SimpleNamespace(ref=npz, ranks=out, one=one, params=serve_params)


def _ranks(ranks, case) -> list:
    D, M = W.MOE_TP_CASES[case][:2]
    return [r[case] for r in ranks.ranks[D * M]]


def _baseline(case) -> str:
    return "moe_cp_dp1" if "_cp_" in case else "moe_tp_dp1"


def _one_assignment(case) -> float:
    """One routed assignment of a layer's global batch."""
    return 1.0 / (W.B * W.gspmd_seq(case) * tconfigs.smoke(ARCH).top_k) + 1e-6


def test_each_case_runs_the_references_strategy_and_split(ranks):
    """(1, 3) runs context parallelism with every leaf whole, the others
    tensor parallelism with the experts split over the model ranks."""
    for case in TRAIN:
        r = _ranks(ranks, case)[0]
        M = W.MOE_TP_CASES[case][1]
        assert r["strategy"] == ("cp" if M == 3 else "tp"), case
        split = tpt.tree_get(r["model_splits"], ("blocks", "moe", "w_in"))
        assert split == (None if M == 3 else 1), case


@pytest.mark.parametrize("step", range(W.GSPMD_STEPS))
@pytest.mark.parametrize("case", TRAIN)
def test_step_matches_reference_loss_grad_norm_lr_and_routing(ranks, case, step):
    """Loss, grad norm and lr (one value on every rank) against the
    reference's by ``TIER_TOL``; the routing statistics one value on every
    rank, within the one-rank gap plus one assignment of the reference's:
    the global batch's, not ``M`` times it (the load sums to 1)."""
    rs = _ranks(ranks, case)
    for key in ("loss", "grad_norm", "lr"):
        got = [r["metrics"][step][key] for r in rs]
        assert len(set(got)) == 1, (case, key, got)
        np.testing.assert_allclose(got[0], ranks.ref[f"{case}/{key}"][step], **TIER_TOL,
                                   err_msg=f"{case} {key}")
    base = _baseline(case)
    for key in ("moe_dropped_token_fraction", "moe_expert_load"):
        got = [np.asarray(r["metrics"][step][key], np.float64) for r in rs]
        assert all(np.array_equal(g, got[0]) for g in got), (case, key)
        gap = np.abs(np.asarray(ranks.one[base]["metrics"][step][key], np.float64)
                     - ranks.ref[f"{base}/{key}"][step])
        diff = np.abs(got[0] - ranks.ref[f"{case}/{key}"][step])
        assert (diff <= gap + _one_assignment(case)).all(), (case, key, step, diff, gap)
    load = np.asarray(rs[0]["metrics"][step]["moe_expert_load"])
    assert abs(load.sum() - 1.0) < 1e-6 and 0 <= rs[0]["metrics"][step][
        "moe_dropped_token_fraction"] < 1


@pytest.mark.parametrize("case", TRAIN)
def test_params_shards_and_optimizer_match_reference(ranks, case):
    """The params joined from the ranks' shards along both axes and each
    rank's shard against XLA's addressable shard on its device: the drift
    bound plus each side's bf16 rounding, every element; the masters
    within the drift bound; the params' mean gap and m and v over every
    leaf together no further than the one-rank run's gap beyond
    ``2^-5 * sum(lr)`` and ``MOMENT_REL``."""
    rs, base = _ranks(ranks, case), _baseline(case)
    one = ranks.one[base]
    lrs = list(ranks.ref[f"{case}/lr"])
    drift = tadam.parity_bound(W._gspmd_run(case, "").train, lrs)
    paths = tpt.tree_paths(rs[0]["params"])
    for path in paths:
        name = _keystr(path)
        got = _whole(rs, lambda r: r["params"], "param", path)
        want = ranks.ref[f"{case}/params/{name}"]
        assert got.shape == want.shape, (case, path)
        _within(got, want, drift, (case, path))
        for rank, r in enumerate(rs):
            got = _np(tpt.tree_get(r["params"], path))
            want = ranks.ref[f"{case}/params_shard{rank}/{name}"]
            assert got.shape == want.shape, (case, rank, path, got.shape, want.shape)
            _within(got, want, drift, (case, rank, path))
            master = _np(tpt.tree_get(r["opt"][1], path))
            want = ranks.ref[f"{case}/master_shard{rank}/{name}"]
            assert master.shape == want.shape and np.abs(master - want).max() <= drift
    joined = [np.concatenate([x.reshape(-1) for x in parts]) for parts in (
        [_whole(rs, lambda r: r["params"], "param", p) for p in paths],
        [ranks.ref[f"{case}/params/{_keystr(p)}"] for p in paths],
        [_np(tpt.tree_get(one["params"], p)) for p in paths],
        [ranks.ref[f"{base}/params/{_keystr(p)}"] for p in paths])]
    mean, gap = np.abs(joined[0] - joined[1]).mean(), np.abs(joined[2] - joined[3]).mean()
    assert mean <= gap + 2**-5 * sum(lrs), (case, mean, gap)
    for i, moment in ((2, "m"), (3, "v")):
        joined = [np.concatenate([x.reshape(-1) for x in parts]) for parts in (
            [_whole(rs, lambda r: r["opt"][i], "opt", p) for p in paths],
            [ranks.ref[f"{case}/{moment}/{_keystr(p)}"] for p in paths],
            [_np(tpt.tree_get(one["opt"][i], p)) for p in paths],
            [ranks.ref[f"{base}/{moment}/{_keystr(p)}"] for p in paths])]
        rel, gap = _rel(joined[0], joined[1]), _rel(joined[2], joined[3])
        assert rel <= gap + MOMENT_REL, (case, moment, rel, gap)
    assert all(int(r["opt"][0]) == W.GSPMD_STEPS for r in rs)


@pytest.mark.parametrize("case", TRAIN)
def test_rank_bytes_are_the_shards(ranks, case):
    """Each rank's state bytes are its shards' (``shard_bytes``), their sum
    the same on every rank."""
    rs = _ranks(ranks, case)
    for step in range(W.GSPMD_STEPS):
        for key in ("param_shard_bytes", "grad_shard_bytes", "opt_shard_bytes"):
            mine = [r["metrics"][step][key] for r in rs]
            assert all(m == r["shard_bytes"][key] for m, r in zip(mine, rs)), (case, key)
            assert all(r["metrics"][step][f"{key}_all_ranks"] == sum(mine) for r in rs)


def _serve_ranks(ranks, case) -> list:
    return [r[case] for r in ranks.ranks[W.MOE_SERVE_CASES[case][0]]]


@pytest.mark.parametrize("case", SERVE)
def test_serving_tokens_equal_the_references_or_part_at_a_near_tie(ranks, case):
    check_tokens(ranks.ref, _serve_ranks(ranks, case), case, ranks.params[case])


@pytest.mark.parametrize("case", SERVE)
def test_serving_teacher_forced_logits_match_the_reference(ranks, case):
    check_forced_logits(_serve_ranks(ranks, case), case, ranks.params[case])


@pytest.mark.parametrize("case", SERVE)
def test_serving_kv_bytes_and_resident_shares(ranks, case):
    """The ``kv`` counters summed over the ranks are the reference's (the
    KV heads split over 2 under tensor parallelism; the cache positions
    over 3 under context parallelism); each rank holds ``1/M`` of the
    resident K/V; each rank's param bytes are ``shard_bytes``'."""
    rs = _serve_ranks(ranks, case)
    check_kv_bytes(ranks.ref, rs, case)
    msh = rs[0]["mesh"]
    assert msh["strategy"] == ("cp" if msh["model"] == 3 else "tp")
    if msh["strategy"] == "cp":
        check_resident(ranks.ref, rs, case)
    else:  # the KV heads split: the rank's share of each slot's cache
        want = int(ranks.ref[f"{case}/kv/resident_bytes"]) - 2 * 4
        for rank, kr in enumerate(rs[0]["kv_ranks"]):
            assert (kr["resident_bytes"] - (8 if rank == 0 else 0)) * msh["model"] == want
    for rank, r in enumerate(rs):
        assert r["param_shard_bytes"][rank] == r["shard_bytes"]
        assert r["gather"]["equal"], (case, rank)
