"""The SSM's and the hybrid's ``inner`` channels on the model axis: the
port's GSPMD engine and ``launch.serve`` on mamba2's and recurrentgemma's
smoke configs over ``data x model`` ranks, one process each over
``torch.distributed`` (gloo, on the CPU), against the JAX package's
``InfinityExecutor(engine="pjit")`` and ``launch.serve`` on a mesh of as
many host devices; the model-axis sum, the split RMS norm and the
divisibility guard on their own.

* **The layout.** Both families build on a model axis at 2, 3 and 4
  ranks, full and smoke: ``inner`` on ``model`` where it divides (the
  reference's rule), those leaves never gathered whole (context
  parallelism gathers the sequence instead), mamba2's ``state`` leaves
  partial over the model ranks under tensor parallelism where ``inner``
  splits. Full mamba2-370m's and recurrentgemma-9b's bytes a rank, the
  numbers the card's phases hold.
* **The step on ranks.** The fixture saves each case's initial params (the
  reference bundle's init at one device), starts the reference
  (``tests/torch_dp_reference.py recurrent_tp``: one subprocess, every
  case) and the port's ranks (``tests/torch_dp_worker.py recurrent_tp``,
  at 2, 3 and 4 ranks) together. Cases (``torch_dp_worker.
  RECURRENT_TP_CASES``): mamba2 under context parallelism at (1, 2),
  (2, 2) and (1, 4) and under tensor parallelism forced at (1, 2);
  recurrentgemma under tensor parallelism at (1, 2) and (2, 2), under
  context parallelism at (1, 3) (``inner`` whole) and forced at (1, 2)
  with a window of 4 under its 8-token chunks. Held as ``tests/
  test_torch_tp.py`` holds the dense families, by ``tests/
  test_torch_gspmd.py``'s tolerances, imported: loss,
  grad norm and lr by ``TIER_TOL``; the params joined from the ranks'
  shards and each rank's shard against XLA's addressable shard by the
  drift bound plus each side's bf16 rounding (the mean by 2^-5 *
  sum(lr)); the masters within the drift bound; m and v within
  ``MOMENT_REL`` (mamba2's ``state`` leaves' within it plus the
  reference's own drift between its mesh run and its one-device run);
  each rank's state bytes ``shard_bytes``' exactly.
* **Serving.** Each family at (1, 2) under its ``auto`` strategy and the
  other forced (``torch_dp_worker.SERVE_STRATEGY``, in each side's
  ``ParallelConfig``): the tokens (equal, or parting at a
  near-tie, ``tests/test_torch_cp_serve.py``'s rule); the teacher-forced
  prefill and decode logits against the reference bundle's on one device
  by ``LOGIT_TOL``; the ``kv`` counters: each rank's parked and resident
  bytes its share of the reference's by its cache's bytes a sequence
  (the ``inner`` leaves split, mamba2's ``conv_B`` / ``conv_C`` and the
  hybrid's rings whole on each rank), so the ranks' sum is the
  reference's plus the whole leaves once more a model rank; each rank's
  param bytes ``shard_bytes``' and its view of a layer the model shard
  of the whole layer (its ``inner`` leaves its own).
"""
import concurrent.futures
import dataclasses
import math
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
from repro_torch.config import ParallelConfig, RunConfig, make_parallel  # noqa: E402
from repro_torch.core import kvcache  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core.engine import ZeroInfinityEngine  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from test_torch_cp_serve import (TIMEOUT, check_forced_logits, check_tokens,  # noqa: E402
                                 finish_reference, save_serve_inits, start_reference)
from test_torch_gspmd import MOMENT_REL, TIER_TOL  # noqa: E402
from test_torch_gspmd_mesh import _keystr, _np, _params_within  # noqa: E402
from test_torch_serve_mesh import KV_KEYS  # noqa: E402
from test_torch_tp import _whole  # noqa: E402
from test_torch_tp_serve import LEN_BYTES  # noqa: E402

SSM, HYBRID = "mamba2-370m", "recurrentgemma-9b"
TRAIN = [c for c, spec in W.RECURRENT_TP_CASES.items() if spec[1] > 1]
SERVE = list(W.RECURRENT_SERVE_CASES)


def _fake_mesh(data=1, model=2, rank=0):
    """A rank's mesh with no process group: enough for what the engine
    decides before the first collective."""
    return mesh_mod.LocalMesh(data, model, rank, data * model, torch.device("cpu"), None, "gloo")


def _engine(cfg, M, strategy="auto", rank=0):
    run = RunConfig(model=cfg, parallel=make_parallel("pjit", attn_strategy=strategy))
    return ZeroInfinityEngine(run, "cpu", mesh=_fake_mesh(1, M, rank))


def _inner_paths(eng) -> list:
    return [p for p, d in zip(tpt.tree_paths(eng.bundle.defs), tpt.tree_leaves(eng.bundle.defs))
            if "inner" in d.axes]


# ---------------------------------------------------------------------------
# the layout: inner on model, never gathered whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [2, 3, 4])
@pytest.mark.parametrize("arch", [SSM, HYBRID])
@pytest.mark.parametrize("smoke", [True, False])
def test_the_engine_builds_and_splits_inner_where_it_divides(smoke, arch, M):
    """The engine takes both families on a model axis: the strategy is the
    reference's ``choose_attn_strategy``'s, every ``inner`` leaf is split
    over the model ranks exactly where its dim divides by M (the
    reference's spec) and is never gathered whole; under context
    parallelism every whole leaf is partial over the model ranks, under
    tensor parallelism mamba2's ``state`` leaves are where ``inner``
    splits."""
    cfg = (tconfigs.smoke if smoke else tconfigs.get)(arch)
    eng = _engine(cfg, M)
    jcfg = (jconfigs.smoke if smoke else jconfigs.get)(arch)
    want = jpt.choose_attn_strategy(jcfg, types.SimpleNamespace(shape={"data": 1, "model": M}),
                                    jmake_parallel("pjit"))
    assert eng.mp.strategy == want
    paths = _inner_paths(eng)
    assert paths
    assert eng.mp.inner == (M != 3)  # where inner divides
    for path in paths:
        d = tpt.tree_get(eng.bundle.defs, path)
        dim = d.axes.index("inner")
        assert tpt.tree_get(eng.model_splits, path) == (dim if d.shape[dim] % M == 0 else None)
        assert eng._whole_over_model(path) is None, path
    for path in tpt.tree_paths(eng.bundle.defs):
        if tpt.tree_get(eng.model_splits, path) is None and eng.mp.strategy == "cp":
            assert eng._partial_over_model(path), path
    if arch == SSM:
        tp = _engine(cfg, M, "tp")
        split = tpt.tree_get(tp.model_splits, ("blocks", "w_x")) is not None
        assert split == (M != 3)
        for leaf in ("w_B", "w_C", "conv_B", "conv_C"):
            assert tp._partial_over_model(("blocks", leaf)) == split, (leaf, M)
        assert not tp._partial_over_model(("blocks", "ln", "scale"))


def test_full_models_bytes_a_rank():
    """Full mamba2-370m's 739,530,752 param bytes at (1, 2) under context
    parallelism: 382,546,944 a rank, its ``inner`` leaves and vocab rows
    halved (the vocab gathered whole before use, the
    ``inner`` leaves never); full recurrentgemma-9b at (1, 2) under tensor
    parallelism: heads, MLP columns, vocab rows and ``inner`` halved, the
    KV projections and norms whole."""
    got = {}
    for arch in (SSM, HYBRID):
        cfg = tconfigs.get(arch)
        one = ZeroInfinityEngine(RunConfig(model=cfg, parallel=make_parallel("pjit")),
                                 "cpu").shard_bytes()["param_shard_bytes"]
        eng = _engine(cfg, 2)
        whole = sum(math.prod(d.shape) * d.torch_dtype.itemsize
                    for p, d in zip(tpt.tree_paths(eng.bundle.defs),
                                    tpt.tree_leaves(eng.bundle.defs))
                    if tpt.tree_get(eng.model_splits, p) is None)
        mine = eng.shard_bytes()["param_shard_bytes"]
        assert mine == whole + (one - whole) // 2
        got[arch] = (eng.mp.strategy, one, mine)
    assert got == {SSM: ("cp", 739_530_752, 382_546_944),
                   HYBRID: ("tp", 18_794_725_376, 9_423_159_296)}, got


def test_encdec_still_raises_naming_8g4_and_the_others_build():
    """On a model axis ``registry.build`` with a rank's context takes the
    ssm and hybrid families, and the encoder-decoder too (item 8g.4 is
    ported, ``tests/test_torch_encdec_tp.py``): under either strategy its
    cache holds the cross-attention's ``xk`` / ``xv``, the rank's K/V heads
    under tensor parallelism."""
    from repro_torch.core.zero import ModelAxis
    from repro_torch.models import registry as treg

    for arch in (SSM, HYBRID):
        mp = ModelAxis(_fake_mesh(), "tp" if arch == HYBRID else "cp", inner=True)
        bundle = treg.build(tconfigs.smoke(arch), mp=mp)
        assert "len" in bundle.cache_defs(1, 4)
    cfg = tconfigs.smoke("seamless-m4t-medium")
    for strategy, heads in (("cp", cfg.n_kv_heads), ("tp", cfg.n_kv_heads // 2)):
        bundle = treg.build(cfg, mp=ModelAxis(_fake_mesh(), strategy))
        defs = bundle.cache_defs(1, 4)
        assert defs["xk"].shape[3] == defs["k"].shape[3] == heads, strategy


# ---------------------------------------------------------------------------
# the pieces without a process group
# ---------------------------------------------------------------------------


class _WholeCP:
    """A context-parallel model rank whose sequence gather hands back the
    whole sequence it was built with; any other collective fails."""

    tp, seq, inner = False, True, False

    def __init__(self, whole, rank, size):
        self.whole, self.rank, self.size = whole, rank, size

    def gather(self, t, dim):
        assert dim == 1 and t.shape[1] * self.size == self.whole.shape[1]
        return self.whole

    def enter(self, x):
        raise AssertionError("a whole block enters no column-parallel product")

    join = scatter = enter


class _WholeTP(_WholeCP):
    tp, seq = True, False

    def __init__(self):
        super().__init__(None, 0, 3)


@pytest.mark.parametrize("rank", range(3))
def test_a_whole_block_runs_on_the_gathered_sequence_and_keeps_its_chunk(rank):
    """The divisibility guard's path (lru_width 64 over 3 model ranks):
    under context parallelism the rank runs the whole recurrent block on
    the gathered sequence and keeps its chunk, a slice with no sum, bit for
    bit the one-rank block's; under tensor parallelism the block runs
    whole with no collective."""
    cfg = tconfigs.smoke(HYBRID)
    gen = torch.Generator().manual_seed(9)
    defs, p = trg.rec_defs(cfg), {}
    for path in tpt.tree_paths(defs):
        d = tpt.tree_get(defs, path)
        tpt.tree_set(p, path, (torch.randn(d.shape, generator=gen) * 0.2).to(d.torch_dtype))
    x = torch.randn(2, 12, cfg.d_model, generator=gen).to(torch.bfloat16)
    want, _ = trg.rec_block(p, x, cfg)
    chunk = x[:, 4 * rank:4 * (rank + 1)]
    normed = trg.cm.norm(x, p["ln"], cfg.norm_kind)  # what the rank's gather brings in
    got, _ = trg.rec_block(p, chunk, cfg, mp=_WholeCP(normed, rank, 3))
    assert torch.equal(got, want[:, 4 * rank:4 * (rank + 1)])
    got, _ = trg.rec_block(p, x, cfg, mp=_WholeTP())
    assert torch.equal(got, want)


def test_decode_positions_pass_a_fixed_state_cache_through():
    """A mamba2 cache (no top-level ``k`` / ``v``) under context
    parallelism passes through unsplit, at the whole capacity: its
    ``inner`` leaves are the rank's already."""
    defs = tm2.cache_defs_fn(tconfigs.smoke(SSM))(2, 12)
    cache = {k: torch.zeros(d.shape, dtype=d.torch_dtype) for k, d in defs.items()}
    cache["len"] = torch.tensor(5, dtype=torch.int32)
    mp = types.SimpleNamespace(rank=1, size=2, mesh=None, tp=False)
    assert kvcache.decode_positions(cache, mp, 12) == (cache, 5, 12, False)


@pytest.mark.parametrize("strategy", ["cp", "tp"])
@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_the_ranks_cache_defs_hold_their_inner_channels(arch, strategy):
    """A model rank's cache (its engine's bundle): the ``inner`` leaves'
    channels (and mamba2's heads) halved at M 2, everything else the
    one-rank cache's shape."""
    one = jreg.build(jconfigs.smoke(arch)).cache_defs(3, 12)
    mine = _engine(tconfigs.smoke(arch), 2, strategy).bundle.cache_defs(3, 12)
    flat = {jax.tree_util.keystr(p): d for p, d in jax.tree_util.tree_flatten_with_path(
        one, is_leaf=lambda x: hasattr(x, "axes"))[0]}
    for path in tpt.tree_paths(mine):
        d, want = tpt.tree_get(mine, path), flat[_keystr(path)]
        shape = tuple(n // 2 if a == "inner" else n for n, a in zip(want.shape, want.axes))
        assert tuple(d.shape) == shape and tuple(d.axes) == tuple(want.axes), path


# ---------------------------------------------------------------------------
# training and serving on ranks against the reference on host devices
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's ``.npz``, per world size each rank's results and
    the reference's serving params."""
    tmp = str(tmp_path_factory.mktemp("recurrent_tp"))
    drawn = {}
    for case in W.RECURRENT_TP_CASES:
        cfg = W.gspmd_cfg(case, jconfigs)
        key = repr(dataclasses.replace(cfg, window=0))  # the window shapes no param
        if key not in drawn:
            params = jax.jit(jreg.build(cfg).init)(jax.random.PRNGKey(0))
            drawn[key] = bridge.params_from_numpy(jax.tree.map(np.asarray, params))
        torch.save(drawn[key], W.gspmd_init_path(tmp, case))
    serve_params = save_serve_inits(tmp, SERVE)
    ref, path = start_reference(tmp, "recurrent_tp")
    try:
        worlds = sorted({D * M for D, M, *_ in W.RECURRENT_TP_CASES.values() if M > 1})
        with concurrent.futures.ThreadPoolExecutor(len(worlds)) as pool:
            runs = {w: pool.submit(W.spawn, "recurrent_tp", w, tmp, TIMEOUT) for w in worlds}
            out = {w: f.result() for w, f in runs.items()}
        npz = finish_reference(ref, path)
    except BaseException:
        ref.kill()
        ref.communicate()
        raise
    yield types.SimpleNamespace(ref=npz, ranks=out, params=serve_params)


def _ranks(ranks, case) -> list:
    D, M = W.RECURRENT_TP_CASES[case][:2]
    return [r[case] for r in ranks.ranks[D * M]]


def _lrs(ranks, case):
    return list(ranks.ref[f"{case}/lr"])


def _drift(ranks, case) -> float:
    return tadam.parity_bound(W._gspmd_run(case, "").train, _lrs(ranks, case))


def test_each_case_runs_the_references_strategy_and_split(ranks):
    """Every rank ran the reference's ``choose_attn_strategy`` on its mesh;
    ``inner`` is split over the model ranks but at (1, 3), where
    lru_width 64 does not divide."""
    seen = set()
    for case in TRAIN:
        D, M, arch, *_, strategy = W.RECURRENT_TP_CASES[case]
        want = jpt.choose_attn_strategy(
            W.gspmd_cfg(case, jconfigs), types.SimpleNamespace(shape={"data": D, "model": M}),
            jmake_parallel("pjit", attn_strategy=strategy))
        rs = _ranks(ranks, case)
        assert all(r["strategy"] == want for r in rs), case
        seen.add((arch, want))
        leaf = ("blocks", "w_x") if arch == SSM else ("groups", "rec1", "w_in")
        assert tpt.tree_get(rs[0]["model_splits"], leaf) == (None if M == 3 else 2), case
    assert seen == {(SSM, "cp"), (SSM, "tp"), (HYBRID, "tp"), (HYBRID, "cp")}


@pytest.mark.parametrize("step", range(W.GSPMD_STEPS))
@pytest.mark.parametrize("case", TRAIN)
def test_step_matches_reference_loss_grad_norm_and_lr(ranks, case, step):
    """Loss and grad norm (one value on every rank) and the lr against the
    reference's global step by ``TIER_TOL``."""
    rs = _ranks(ranks, case)
    for key in ("loss", "grad_norm", "lr"):
        got = [r["metrics"][step][key] for r in rs]
        assert len(set(got)) == 1, (case, key, got)
        np.testing.assert_allclose(got[0], ranks.ref[f"{case}/{key}"][step], **TIER_TOL,
                                   err_msg=f"{case} {key}")


@pytest.mark.parametrize("case", TRAIN)
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


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _ref_drift(ranks, case, path, moment) -> float:
    """The reference's own distance, in norm, between its mesh run of a
    mamba2 case and its one-device run (``ssm_dp1``) in ``moment`` of a
    leaf: mamba2's second step is rounding-sensitive (ROADMAP.md Queue 1
    B item 13b), and the small ``state`` leaves' moments move most."""
    name = _keystr(path)
    return _rel(ranks.ref[f"{case}/{moment}/{name}"], ranks.ref[f"ssm_dp1/{moment}/{name}"])


@pytest.mark.parametrize("case", TRAIN)
def test_optimizer_states_match_reference(ranks, case):
    """The step count, the masters joined within the drift bound, m and v
    within ``MOMENT_REL`` in norm, leaf by leaf. mamba2's second step is
    rounding-sensitive (ROADMAP.md Queue 1 B item 13b): the reference's own
    run on these meshes is up to ~4.4 % from its one-device run in the
    small ``state`` leaves' v and ~3.3 % in their m, where every other
    leaf's moments stay near 2 %; so for the ``state`` leaves' moments, and
    only there, the bound is ``MOMENT_REL`` plus that drift of the
    reference's in the same moment (``_ref_drift``)."""
    rs = _ranks(ranks, case)
    drift = _drift(ranks, case)
    ssm = W.RECURRENT_TP_CASES[case][2] == SSM
    defs = _engine(W.gspmd_cfg(case, tconfigs), 2).bundle.defs
    assert all(int(r["opt"][0]) == W.GSPMD_STEPS for r in rs)
    assert int(ranks.ref[f"{case}/step"]) == W.GSPMD_STEPS
    for path in tpt.tree_paths(rs[0]["opt"][1]):
        name = _keystr(path)
        master = _whole(rs, lambda r: r["opt"][1], "opt", path)
        assert np.abs(master - ranks.ref[f"{case}/master/{name}"]).max() <= drift, (case, path)
        for i, moment in ((2, "m"), (3, "v")):
            got = _whole(rs, lambda r: r["opt"][i], "opt", path)
            want = ranks.ref[f"{case}/{moment}/{name}"]
            slack = (_ref_drift(ranks, case, path, moment)
                     if ssm and "state" in tpt.tree_get(defs, path).axes else 0.0)
            rel = _rel(got, want)
            assert rel <= MOMENT_REL + slack, (case, path, moment, rel, slack)


@pytest.mark.parametrize("case", TRAIN)
def test_each_rank_holds_the_references_shard(ranks, case):
    """Rank r's param and master shards have the shape of the reference's
    addressable shard on the mesh's r-th device and its values within the
    same bounds: ``inner`` cut where XLA cuts it, never whole."""
    rs = _ranks(ranks, case)
    drift, lrs = _drift(ranks, case), _lrs(ranks, case)
    for rank, r in enumerate(rs):
        for path in tpt.tree_paths(r["params"]):
            name = _keystr(path)
            got = _np(tpt.tree_get(r["params"], path))
            want = ranks.ref[f"{case}/params_shard{rank}/{name}"]
            assert got.shape == want.shape, (rank, path, got.shape, want.shape)
            _params_within(got, want, drift, lrs, (case, rank, path))
            got = _np(tpt.tree_get(r["opt"][1], path))
            want = ranks.ref[f"{case}/master_shard{rank}/{name}"]
            assert got.shape == want.shape, (rank, path)
            assert np.abs(got - want).max() <= drift, (case, rank, path)


@pytest.mark.parametrize("case", TRAIN)
def test_rank_bytes_are_the_shards(ranks, case):
    """Each rank's state bytes are its shards' (``shard_bytes``) every
    step, their sum over the ranks the same on every rank."""
    rs = _ranks(ranks, case)
    for step in range(W.GSPMD_STEPS):
        for key in ("param_shard_bytes", "grad_shard_bytes", "opt_shard_bytes"):
            mine = [r["metrics"][step][key] for r in rs]
            assert all(m == r["shard_bytes"][key] for m, r in zip(mine, rs)), (case, key)
            assert all(r["metrics"][step][f"{key}_all_ranks"] == sum(mine) for r in rs)


def test_model_sum_has_an_all_reduce_backward(ranks):
    """``ModelAxis.sum``: the ranks' draws summed, its gradient the ranks'
    cotangents summed, where ``join`` (``FromModel``) keeps the rank's own
    and so differs; ``rms_norm_split`` on each rank's half of a row is the
    whole row's norm, and its gradient the whole row's on that half, within
    bf16's rounding."""
    for r in ranks.ranks[2]:
        u = r["model_sum"]
        for key in ("summed", "gx"):
            assert torch.equal(u[key], u[f"want_{key}"]), key
        assert not torch.allclose(u["join_gx"], u["want_gx"])
        for key in ("norm", "norm_grad"):
            got, want = u[key].float(), u[f"want_{key}"].float()
            assert (got - want).abs().max() <= 2 ** -7 * want.abs().max(), key


def _serve_ranks(ranks, case) -> list:
    return [r[case] for r in ranks.ranks[W.RECURRENT_SERVE_CASES[case][0]]]


def _seq_bytes(defs) -> int:
    """One sequence's cache bytes, the ``len`` leaf aside."""
    return sum(math.prod(d.shape) * d.torch_dtype.itemsize
               for p, d in zip(tpt.tree_paths(defs), tpt.tree_leaves(defs)) if p != ("len",))


@pytest.mark.parametrize("case", SERVE)
def test_serving_runs_the_cases_strategy(ranks, case):
    """mamba2 serves under context parallelism and the hybrid under tensor
    parallelism where nothing is forced; the other strategy where it is;
    the decode cache never splits by position."""
    auto = "cp" if W.RECURRENT_SERVE_CASES[case][1] == SSM else "tp"
    forced = W.serve_strategy(case)
    want = auto if forced == "auto" else forced
    assert want == auto or forced != "auto"  # a forced case runs the other strategy
    for r in _serve_ranks(ranks, case):
        assert r["mesh"]["strategy"] == want and not r["mesh"]["cache_seq_split"]


@pytest.mark.parametrize("case", SERVE)
def test_serving_tokens_equal_the_references_or_part_at_a_near_tie(ranks, case):
    check_tokens(ranks.ref, _serve_ranks(ranks, case), case, ranks.params[case])


@pytest.mark.parametrize("case", SERVE)
def test_serving_teacher_forced_logits_match_the_reference(ranks, case):
    check_forced_logits(_serve_ranks(ranks, case), case, ranks.params[case])


@pytest.mark.parametrize("case", SERVE)
def test_serving_kv_bytes_are_the_references_by_each_ranks_cache(ranks, case):
    """Each rank's ``kv`` counters, less the ``len`` leaf (model rank 0's),
    are the reference's (less its ``len``) times the rank's cache bytes a
    sequence over the one-rank cache's: its ``inner`` channels and the
    leaves it holds whole. So the ranks' sum is the reference's plus the
    whole leaves' share once more a model rank; the step count is the
    reference's."""
    rs = _serve_ranks(ranks, case)
    cfg = W.serve_cfg(case, tconfigs)
    args = W.serve_argv(case, "torch", "")
    cap = int(args[args.index("--prompt-len") + 1]) + 4
    full = _seq_bytes(ZeroInfinityEngine(RunConfig(model=cfg), "cpu").bundle.cache_defs(1, cap))
    lens = {"resident_bytes": 2 * LEN_BYTES}  # one a slot
    lens.update({k: 3 * LEN_BYTES for k in KV_KEYS if k != "resident_bytes"})  # a parked seq
    for r in rs:
        M = r["mesh"]["model"]
        mine = [_seq_bytes(_engine(cfg, M, W.serve_strategy(case), m).bundle.cache_defs(1, cap))
                for m in range(M)]
        assert full < sum(mine) < M * full
        for k in KV_KEYS:
            assert r["kv"][k] == sum(kr[k] for kr in r["kv_ranks"]), (case, k)
            want = int(ranks.ref[f"{case}/kv/{k}"]) - lens[k]
            for m, kr in enumerate(r["kv_ranks"]):
                got = kr[k] - (lens[k] if m == 0 else 0)
                assert got * full == want * mine[m], (case, k, m)
        assert r["steps"] == int(ranks.ref[f"{case}/steps"])


@pytest.mark.parametrize("case", SERVE)
def test_serving_ranks_hold_their_shards_and_their_inner_leaves(ranks, case):
    """Each rank's resident param bytes are ``shard_bytes()``'s; its view
    of every layer and unstacked leaf is the model shard of the whole
    leaves, its ``inner`` leaves its own (bit for bit), and it holds each
    ``inner`` leaf split over the model ranks."""
    rs = _serve_ranks(ranks, case)
    for rank, r in enumerate(rs):
        assert r["param_shard_bytes"][rank] == r["shard_bytes"]
        assert r["gather"]["equal"], (case, rank)
        held = r["gather"]["held_shapes"]
        eng = _engine(W.serve_cfg(case, tconfigs), 2, W.serve_strategy(case), rank)
        for path in _inner_paths(eng):
            if path[0] in eng.stacked:
                d = tpt.tree_get(eng.bundle.defs, path)
                dim = d.axes.index("inner")
                assert held[path][dim] * 2 == d.shape[dim], (case, path)
