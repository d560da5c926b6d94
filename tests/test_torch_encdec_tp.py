"""The encoder-decoder on the model axis: the port's GSPMD engine and
``launch.serve`` on seamless-m4t's smoke config over ``data x model``
ranks, one process each over ``torch.distributed`` (gloo, on the CPU),
against the JAX package's ``InfinityExecutor(engine="pjit")`` and
``launch.serve`` on a mesh of as many host devices; the memory's entry
into the model axis, the uncut context-parallel attention and the
decode cache's layout on their own.

* **The layout.** seamless builds on a model axis at 2, 3 and 4 ranks,
  full and smoke, under the reference's ``choose_attn_strategy``: tensor
  parallelism where its heads split (both stacks' heads, the
  cross-attention's ``wk`` / ``wv`` on ``kv_heads``, the MLP's columns
  and the vocab), context parallelism where they do not (every whole
  leaf partial over the model ranks); the layer norms' biases stay whole;
  both stacks are serving's stacked subtrees. Full seamless's bytes a
  rank at (1, 2), the numbers the card's phases hold.
* **The step on ranks.** The fixture saves each case's initial params
  (the reference bundle's init at one device), starts the reference
  (``tests/torch_dp_reference.py encdec_tp``: one subprocess, every case)
  and the port's ranks (``tests/torch_dp_worker.py encdec_tp`` at 2, 3
  and 4 ranks) together. Cases (``torch_dp_worker.ENCDEC_TP_CASES``):
  tensor parallelism at (1, 2), (1, 4) and (2, 2), context parallelism
  forced at (1, 2) on 64 frames and under ``auto`` at (1, 3) on 72 frames
  and 18 decoder tokens. Held as ``tests/test_torch_tp.py`` holds the
  dense families, by ``tests/test_torch_gspmd.py``'s tolerances,
  imported: loss, grad norm and lr by ``TIER_TOL``; the params joined
  from the ranks' shards and each rank's shard against XLA's addressable
  shard by the drift bound plus each side's bf16 rounding; the masters
  within the drift bound; m and v within ``MOMENT_REL``; each rank's
  state bytes ``shard_bytes``' exactly.
* **Serving.** At (1, 2) under tensor parallelism and context
  parallelism forced (``torch_dp_worker.SERVE_STRATEGY``), the latter at
  a capacity that splits (the cache and the memory's ``xk`` / ``xv`` by
  position over the ranks) and at one that does not (every rank the
  whole cache): the tokens (equal, or parting at a near-tie, ``tests/
  test_torch_cp_serve.py``'s rule); the teacher-forced prefill and decode
  logits against the reference bundle's on one device by ``LOGIT_TOL``;
  the ``kv`` bytes summed over the ranks (model rank 0's where the cache
  is whole) the reference's; each rank's resident cache, ``xk`` / ``xv``
  counted from the memory's length, its share of the reference's by the
  layout (its KV heads, or its positions); each rank's param bytes
  ``shard_bytes``' and its view of a layer the model shard of the whole.
"""
import concurrent.futures
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
from repro_torch.config import RunConfig, make_parallel  # noqa: E402
from repro_torch.core import kvcache  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core.engine import ZeroInfinityEngine  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from test_torch_cp_serve import (TIMEOUT, check_forced_logits, check_kv_bytes,  # noqa: E402
                                 check_tokens, finish_reference, save_serve_inits,
                                 start_reference)
from test_torch_gspmd import MOMENT_REL, TIER_TOL  # noqa: E402
from test_torch_gspmd_mesh import _keystr, _np, _params_within  # noqa: E402
from test_torch_tp import _whole  # noqa: E402
from test_torch_tp_serve import LEN_BYTES  # noqa: E402

ARCH = "seamless-m4t-medium"
TRAIN = list(W.ENCDEC_TP_CASES)
SERVE = list(W.ENCDEC_SERVE_CASES)


def _fake_mesh(data=1, model=2, rank=0):
    """A rank's mesh with no process group: enough for what the engine
    decides before the first collective."""
    return mesh_mod.LocalMesh(data, model, rank, data * model, torch.device("cpu"), None, "gloo")


def _engine(cfg, M, strategy="auto", rank=0, data=1):
    run = RunConfig(model=cfg, parallel=make_parallel("pjit", attn_strategy=strategy))
    return ZeroInfinityEngine(run, "cpu", mesh=_fake_mesh(data, M, rank))


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [2, 3, 4])
@pytest.mark.parametrize("smoke", [True, False])
def test_the_engine_builds_under_the_references_strategy(smoke, M):
    """The strategy is the reference's ``choose_attn_strategy``'s; under
    tensor parallelism both stacks' heads, the cross-attention's K/V heads
    (``kv_heads``), the MLP's columns and the vocab split over the model
    ranks where they divide and no leaf is partial over them (every norm
    sees the whole activations, the memory's cotangent summed where it
    enters the model axis); under context parallelism nothing splits on
    the heads and every whole leaf is partial; the norms' biases stay
    whole; both stacks are stacked subtrees, split on no layer dim."""
    cfg = (tconfigs.smoke if smoke else tconfigs.get)(ARCH)
    eng = _engine(cfg, M)
    jcfg = (jconfigs.smoke if smoke else jconfigs.get)(ARCH)
    want = jpt.choose_attn_strategy(jcfg, types.SimpleNamespace(shape={"data": 1, "model": M}),
                                    jmake_parallel("pjit"))
    assert eng.mp.strategy == want == ("cp" if cfg.n_heads % M else "tp")
    assert eng.stacked == ("dec", "enc")
    tp = want == "tp"
    for stack, attn in (("enc", "attn"), ("dec", "self_attn"), ("dec", "cross_attn")):
        for leaf, dim in (("wq", 2), ("wk", 2), ("wv", 2), ("wo", 1)):
            split = tpt.tree_get(eng.model_splits, (stack, attn, leaf))
            assert split == (dim if tp else None), (stack, attn, leaf)
    for path in tpt.tree_paths(eng.bundle.defs):
        if path[-1] == "bias":
            assert tpt.tree_get(eng.model_splits, path) is None, path
        whole = tpt.tree_get(eng.model_splits, path) is None
        assert eng._partial_over_model(path) == (whole and not tp), path


def test_full_seamless_bytes_a_rank():
    """Full seamless-m4t-medium's 1,233,633,280 param bytes at (1, 2):
    617,070,592 a rank under tensor parallelism (heads, K/V heads, MLP
    columns and vocab rows halved, the norms whole), 768,065,536 under
    context parallelism forced (the MLP's columns and the vocab halved,
    gathered whole before use)."""
    cfg = tconfigs.get(ARCH)
    one = ZeroInfinityEngine(RunConfig(model=cfg, parallel=make_parallel("pjit")),
                             "cpu").shard_bytes()["param_shard_bytes"]
    got = {}
    for strategy in ("auto", "cp"):
        eng = _engine(cfg, 2, strategy)
        whole = sum(math.prod(d.shape) * d.torch_dtype.itemsize
                    for p, d in zip(tpt.tree_paths(eng.bundle.defs),
                                    tpt.tree_leaves(eng.bundle.defs))
                    if tpt.tree_get(eng.model_splits, p) is None)
        mine = eng.shard_bytes()["param_shard_bytes"]
        assert mine == whole + (one - whole) // 2
        got[strategy] = (eng.mp.strategy, mine)
    assert one == 1_233_633_280
    assert got == {"auto": ("tp", 617_070_592), "cp": ("cp", 768_065_536)}, got


@pytest.mark.parametrize("M", [2, 4])
def test_the_ranks_cache_holds_its_kv_heads(M):
    """Under tensor parallelism a rank's cache (its engine's bundle) holds
    ``KV / M`` heads of the decoder's K/V and of ``xk`` / ``xv``, every
    other dim the reference's one-rank cache's."""
    one = jreg.build(jconfigs.smoke(ARCH)).cache_defs(3, 12)
    mine = _engine(tconfigs.smoke(ARCH), M).bundle.cache_defs(3, 12)
    for name in ("k", "v", "xk", "xv"):
        shape = list(one[name].shape)
        shape[3] //= M
        assert tuple(mine[name].shape) == tuple(shape), name
    assert tuple(mine["len"].shape) == ()


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("rank", [0, 1])
def test_decode_positions_split_the_memory_with_the_cache(rank, chunked):
    """``decode_positions`` under context parallelism on an encoder-
    decoder's prefill (4 decoder and 16 memory positions): at a capacity
    of 8 each rank keeps its 4 decoder positions' range and the memory's
    ``[8 m, 8 (m + 1))`` (a chunked prefill's own chunk, no collective);
    at 9 nothing splits and the prompt whole on the rank stays whole."""
    P, E = 4, 16
    k = torch.arange(P, dtype=torch.float32).reshape(1, 1, P, 1, 1)
    xk = torch.arange(E, dtype=torch.float32).reshape(1, 1, E, 1, 1) + 100
    mp = types.SimpleNamespace(rank=rank, size=2, mesh=None, tp=False)
    lo = 8 * rank
    cache = {"k": k, "v": k, "xk": xk[:, :, lo:lo + 8] if chunked else xk,
             "xv": xk[:, :, lo:lo + 8] if chunked else xk,
             "len": torch.tensor(P, dtype=torch.int32)}
    if chunked:  # the rank's chunk of the decoder tokens; a split gathers k / v only
        cache["k"] = cache["v"] = k[:, :, 2 * rank:2 * rank + 2]
        mp.mesh = types.SimpleNamespace(all_gather_leaves=lambda leaves, axis: [
            k for _ in leaves])
    got, own, n, split = kvcache.decode_positions(cache, mp, 8)
    assert (split, n) == (True, 4)
    assert got["k"][0, 0, :, 0, 0].tolist() == ([0, 1, 2, 3] if rank == 0 else [])
    for name in ("xk", "xv"):
        assert got[name][0, 0, :, 0, 0].tolist() == [100 + lo + i for i in range(8)]
    if not chunked:
        got, own, n, split = kvcache.decode_positions(cache, mp, 9)
        assert (split, own, n) == (False, P, 9)
        assert torch.equal(got["xk"], xk) and torch.equal(got["k"], k)


# ---------------------------------------------------------------------------
# training and serving on ranks against the reference on host devices
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's ``.npz``, per world size each rank's results and
    the reference's serving params."""
    tmp = str(tmp_path_factory.mktemp("encdec_tp"))
    params = jax.jit(jreg.build(jconfigs.smoke(ARCH)).init)(jax.random.PRNGKey(0))
    init = bridge.params_from_numpy(jax.tree.map(np.asarray, params))
    for case in TRAIN:
        torch.save(init, W.gspmd_init_path(tmp, case))
    serve_params = save_serve_inits(tmp, SERVE)
    ref, path = start_reference(tmp, "encdec_tp")
    try:
        worlds = sorted({D * M for D, M, *_ in W.ENCDEC_TP_CASES.values()})
        with concurrent.futures.ThreadPoolExecutor(len(worlds)) as pool:
            runs = {w: pool.submit(W.spawn, "encdec_tp", w, tmp, TIMEOUT) for w in worlds}
            out = {w: f.result() for w, f in runs.items()}
        npz = finish_reference(ref, path)
    except BaseException:
        ref.kill()
        ref.communicate()
        raise
    yield types.SimpleNamespace(ref=npz, ranks=out, params=serve_params)


def _ranks(ranks, case) -> list:
    D, M = W.ENCDEC_TP_CASES[case][:2]
    return [r[case] for r in ranks.ranks[D * M]]


def _lrs(ranks, case):
    return list(ranks.ref[f"{case}/lr"])


def _drift(ranks, case) -> float:
    return tadam.parity_bound(W._gspmd_run(case, "").train, _lrs(ranks, case))


def test_each_case_runs_the_references_strategy_and_split(ranks):
    """Every rank ran the reference's ``choose_attn_strategy`` on its mesh:
    tensor parallelism with the cross-attention's K/V heads split, context
    parallelism (forced at 2, ``auto`` at 3) with them whole."""
    seen = set()
    for case in TRAIN:
        D, M, *_, strategy = W.ENCDEC_TP_CASES[case]
        want = jpt.choose_attn_strategy(
            W.gspmd_cfg(case, jconfigs), types.SimpleNamespace(shape={"data": D, "model": M}),
            jmake_parallel("pjit", attn_strategy=strategy))
        rs = _ranks(ranks, case)
        assert all(r["strategy"] == want for r in rs), case
        seen.add((want, M))
        leaf = ("dec", "cross_attn", "wk")
        assert tpt.tree_get(rs[0]["model_splits"], leaf) == (2 if want == "tp" else None), case
    assert seen == {("tp", 2), ("tp", 4), ("cp", 2), ("cp", 3)}


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


@pytest.mark.parametrize("case", TRAIN)
def test_optimizer_states_match_reference(ranks, case):
    """The step count, the masters joined within the drift bound, m and v
    within ``MOMENT_REL`` in norm, leaf by leaf."""
    rs = _ranks(ranks, case)
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


@pytest.mark.parametrize("case", TRAIN)
def test_each_rank_holds_the_references_shard(ranks, case):
    """Rank r's param and master shards have the shape of the reference's
    addressable shard on the mesh's r-th device and its values within the
    same bounds."""
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


def test_the_memorys_cotangent_is_the_one_rank_one(ranks):
    """Under tensor parallelism the loss and its gradient in the frames on
    each rank equal the one-rank bundle's within bf16's rounding: the
    memory enters the model axis once, so the encoder's backward starts
    from the cross-attentions' cotangents summed over both ranks' heads
    (one rank's alone would be about half of it)."""
    for r in ranks.ranks[2]:
        u = r["encdec_unit"]
        assert u["strategy"] == "tp"
        assert abs(float(u["loss"]) - float(u["want_loss"])) <= 2 ** -7 * abs(float(u["want_loss"]))
        got, want = u["grad"].float(), u["want_grad"].float()
        assert (got - want).norm() <= 2 ** -5 * want.norm(), (got - want).norm() / want.norm()


@pytest.mark.parametrize("name", ["encoder", "cross", "causal"])
def test_context_parallel_attention_cuts_only_causal_self_attention(ranks, name):
    """Under context parallelism a rank's chunk through ``attention_block``
    equals its rows of the whole sequence's output: not causal (the
    encoder's) and as a cross-attention (on the memory's chunks) it
    attends every gathered key, causal self-attention the keys up to its
    chunk's end."""
    for r in ranks.ranks[2]:
        got, want = r["encdec_unit"][name].float(), r["encdec_unit"][f"want_{name}"].float()
        assert got.shape == want.shape
        assert (got - want).abs().max() <= 2 ** -8 * want.abs().max(), name


def _serve_ranks(ranks, case) -> list:
    return [r[case] for r in ranks.ranks[W.ENCDEC_SERVE_CASES[case][0]]]


# each serving case's strategy, whether its decode cache splits by
# position and the positions a rank's cache holds
LAYOUT = {"encdec_tp_serve_1x2": ("tp", False, 8), "encdec_cp_serve_1x2": ("cp", True, 4),
          "encdec_cp_whole_serve_1x2": ("cp", False, 9)}


@pytest.mark.parametrize("case", SERVE)
def test_serving_runs_the_cases_strategy_and_cache_layout(ranks, case):
    """Tensor parallelism where nothing is forced, context parallelism where
    it is; the decode cache splits by position where the capacity (4 + 4
    new tokens) and the frames both divide by the model ranks, and is
    whole on every rank at 4 + 5."""
    assert set(LAYOUT) == set(SERVE)
    strategy, split, n = LAYOUT[case]
    for r in _serve_ranks(ranks, case):
        msh = r["mesh"]
        assert (msh["strategy"], msh["cache_seq_split"], msh["local_cache_len"]) == (
            strategy, split, n)


@pytest.mark.parametrize("case", SERVE)
def test_serving_tokens_equal_the_references_or_part_at_a_near_tie(ranks, case):
    check_tokens(ranks.ref, _serve_ranks(ranks, case), case, ranks.params[case])


@pytest.mark.parametrize("case", SERVE)
def test_serving_teacher_forced_logits_match_the_reference(ranks, case):
    check_forced_logits(_serve_ranks(ranks, case), case, ranks.params[case])


@pytest.mark.parametrize("case", SERVE)
def test_serving_kv_bytes_summed_over_the_ranks_are_the_references(ranks, case):
    check_kv_bytes(ranks.ref, _serve_ranks(ranks, case), case)


@pytest.mark.parametrize("case", SERVE)
def test_each_ranks_resident_cache_holds_its_xk_xv_by_the_layout(ranks, case):
    """Each rank's resident cache (less the slots' ``len`` leaf, model rank
    0's) is its two slots' decoder K/V at its capacity and their ``xk`` /
    ``xv`` at the memory's 16 frames, in its layout: half the KV heads
    under tensor parallelism, half of both position ranges where the
    context-parallel cache splits, all of it where it does not; so it is
    the reference's over the ranks that split it."""
    cfg = tconfigs.smoke(ARCH)
    args = tserve._parse(W.serve_argv(case, "torch", ""))
    C, E = args.prompt_len // 4 + args.new_tokens, args.prompt_len
    want = int(ranks.ref[f"{case}/kv/resident_bytes"]) - 2 * LEN_BYTES
    for r in _serve_ranks(ranks, case):
        msh = r["mesh"]
        parts = 2 if msh["strategy"] == "tp" or msh["cache_seq_split"] else 1
        heads = cfg.n_kv_heads // (2 if msh["strategy"] == "tp" else 1)
        n_dec, n_mem = (C // parts, E // parts) if msh["cache_seq_split"] else (C, E)
        xkv = 2 * cfg.n_dec_layers * 2 * n_mem * heads * cfg.resolved_head_dim * 2
        layout = 2 * cfg.n_dec_layers * 2 * n_dec * heads * cfg.resolved_head_dim * 2 + xkv
        for rank, kr in enumerate(r["kv_ranks"]):
            mine = kr["resident_bytes"] - (2 * LEN_BYTES if rank == 0 else 0)
            assert mine == layout and mine * parts == want, (case, rank, mine, layout, want)


@pytest.mark.parametrize("case", SERVE)
def test_serving_ranks_hold_their_shards(ranks, case):
    """Each rank's resident param bytes are ``shard_bytes()``'s and its
    view of every layer and unstacked leaf the model shard of the whole
    leaves (context parallelism's the leaves it gathers whole), bit for
    bit."""
    rs = _serve_ranks(ranks, case)
    for rank, r in enumerate(rs):
        eng = _engine(tconfigs.smoke(ARCH), 2, W.serve_strategy(case), rank)
        assert r["param_shard_bytes"][rank] == r["shard_bytes"] == eng.shard_bytes()[
            "param_shard_bytes"]
        assert r["gather"]["equal"], (case, rank)
        assert r["gather"]["stacked"] == ["dec", "enc"]


def test_the_plan_on_the_model_axis_is_the_references(ranks):
    """``--plan auto --hw-devices 2 --model-mesh 2`` on the smoke seamless
    (both devices on the model axis: tensor parallelism): the reference's
    plan for the same hardware, byte for byte; both ranks train on it with
    the plan's per-device state bytes (``plan_*_shard_bytes``, the
    reference plan's parameters over its two devices) beside each rank's,
    which are its tensor-parallel shards', the same losses on both."""
    import json

    from repro import plan as jplan
    from repro.config import ShapeConfig as JShape
    from repro_torch.launch import train as ttrain

    rs = [r["plan"] for r in ranks.ranks[2]]
    assert rs[0]["plan"] == rs[1]["plan"]
    args = ttrain.build_argparser().parse_args(W.ENCDEC_PLAN_ARGV)
    hw = jplan.HardwareSpec(**json.loads(rs[0]["plan"])["hardware"])
    want = jplan.resolve_plan(args, jconfigs.smoke(ARCH), JShape("cli", 64, 4, "train"),
                              argv=W.ENCDEC_PLAN_ARGV, quiet=True, hardware=hw)
    assert rs[0]["plan"] == want.to_json()
    n = want.predictions["n_params"] / 2
    mine = _engine(tconfigs.smoke(ARCH), 2).shard_bytes()["param_shard_bytes"]
    for r in rs:
        assert np.isfinite(r["losses"]).all()
        for m in r["metrics"]:
            assert (m["plan_param_shard_bytes"], m["plan_opt_shard_bytes"]) == (2 * n, 12 * n)
            assert m["param_shard_bytes"] == mine
            assert m["param_shard_bytes_all_ranks"] == 2 * mine
    assert rs[0]["losses"] == rs[1]["losses"]
