"""Params on NVMe through the GSPMD leaf scheduler on ranks, one process per
rank over ``torch.distributed`` (gloo, on the CPU), against the JAX
package's ``InfinityExecutor(engine="pjit")`` with ``param_tier="nvme"`` on
a mesh of as many host devices.

The module's fixture saves each case's initial params (the reference
bundle's init at one device), then starts the reference
(``tests/torch_dp_reference.py nvme_mesh``: one subprocess with four host
devices, every case of ``torch_dp_worker.NVME_MESH_CASES`` on its mesh) and
the port's ranks (``tests/torch_dp_worker.py nvme_mesh``: 2 ranks for the
(2, 1) and (1, 2) cases, 4 for the (2, 2) one) together, both from those
params on the same global batches for ``GSPMD_STEPS`` steps. Cases: ZeRO-3
at (2, 1) with the in-graph update and with every state class on NVMe
(the rank's masters rounded on the host), stage 1 all on NVMe (params
whole, masters split: each rank writes back the gathered whole leaf), the
smoke llama under tensor parallelism at (2, 2), smollm under context
parallelism at (1, 2), and ``param_quant`` q8 and q4 at (2, 1).

Held: loss, grad norm and lr each step by ``TIER_TOL``; the params read
back from the ranks' stores and joined over the ranks against the
reference's (``tests/test_torch_gspmd_mesh.py``'s bounds, plus, under q8 /
q4, one step of each format's grid on the leaf). Under q8 / q4 the two
sides read params decoded from different grids, so the step's values and
the params' mean gap are widened by twice the reference's own grid effect
(its quantized run against its bf16 twin, ``_grid_effect``); each rank's store keys,
``rank<r>/<keystr>/c0``, the reference's under the rank's prefix, each
holding its shard's bytes (``qformat.wire_nbytes`` of the shard under
q8 / q4); each rank's tier counters (its shards' bytes a step) and their
``_all_ranks`` sums against the reference's counts, the difference being
the leaves more than one rank holds whole, named; the peak resident param
bytes within the leaf scheduler's window of the rank's shards.

The block grid (``qformat.grid_aligned``): a rank's shard is quantized on
its own, in blocks of 32 from its first element. Where every contiguous
run of the shard in the whole leaf's flat order starts and ends on a
32-element boundary its decode is exactly the slice of the reference's
decode of the whole leaf; else (``MISALIGNED``: the smoke smollm's
``wo``, cut along its 48 columns into runs of 24) within the two grids'
rounding.
"""
import concurrent.futures
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
from repro.models import registry as jreg  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core import qformat  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from test_torch_gspmd import MOMENT_REL, TIER_TOL  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = list(W.NVME_MESH_CASES)
QUANT = sorted(W.GSPMD_QUANT)
TIMEOUT = 300.0
# the leaf whose shards straddle the whole leaf's blocks: (2, 48, 48) cut
# along its last dim at dp 2, runs of 24 elements
MISALIGNED = "['blocks']['attn']['wo']"


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's ``.npz`` and, per world size, each rank's results."""
    tmp = str(tmp_path_factory.mktemp("nvme_mesh"))
    ref_path = os.path.join(tmp, "ref.npz")
    drawn = {}
    for case in CASES:
        cfg = W.gspmd_cfg(case, jconfigs)
        if repr(cfg) not in drawn:
            params = jax.jit(jreg.build(cfg).init)(jax.random.PRNGKey(0))
            drawn[repr(cfg)] = bridge.params_from_numpy(jax.tree.map(np.asarray, params))
        torch.save(drawn[repr(cfg)], W.gspmd_init_path(tmp, case))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    ref = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dp_reference.py"),
                            tmp, ref_path, "nvme_mesh"], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = {world: pool.submit(W.spawn, "nvme_mesh", world, tmp, TIMEOUT)
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
    D, M = W.NVME_MESH_CASES[case][:2]
    return [r[case] for r in ranks.ranks[D * M]]


def _lrs(ranks, case):
    return list(ranks.ref[f"{case}/lr"])


def _dims(r, cls, path) -> dict:
    return {"data": tpt.tree_get(r["splits"][cls], path),
            "model": tpt.tree_get(r["model_splits"], path)}


def _join(rs, tree_key, cls, path) -> np.ndarray:
    return _np(tpt.join_leaf([tpt.tree_get(r[tree_key], path) for r in rs],
                             _dims(rs[0], cls, path), rs[0]["sizes"]))


def _quant_step(want: np.ndarray, fmt: str) -> float:
    """One step of ``fmt``'s grid on a leaf: the most two encodes of the
    same values on different block grids can differ by (each side half a
    step of its own block, a block's step at most the leaf's: q8 absmax /
    127, q4 the range, zero included for a padded block, over 15), with
    the fp16 scale's and min's rounding."""
    if fmt == "q8":
        return float(np.abs(want).max()) / 127 * (1 + 2**-9)
    lo, hi = min(float(want.min()), 0.0), max(float(want.max()), 0.0)
    return (hi - lo) / 15 * (1 + 2**-9) + 2**-10 * float(np.abs(want).max())


# a quantized case's bf16 twin: the same config, mesh and tiers
BF16_TWIN = "nvme_stage3_2x1"


def _grid_effect(ranks, case, key, step=None) -> float:
    """How far the reference's own grid moves ``key`` (a step metric, or
    with ``step`` None the mean of a param leaf's values): its quantized
    run against its bf16 twin. Two grids (the reference's whole leaves,
    the port's shards) differ by at most twice that."""
    if case not in W.GSPMD_QUANT:
        return 0.0
    if step is not None:
        return abs(float(ranks.ref[f"{case}/{key}"][step])
                   - float(ranks.ref[f"{BF16_TWIN}/{key}"][step]))
    return float(np.abs(ranks.ref[f"{case}/params/{key}"]
                        - ranks.ref[f"{BF16_TWIN}/params/{key}"]).mean())


@pytest.mark.parametrize("step", range(W.GSPMD_STEPS))
@pytest.mark.parametrize("case", CASES)
def test_step_matches_reference_loss_grad_norm_and_lr(ranks, case, step):
    """Loss and grad norm, one value on every rank, and the lr, against
    the reference's global step by ``TIER_TOL``; under q8 / q4 widened by
    twice the reference's own grid effect on the value (``_grid_effect``:
    the decoded params the step reads differ by the two grids)."""
    rs = _ranks(ranks, case)
    for key in ("loss", "grad_norm", "lr"):
        got = [r["metrics"][step][key] for r in rs]
        assert len(set(got)) == 1, (case, key, got)
        want = float(ranks.ref[f"{case}/{key}"][step])
        tol = TIER_TOL["atol"] + TIER_TOL["rtol"] * abs(want)
        assert abs(got[0] - want) <= tol + 2 * _grid_effect(ranks, case, key, step), (
            case, key, got[0], want)


@pytest.mark.parametrize("case", CASES)
def test_params_from_the_stores_match_reference(ranks, case):
    """The leaves read back from the ranks' param stores after the last
    step, joined over the ranks, against the reference's from its store:
    the drift bound plus each side's bf16 rounding (and under q8 / q4 one
    step of the format's grid), the mean by 2^-5 * sum(lr) (and under
    q8 / q4 twice the reference's own grid effect on the leaf)."""
    rs = _ranks(ranks, case)
    drift = tadam.parity_bound(W._gspmd_run(case, "").train, _lrs(ranks, case))
    fmt = W.GSPMD_QUANT.get(case)
    for path in tpt.tree_paths(rs[0]["params"]):
        got = _join(rs, "params", "param", path)
        want = ranks.ref[f"{case}/params/{_keystr(path)}"]
        assert got.shape == want.shape, (path, got.shape, want.shape)
        q = _quant_step(want, fmt) if fmt else 0.0
        diff = np.abs(got - want)
        assert (diff <= drift + q + 2**-8 * (np.abs(want) + np.abs(got))).all(), (
            case, path, diff.max())
        mean = 2**-5 * sum(_lrs(ranks, case)) + 2 * _grid_effect(ranks, case, _keystr(path))
        assert diff.mean() <= mean, (case, path, diff.mean())


@pytest.mark.parametrize("case", ["nvme_stage3_2x1", "nvme_cp_1x2"])
def test_in_graph_optimizer_states_match_reference(ranks, case):
    """With params on NVMe the in-graph update keeps its masters and
    moments in the state: joined over the ranks, the masters within the
    drift bound of the reference's, m and v within ``MOMENT_REL``."""
    rs = _ranks(ranks, case)
    drift = tadam.parity_bound(W._gspmd_run(case, "").train, _lrs(ranks, case))
    assert all(int(r["opt"][0]) == W.GSPMD_STEPS for r in rs)
    for path in tpt.tree_paths(rs[0]["opt"][1]):
        name = _keystr(path)
        for i, what in ((1, "master"), (2, "m"), (3, "v")):
            got = _np(tpt.join_leaf([tpt.tree_get(r["opt"][i], path) for r in rs],
                                    _dims(rs[0], "opt", path), rs[0]["sizes"]))
            want = ranks.ref[f"{case}/{what}/{name}"]
            if what == "master":
                assert np.abs(got - want).max() <= drift, (case, path)
            else:
                rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
                assert rel <= MOMENT_REL, (case, path, what, rel)


@pytest.mark.parametrize("case", CASES)
def test_store_keys_are_the_references_under_the_rank_and_hold_its_shard(ranks, case):
    """Rank r's param store holds ``rank<r>/<keystr>/c0`` for every key of
    the reference's store, in its own directory; each key the bytes of the
    rank's shard (bf16: its elements' bytes; q8 / q4: ``wire_nbytes`` of
    the shard, its own header and pad block), and the reference's each the
    whole leaf's."""
    rs = _ranks(ranks, case)
    ref_keys = list(ranks.ref[f"{case}/param_store_keys"])
    ref_bytes = dict(zip(ref_keys, ranks.ref[f"{case}/param_store_bytes"]))
    fmt = W.GSPMD_QUANT.get(case)
    for rank, r in enumerate(rs):
        assert sorted(r["param_store"]) == sorted(f"rank{rank}/{k}" for k in ref_keys)
        for path in tpt.tree_paths(r["init_decoded"]):
            name = f"{_keystr(path)}/c0"
            shard = tpt.tree_get(r["init_decoded"], path)
            whole = ranks.ref[f"{case}/init_decoded/{_keystr(path)}"]
            if fmt:
                want = qformat.wire_nbytes(shard.shape, shard.dtype, fmt)
                want_whole = qformat.wire_nbytes(whole.shape, shard.dtype, fmt)
            else:
                want = shard.numel() * shard.element_size()
                want_whole = whole.size * shard.element_size()
            assert r["param_store"][f"rank{rank}/{name}"] == want, (case, rank, name)
            assert int(ref_bytes[name]) == want_whole, (case, name)


def _leaf_bytes(rs, cls, per_elem=None):
    """{keystr: (whole bytes, the ranks holding a copy of each part)} of
    the state class ``cls`` (``per_elem`` bytes an element, else the
    param dtype's)."""
    out = {}
    for path in tpt.tree_paths(rs[0]["init_decoded"]):
        whole = math.prod(tpt.join_leaf([tpt.tree_get(r["init_decoded"], path) for r in rs],
                                        _dims(rs[0], "param", path), rs[0]["sizes"]).shape)
        size = per_elem or tpt.tree_get(rs[0]["init_decoded"], path).element_size()
        dims = _dims(rs[0], cls, path)
        parts = math.prod(rs[0]["sizes"][a] for a, d in dims.items() if d is not None)
        out[_keystr(path)] = (whole * size, len(rs) // parts)
    return out


@pytest.mark.parametrize("case", CASES)
def test_rank_counters_and_their_sums_against_the_reference(ranks, case):
    """Each step every rank reads and writes its shards' bytes once
    (``param_in`` = ``param_out`` = ``param_total_bytes``, the rank's;
    their wire bytes the shards' frames under q8 / q4), drains its
    gradient in the optimizer's spec (f32) and streams its opt-spec
    shards (f32 master, m, v); summed over the ranks
    (``_all_ranks``) each counter is the reference's plus the copies of the
    leaves more than one rank holds whole (named here: the stage-1 params,
    under tensor parallelism the leaves whole over the model axis)."""
    rs = _ranks(ranks, case)
    fmt = W.GSPMD_QUANT.get(case)
    counters = {("param", None): ("param_in_bytes", "param_out_bytes"),
                ("opt", 4): ("grad_out_bytes",), ("opt", 12): ("opt_read_bytes", "opt_write_bytes")}
    dup_leaves = {}
    for step in range(W.GSPMD_STEPS):
        ms = [r["metrics"][step] for r in rs]
        for rank, (r, m) in enumerate(zip(rs, ms)):
            shards = [tpt.tree_get(r["init_decoded"], p) for p in tpt.tree_paths(r["init_decoded"])]
            total = sum(t.numel() * t.element_size() for t in shards)
            assert m["param_in_bytes"] == m["param_out_bytes"] == m["param_total_bytes"] == total
            wire = (sum(qformat.wire_nbytes(t.shape, t.dtype, fmt) for t in shards) if fmt
                    else total)
            assert m["param_in_wire_bytes"] == m["param_out_wire_bytes"] == wire, (case, rank)
            assert m["param_total_bytes_all_ranks"] == sum(x["param_total_bytes"] for x in ms)
        for (cls, per_elem), keys in counters.items():
            leaves = _leaf_bytes(rs, cls, per_elem)
            dups = {k: (b, n) for k, (b, n) in leaves.items() if n > 1}
            dup_leaves[cls] = sorted(dups)
            for key in keys:
                if f"{case}/ctr/{key}" not in ranks.ref:
                    assert key not in ms[0], (case, key)
                    continue
                ref = int(ranks.ref[f"{case}/ctr/{key}"][step])
                assert ref == sum(b for b, _ in leaves.values()), (case, key)
                assert all(m[f"{key}_all_ranks"] == sum(x[key] for x in ms) for m in ms)
                assert ms[0][f"{key}_all_ranks"] == ref + sum(b * (n - 1)
                                                              for b, n in dups.values()), key
    stage, model = W.NVME_MESH_CASES[case][3], W.NVME_MESH_CASES[case][1]
    if stage == 3 and model == 1:  # every leaf of the smoke smollm splits over dp 2
        assert not any(dup_leaves.values()), dup_leaves
    if stage == 1:  # params whole on both ranks, the optimizer split
        assert dup_leaves["param"] and not dup_leaves["opt"]


@pytest.mark.parametrize("case", CASES)
def test_peak_resident_param_bytes_stay_within_the_window(ranks, case):
    """The leaf scheduler stages at most its window of the rank's shards
    at once: the peak is positive and at most the window's largest shards
    (``prefetch_layers or max(2, read_ahead)`` leaves, 2 here), below the
    rank's total, and at most the reference's peak over whole leaves."""
    rs = _ranks(ranks, case)
    for r in rs:
        sizes = sorted((t.numel() * t.element_size() for t in
                        map(lambda p: tpt.tree_get(r["init_decoded"], p),
                            tpt.tree_paths(r["init_decoded"]))), reverse=True)
        for step, m in enumerate(r["metrics"]):
            peak = m["peak_resident_param_bytes"]
            assert 0 < peak <= sum(sizes[:2]) < m["param_total_bytes"], (case, peak)
            assert peak <= int(ranks.ref[f"{case}/ctr/peak_resident_param_bytes"][step])


@pytest.mark.parametrize("case", QUANT)
def test_decoded_shards_against_the_references_decoded_leaves(ranks, case):
    """Each rank's shards as its store decodes them before a step, joined,
    against the reference's decode of the whole leaves: bit for bit where
    the shards sit on the whole leaf's grid (``grid_aligned``), within one
    step of the format's grid where they do not (``MISALIGNED`` is such a
    leaf and differs)."""
    rs = _ranks(ranks, case)
    fmt = W.GSPMD_QUANT[case]
    init = torch.load(W.gspmd_init_path(ranks.tmp, case), weights_only=False)
    aligned = []
    for path in tpt.tree_paths(rs[0]["init_decoded"]):
        name = _keystr(path)
        got = _join(rs, "init_decoded", "param", path)
        want = ranks.ref[f"{case}/init_decoded/{name}"]
        dims = _dims(rs[0], "param", path)
        cuts = {d: rs[0]["sizes"][a] for a, d in dims.items() if d is not None}
        if qformat.grid_aligned(want.shape, cuts):
            aligned.append(name)
            np.testing.assert_array_equal(got, want, err_msg=f"{case} {name}")
        else:
            x = _np(tpt.tree_get(init, path))
            diff = np.abs(got - want)
            assert (diff <= _quant_step(x, fmt) + 2**-8 * np.abs(x)).all(), (name, diff.max())
            if name == MISALIGNED:
                assert diff.max() > 0, name
    assert aligned and MISALIGNED not in aligned, aligned


def test_the_grid_rule_against_encodes_of_cut_leaves():
    """``grid_aligned`` against the codec itself: a shard's frame decodes
    to the slice of the whole leaf's decode exactly when the rule says
    so, for cuts along each dim of a (2, 48, 64) leaf and across two dims;
    ``wire_nbytes`` is each frame's length."""
    x = torch.randn(2, 48, 64, generator=torch.Generator().manual_seed(5)).to(torch.bfloat16)
    for fmt in ("q8", "q4"):
        whole = qformat.decode_array(qformat.encode_array(x, fmt))
        assert qformat.encode_array(x, fmt).numel() == qformat.wire_nbytes(x.shape, x.dtype, fmt)
        for cuts in ({0: 2}, {1: 2}, {2: 2}, {2: 4}, {1: 3}, {1: 2, 2: 4}, {0: 2, 1: 3}):
            dims = {f"a{d}": d for d in cuts}
            sizes = {f"a{d}": n for d, n in cuts.items()}
            shard = x
            for a, d in dims.items():
                shard = tpt.shard_leaf(shard, d, 1, sizes[a])
            frame = qformat.encode_array(shard, fmt)
            assert frame.numel() == qformat.wire_nbytes(shard.shape, shard.dtype, fmt)
            want = whole
            for a, d in dims.items():
                want = tpt.shard_leaf(want, d, 1, sizes[a])
            same = torch.equal(qformat.decode_array(frame), want)
            assert same == qformat.grid_aligned(x.shape, cuts), (fmt, cuts)


def _fake_rank(data, model):
    from repro_torch.launch import mesh as mesh_mod

    return mesh_mod.LocalMesh(data, model, 0, data * model, torch.device("cpu"), None, "gloo")


@pytest.mark.parametrize("stage,data,model", [(3, 2, 1), (1, 2, 1), (3, 1, 2), (3, 2, 2)])
def test_plan_step_predictions_are_the_ranks_share(stage, data, model):
    """The plan counts the model's slow-tier bytes once; beside a rank's
    counters the executor puts the rank's share of them
    (``engine.shard_share``: its elements of the class's spec over the
    model's), so a rank's bytes are never held to a global prediction.
    The shares sum over the ranks to 1 plus the duplicates of the leaves
    more than one rank holds whole (none at ZeRO-3 on (2, 1) for the
    smoke smollm; the params at stage 1; under context parallelism the
    leaves whole over the model axis, ``unsplit_leaves``)."""
    from repro_torch import configs as tconfigs
    from repro_torch.config import RunConfig, make_offload, make_parallel
    from repro_torch.core import executor as texec

    run = RunConfig(model=tconfigs.smoke("smollm-135m"),
                    parallel=make_parallel("pjit", zero_stage=stage),
                    offload=make_offload(param_tier="nvme", opt_tier="nvme"))
    plan = types.SimpleNamespace(
        predictions={"param_step_read_bytes": 2e6, "param_step_write_bytes": 1e6,
                     "param_step_read_wire_bytes": 2e6, "param_step_write_wire_bytes": 1e6,
                     "opt_step_read_bytes": 6e6, "opt_step_write_bytes": 6e6},
        hardware=types.SimpleNamespace(n_devices=data * model))
    ex = texec.InfinityExecutor(run, "cpu", plan=plan, mesh=_fake_rank(data, model))
    eng = ex.engine
    out = ex._with_plan_crosscheck({"param_in_bytes": 1, "opt_read_bytes": 1})
    for cls, total in (("param", 3e6), ("opt", 12e6)):
        share = eng.shard_share(cls)
        assert out[f"plan_{cls}_step_bytes"] == total * share
        defs = eng.bundle.defs
        whole = {_keystr(p): math.prod(tpt.tree_get(defs, p).shape) for p in tpt.tree_paths(defs)}
        copies = {}
        for p in tpt.tree_paths(defs):
            parts = math.prod(eng.sizes[a] for a, s in (("data", eng.splits[cls]),
                                                        ("model", eng.model_splits))
                              if tpt.tree_get(s, p) is not None)
            copies[_keystr(p)] = data * model // parts
        # every rank's share is rank 0's: the ranks' sum is 1 plus the duplicates
        summed = data * model * share
        assert summed == pytest.approx(1 + sum(whole[k] * (c - 1) for k, c in copies.items())
                                       / sum(whole.values()))
        if cls == "param" and stage == 3 and model == 1:
            assert share == 0.5 and not eng.unsplit_leaves("param")
        if cls == "param" and stage == 1:
            assert share == 1.0
    assert out["plan_param_step_wire_bytes"] == 3e6 * eng.shard_share("param")
