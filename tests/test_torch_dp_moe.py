"""The port's layered epoch with MoE expert rows and with q8/q4 rows on
data-parallel ranks, and its GSPMD engine on the MoE family on a mesh, one
process per rank over ``torch.distributed`` (gloo, on the CPU), against the
JAX package's ``InfinityExecutor`` on a mesh of as many host devices.

Two sides, started together by the module's fixture:

* the reference (``tests/torch_dp_reference.py dp_moe``): one subprocess
  with four host devices, every case of ``torch_dp_worker.LAYERED_CASES``
  (the explicit engine, every state class on NVMe) and of
  ``torch_dp_worker.MOE_GSPMD_CASES`` (the pjit engine) on a mesh of its
  dp;
* the port (``tests/torch_dp_worker.py dp_moe``, which imports no JAX): 2
  ranks for the dp-2 cases and the units, 4 for the dp-4 ones, each rank
  its own process joined through a file store, each spawn killed and
  failed after ``TIMEOUT`` s. The port at one rank runs the MoE cases'
  one-rank baselines (the ``_dp1`` cases, which the reference runs on one
  device) on the same global batches in this process meanwhile.

Both start from the reference's initial state drawn at one device (its
rows padded for the case's dp, each rank keeping its slices), on the same
global batches (each rank its rows). Cases: the smoke granite (2 layers,
8 experts, top-2) at dp 2 and 4; the smoke smollm cut to 2 layers under
q8 with its slices off the quant grid (dp 2), on it (d_model 64, dp 2) and
off it at dp 4 (d_model 47); q4 at dp 2; granite under q8 at dp 2; and the
GSPMD engine on granite at ZeRO-3 with one microbatch and two.

Tolerances are imported from where the one-rank tests keep them: the
layered MoE run's ``LOSS_TOL`` / ``GNORM_TOL`` and its routing statistics
within one assignment per layer (``tests/test_torch_moe_paging.py``), q8
and q4 rows' ``TIER_TOL`` times ``QUANT_FACTOR`` with each row's quant step
(``tests/test_torch_training.py``; the moments' ``MOMENT_REL`` takes the
grad norm's factor), ``TIER_TOL`` / ``MOMENT_REL`` of
``tests/test_torch_zero3_step.py`` and ``tests/test_torch_gspmd.py``, and
``adam.parity_bound``. The tier counters summed over the ranks equal the
reference's exactly.

MoE routes discretely: where the two frameworks' bf16 activations round a
token's k-th and (k+1)-th gates apart, a token goes to another expert (on
these batches already at one rank, two assignments at the first step). So
what the routing steers -- the statistics, the expert rows' mean drift,
their moments, the popularity predictor's reads -- is held as a gap: the
port at dp N is no further from the reference at dp N than the port at one
rank is from the reference on one device (exactly, for the byte counters),
plus the imported tolerance; the port at dp N against the port at one rank
is held directly.
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
from repro.config import make_offload as jmake_offload  # noqa: E402
from repro.config import make_parallel as jmake_parallel  # noqa: E402
from repro.core import qformat as jq  # noqa: E402
from repro.core.zero import ExplicitZero3Engine as JEngine  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core import qformat as tq  # noqa: E402
from repro_torch.core.zero import ExplicitZero3Engine  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from test_torch_gspmd import TIER_TOL as GSPMD_TOL  # noqa: E402
from test_torch_moe_paging import GNORM_TOL, LOSS_TOL  # noqa: E402
from test_torch_training import QUANT_FACTOR  # noqa: E402
from test_torch_zero3_step import MOMENT_REL, TIER_TOL  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
LAYERED = [c for c, spec in W.LAYERED_CASES.items() if spec[0] > 1]
GSPMD = [c for c, spec in W.MOE_GSPMD_CASES.items() if spec[0] > 1]
ONE_RANK = [c for c, spec in {**W.LAYERED_CASES, **W.MOE_GSPMD_CASES}.items() if spec[0] == 1]
TIMEOUT = 240.0


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _quant(case) -> str:
    return W.LAYERED_CASES[case][3]


def _is_moe(case) -> bool:
    spec = W.LAYERED_CASES.get(case) or W.MOE_GSPMD_CASES[case]
    return spec[1] == "granite-moe-1b-a400m"


def _baseline(case):
    """The one-rank case of a MoE case's config and global batches."""
    if not _is_moe(case):
        return None
    return case.rsplit("_dp", 1)[0] + "_dp1"


def _save_layered_init(tmp: str, case: str) -> None:
    """The reference engine's initial state at one device, its rows padded
    to the case's dp (zeros, as the reference pads), as the port's
    tensors: what every rank of both sides starts from."""
    dp = W.LAYERED_CASES[case][0]
    jrun = JRun(model=W.layered_cfg(case, jconfigs), parallel=jmake_parallel("zero3"),
                offload=jmake_offload(param_tier="nvme", grad_tier="nvme", opt_tier="nvme"))
    eng = JEngine(jrun, make_local_mesh(1, 1))
    init = jax.tree.map(np.asarray, eng.init_state(jax.random.PRNGKey(0)))
    state = bridge.zero3_state_from_numpy({k: init[k] for k in ("flat", "eflat", "other",
                                                                 "other_opt", "step")
                                           if k in init})
    for key in ("flat", "eflat"):
        if key in state:
            state[key] = torch.nn.functional.pad(state[key], (0, (-state[key].shape[1]) % dp))
    torch.save(state, W.layered_init_path(tmp, case))


def _save_gspmd_init(tmp: str) -> None:
    """The GSPMD cases' initial params: the reference bundle's init at one
    device, as the port's whole tensors."""
    params = None
    for case in W.MOE_GSPMD_CASES:
        if params is None:
            cfg = W.gspmd_cfg(case, jconfigs)
            params = bridge.params_from_numpy(jax.tree.map(
                np.asarray, jax.jit(jreg.build(cfg).init)(jax.random.PRNGKey(0))))
        torch.save(params, W.gspmd_init_path(tmp, case))


@pytest.fixture(scope="module")
def dpm(tmp_path_factory):
    """The reference's ``.npz``, per world size each rank's saved dict, and
    the port's one-rank baselines (``ONE_RANK``)."""
    tmp = str(tmp_path_factory.mktemp("dp_moe"))
    ref_path = os.path.join(tmp, "ref.npz")
    for case in W.LAYERED_CASES:
        _save_layered_init(tmp, case)
    _save_gspmd_init(tmp)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    ref = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dp_reference.py"),
                            tmp, ref_path, "dp_moe"], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = {world: pool.submit(W.spawn, "dp_moe", world, tmp, TIMEOUT)
                    for world in (2, 4)}
            one_mesh = mesh_mod.make_local_mesh(1, 1, "cpu")
            one = {case: (W.run_layered_case if case in W.LAYERED_CASES
                          else W.run_gspmd_case)(case, tmp, one_mesh) for case in ONE_RANK}
            ranks = {world: f.result() for world, f in runs.items()}
        log, _ = ref.communicate(timeout=TIMEOUT)
    except BaseException:
        ref.kill()
        ref.communicate()
        raise
    assert ref.returncode == 0, log[-4000:]
    yield types.SimpleNamespace(ref=dict(np.load(ref_path)), ranks=ranks, one=one, tmp=tmp)


def _ranks(dpm, case):
    spec = W.LAYERED_CASES.get(case) or W.MOE_GSPMD_CASES[case]
    if spec[0] == 1:
        return [dpm.one[case]]
    return [r[case] for r in dpm.ranks[spec[0]]]


def _lrs(dpm, case):
    return list(dpm.ref[f"{case}/lr"])


def _one_assignment(case) -> float:
    """One routed assignment of a layer's global (micro)batch, the routing
    statistics' tolerance (``tests/test_torch_moe_paging.py``)."""
    spec = W.LAYERED_CASES.get(case)
    if spec is not None:
        return 1.0 / (W.B * W.S * tconfigs.smoke(spec[1]).top_k) + 1e-6
    _, arch, *_, accum, B = W.MOE_GSPMD_CASES[case]
    return 1.0 / (B // accum * W.S * tconfigs.smoke(arch).top_k) + 1e-6


def _check_routing(dpm, case, step):
    """Every rank reports one value, the global batch's, no further from
    the reference's than the one-rank run is from the reference on one
    device, plus one assignment."""
    metrics = [r["metrics"][step] for r in _ranks(dpm, case)]
    base = _baseline(case)
    for key in ("moe_dropped_token_fraction", "moe_expert_load"):
        got = [np.asarray(m[key], np.float64) for m in metrics]
        assert all(np.array_equal(g, got[0]) for g in got), (case, key)
        gap = np.abs(np.asarray(dpm.one[base]["metrics"][step][key], np.float64)
                     - dpm.ref[f"{base}/{key}"][step])
        diff = np.abs(got[0] - dpm.ref[f"{case}/{key}"][step])
        assert (diff <= gap + _one_assignment(case)).all(), (case, key, step, diff, gap)
    load = np.asarray(metrics[0]["moe_expert_load"])
    assert load.shape == (tconfigs.smoke("granite-moe-1b-a400m").n_experts,)
    assert abs(load.sum() - 1.0) < 1e-6


# ---------------------------------------------------------------------------
# the layered epoch: MoE expert rows and q8/q4 rows on the ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", LAYERED)
def test_both_sides_start_from_the_same_rows(dpm, case):
    """The reference's own init at the case's dp is the rows the ranks
    slice, bit for bit (the same draw, padded with the same zeros)."""
    init = torch.load(W.layered_init_path(dpm.tmp, case), weights_only=False)
    keys = ("flat", "eflat") if _is_moe(case) else ("flat",)
    for key in keys:
        want = dpm.ref[f"{case}/init_{key}"]
        assert want.shape[1] % W.LAYERED_CASES[case][0] == 0
        np.testing.assert_array_equal(_np(init[key]), want, err_msg=f"{case} {key}")
    if case == "q8_layered_dp4":
        assert want.shape[1] == 24_160 and not want[:, 24_158:].any()


@pytest.mark.parametrize("step", range(W.STEPS))
@pytest.mark.parametrize("case", LAYERED)
def test_layered_step_matches_reference(dpm, case, step):
    """Loss, grad norm and lr, one value on every rank, against the
    reference's; MoE's routing statistics the global batch's."""
    ranks = _ranks(dpm, case)
    metrics = [r["metrics"][step] for r in ranks]
    for key in ("loss", "grad_norm", "lr"):
        got = [m[key] for m in metrics]
        assert len(set(got)) == 1, (case, key, got)
        if _is_moe(case):
            tol = {"loss": LOSS_TOL, "grad_norm": GNORM_TOL, "lr": TIER_TOL}[key]
        else:
            tol = {k: v * QUANT_FACTOR[_quant(case)][key] for k, v in TIER_TOL.items()}
        np.testing.assert_allclose(got[0], dpm.ref[f"{case}/{key}"][step], **tol,
                                   err_msg=f"{case} {key}")
    if _is_moe(case):
        _check_routing(dpm, case, step)


def _quant_steps(want: np.ndarray, dp: int, quant: str) -> np.ndarray:
    """Each element's quant step under ``quant`` (0 where none): a row's
    slices each encode in blocks of 32 from their first element; one step
    is the block's absmax/127 (q8) or range/15 (q4)."""
    if quant == "none":
        return np.zeros_like(want)
    out = []
    for part in np.split(want, dp, axis=1):
        n = part.shape[1]
        blocks = np.pad(part, ((0, 0), (0, (-n) % 32))).reshape(part.shape[0], -1, 32)
        step = (np.abs(blocks).max(-1) / 127.0 if quant == "q8"
                else (blocks.max(-1) - blocks.min(-1)) / 15.0)
        out.append(np.repeat(step, 32, axis=1)[:, :n])
    return np.concatenate(out, axis=1)


def _gathered_rows(dpm, case, key) -> np.ndarray:
    return np.concatenate([_np(r["rows"][key]) for r in _ranks(dpm, case)], axis=1)


@pytest.mark.parametrize("case", LAYERED)
def test_rows_after_the_last_step_match_reference(dpm, case):
    """The ranks' dense and expert rows read back from their param stores,
    put together by columns and slice by slice against the reference's
    rows and its rank slices: the drift bound plus each side's bf16
    rounding and, quantized, two quant steps of the slice's block (each
    side re-encodes its own rows); the mean by ``QUANT_FACTOR`` times 2^-5
    * sum(lr), for MoE beyond the one-rank run's mean gap to the
    reference (rerouted experts' rows differ by whole tokens)."""
    ranks, dp, quant = _ranks(dpm, case), W.LAYERED_CASES[case][0], _quant(case)
    lrs, base = _lrs(dpm, case), _baseline(case)
    drift = tadam.parity_bound(W.layered_run(case, "").train, lrs)
    mean_bound = QUANT_FACTOR.get(quant, {"rows": 1})["rows"] * 2**-5 * sum(lrs)
    for key in ("flat", "eflat") if _is_moe(case) else ("flat",):
        want = dpm.ref[f"{case}/{key}"]
        slices = [_np(r["rows"][key]) for r in ranks]
        assert all(s.shape == (want.shape[0], want.shape[1] // dp) for s in slices)
        got = np.concatenate(slices, axis=1)
        allowed = (drift + 2**-8 * (np.abs(want) + np.abs(got))
                   + 2 * _quant_steps(want, dp, quant))
        diff = np.abs(got - want)
        assert (diff <= allowed).all(), (case, key, diff.max())
        gap = 0.0
        if base is not None:
            gap = np.abs(_gathered_rows(dpm, base, key) - dpm.ref[f"{base}/{key}"]).mean()
        assert diff.mean() <= gap + mean_bound, (case, key, diff.mean(), gap)
        for r, (s, w, a) in enumerate(zip(slices, np.split(want, dp, axis=1),
                                          np.split(allowed, dp, axis=1))):
            assert (np.abs(s - w) <= a).all(), (case, key, r)


def _moments(dpm, case, port: bool) -> dict:
    """Each row's (dense ``rank``/l<i> or expert ``xrank``/l<j>) m and v, its
    ranks' slices put together in rank order, from the port's opt stores
    or the reference's."""
    dp = W.LAYERED_CASES[case][0]
    out: dict = {}
    for r in range(dp):
        for kind in ("rank", "xrank"):
            for i in range(10_000):
                key = f"{kind}{r}/l{i}"
                if port:
                    states = _ranks(dpm, case)[r]["opt"].get(key)
                    if states is None:
                        break
                    m, v = _np(states[1]), _np(states[2])
                else:
                    if f"{case}/opt/{key}/m" not in dpm.ref:
                        break
                    m, v = (dpm.ref[f"{case}/opt/{key}/{w}"] for w in ("m", "v"))
                row = out.setdefault((kind, i), {"m": [], "v": []})
                row["m"].append(m)
                row["v"].append(v)
    return {k: {w: np.concatenate(parts) for w, parts in row.items()} for k, row in out.items()}


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("case", LAYERED)
def test_opt_store_states_match_reference(dpm, case):
    """The ranks' opt stores together hold the reference's keys
    (``rank<r>/l<i>``, ``xrank<r>/l<l * E + e>``); each key's f32 master
    within the drift bound; each row's m and v within ``MOMENT_REL`` in
    norm (quantized: times ``QUANT_FACTOR``'s grad-norm factor). Under MoE
    a rerouted token moves an expert's and its layer's moments by whole
    tokens' gradients, so the rows' m and v are held together, beyond the
    one-rank run's gap. 'other' the same on every rank within the drift
    bound of the reference's."""
    ranks = _ranks(dpm, case)
    assert sorted(k for r in ranks for k in r["opt_keys"]) == list(dpm.ref[f"{case}/opt_keys"])
    drift = tadam.parity_bound(W.layered_run(case, "").train, _lrs(dpm, case))
    seen = 0
    for rank, r in enumerate(ranks):
        for key, (master, _, _) in r["opt"].items():
            assert key.split("/")[0] in (f"rank{rank}", f"xrank{rank}"), key
            want = dpm.ref[f"{case}/opt/{key}/master"]
            assert np.abs(_np(master) - want).max() <= drift, (case, key)
            seen += 1
    assert seen == len([k for k in dpm.ref if k.startswith(f"{case}/opt/")
                        and k.endswith("/master")])
    quant, base = _quant(case), _baseline(case)
    rel_bound = MOMENT_REL * QUANT_FACTOR.get(quant, {"grad_norm": 1})["grad_norm"]
    got, want = _moments(dpm, case, True), _moments(dpm, case, False)
    assert sorted(got) == sorted(want)
    for name in ("m", "v"):
        if base is None:
            for row in got:
                rel = _rel(got[row][name], want[row][name])
                assert rel <= rel_bound, (case, row, name, rel)
            continue
        one, one_ref = _moments(dpm, base, True), _moments(dpm, base, False)
        rows = sorted(got)
        joined = [np.concatenate([t[row][name] for row in rows])
                  for t in (got, want, one, one_ref)]
        gap = _rel(joined[2], joined[3])
        rel = _rel(joined[0], joined[1])
        assert rel <= gap + rel_bound, (case, name, rel, gap)
    for path in tpt.tree_paths(ranks[0]["other"]):
        got = [_np(tpt.tree_get(r["other"], path)) for r in ranks]
        assert all(np.array_equal(g, got[0]) for g in got), (case, path)
        want = dpm.ref[f"{case}/other/{_keystr(path)}"]
        assert (np.abs(got[0] - want) <= drift + 2**-8 * np.abs(want)).all(), (case, path)
    assert all(r["step"] == W.STEPS for r in ranks)


@pytest.mark.parametrize("case", LAYERED)
def test_tier_and_expert_counters_summed_over_ranks_match_reference(dpm, case):
    """Each rank counts its own bytes (the expert rows' slices too:
    ``expert_total_bytes``, reads, residency), a dp-th of the step's; their
    sum over the ranks (``<counter>_all_ranks``) is the reference's
    exactly, for MoE beyond the one-rank run's exact gap to the reference
    on one device (the popularity predictor reads what the routing made
    popular: where the frameworks route a token apart, it prefetches other
    rows), that is: the ranks' sum is the one-rank run's count (the wire
    bytes of those extra rows counted in the dp ranks' frames). Under q8
    the port keeps a row resident as its wire bytes where the reference
    decodes it on the host: the residency peak is the reference's or
    less."""
    ranks, base = _ranks(dpm, case), _baseline(case)
    keys = sorted(k[len(f"{case}/ctr/"):] for k in dpm.ref if k.startswith(f"{case}/ctr/"))
    want_keys = {"param_in_bytes", "param_out_bytes", "grad_out_bytes", "opt_read_bytes",
                 "opt_write_bytes", "peak_resident_param_bytes", "param_total_bytes"}
    if _is_moe(case):
        want_keys |= {"expert_total_bytes", "expert_peak_resident_bytes"}
    if _quant(case) != "none":
        want_keys |= {"param_in_wire_bytes", "param_out_wire_bytes"}
    assert want_keys <= set(keys), want_keys - set(keys)
    if base is not None:  # an expert row's logical bytes, and its wire bytes at dp
        dp, Pe = len(ranks), ExplicitZero3Engine(W.layered_run(case, ""), "cpu").elayout.padded
        row = 2 * Pe
        if _quant(case) == "none":
            wire = {dp: row, 1: row}
        else:
            wire = {n: n * tq.encode_array(torch.zeros(Pe // n, dtype=torch.bfloat16),
                                           _quant(case)).numel() for n in (dp, 1)}
    for step in range(W.STEPS):
        if base is not None:  # the expert rows the one-rank run read beyond the reference's
            extra, rest = divmod(dpm.one[base]["metrics"][step]["param_in_bytes"]
                                 - int(dpm.ref[f"{base}/ctr/param_in_bytes"][step]), row)
            assert rest == 0, (case, step)
        for key in keys:
            mine = [r["metrics"][step][key] for r in ranks]
            assert all(r["metrics"][step][f"{key}_all_ranks"] == sum(mine) for r in ranks), key
            want = int(dpm.ref[f"{case}/ctr/{key}"][step])
            if base is not None and key in ("param_in_wire_bytes", "nvme_bytes_read"):
                # a row read crosses as dp frames, each with its header
                assert (dpm.one[base]["metrics"][step][key]
                        - int(dpm.ref[f"{base}/ctr/{key}"][step])) == extra * wire[1]
                want += extra * wire[dp]
            elif base is not None:
                want += (dpm.one[base]["metrics"][step][key]
                         - int(dpm.ref[f"{base}/ctr/{key}"][step]))
            if _quant(case) == "q8" and key == "peak_resident_param_bytes":
                assert sum(mine) <= int(dpm.ref[f"{case}/ctr/{key}"][step]), (case, step)
            else:
                assert sum(mine) == want, (case, step, key)
            if "peak" not in key:
                assert len(set(mine)) == 1, (case, key, mine)


def test_q8_ranks_take_the_quantized_matmul_where_the_grid_allows(dpm):
    """The planned MLP leaves on the ranks: at the smoke width ``w_gate``
    straddles the two slices, whose grids do not join (the second starts 16
    elements off the row's grid) and ``w_in`` starts off its slice's grid:
    none; at dp 4 (d_model 47) none; at d_model 64 the slices join
    seamlessly and the plan is the one-rank plan, ``w_gate`` across the
    boundary included."""
    mlp = (("mlp", "w_gate"), ("mlp", "w_in"), ("mlp", "w_out"))
    want = {"q8_layered_dp2": (), "q8_layered_dp4": (), "moe_q8_layered_dp2": (),
            "q8_layered_dp2_aligned": mlp, "q4_layered_dp2": ()}
    for case, plan in want.items():
        assert all(tuple(r["quantized_leaves"]) == plan for r in _ranks(dpm, case)), case


@pytest.mark.parametrize("case", ["moe_layered_dp2", "moe_layered_dp4", "moe_q8_layered_dp2",
                                  "moe_stage3_dp2", "moe_accum2_dp2"])
def test_moe_statistics_on_ranks_are_the_one_rank_runs(dpm, case):
    """The port at dp N against the port at one rank on the same global
    batches: the first step's routing statistics bit for bit (each rank
    routes its whole sequences as the one rank does, and the counts are
    summed before the ratios), every step's within one assignment, loss
    and grad norm by the MoE tolerances."""
    ltol, gtol = (LOSS_TOL, GNORM_TOL) if case in W.LAYERED_CASES else (GSPMD_TOL, GSPMD_TOL)
    two, one = _ranks(dpm, case)[0]["metrics"], dpm.one[_baseline(case)]["metrics"]
    assert len(two) == len(one)
    for step, (a, b) in enumerate(zip(two, one)):
        for key in ("moe_dropped_token_fraction", "moe_expert_load"):
            if step == 0:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{case} {key}")
            np.testing.assert_allclose(a[key], b[key], atol=_one_assignment(case))
        np.testing.assert_allclose(a["loss"], b["loss"], **ltol)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], **gtol)


# ---------------------------------------------------------------------------
# the GSPMD engine on the MoE family
# ---------------------------------------------------------------------------


def _whole(shards, splits, cls, path) -> np.ndarray:
    return _np(tpt.unshard_leaf([tpt.tree_get(s, path) for s in shards],
                                tpt.tree_get(splits[cls], path)))


def _within(got, want, drift, what):
    diff = np.abs(got - want)
    assert (diff <= drift + 2**-8 * (np.abs(want) + np.abs(got))).all(), (what, diff.max())


@pytest.mark.parametrize("step", range(W.GSPMD_STEPS))
@pytest.mark.parametrize("case", GSPMD)
def test_gspmd_moe_step_matches_reference(dpm, case, step):
    """Loss and grad norm summed over the ranks and the lr against the
    reference's pjit step by ``TIER_TOL``; the routing statistics (averaged
    over the microbatches under ``grad_accum``) the global batch's."""
    metrics = [r["metrics"][step] for r in _ranks(dpm, case)]
    for key in ("loss", "grad_norm", "lr"):
        got = [m[key] for m in metrics]
        assert len(set(got)) == 1, (case, key, got)
        np.testing.assert_allclose(got[0], dpm.ref[f"{case}/{key}"][step], **GSPMD_TOL,
                                   err_msg=f"{case} {key}")
    _check_routing(dpm, case, step)


@pytest.mark.parametrize("case", GSPMD)
def test_gspmd_moe_params_and_optimizer_match_reference(dpm, case):
    """The params put back together from the ranks' shards (the expert
    leaves split as ``moe_zero_stage`` lays them out) and each rank's shard
    against XLA's addressable shard on its device: the drift bound plus
    each side's bf16 rounding, every element (the one-rank MoE step's
    bound, ``tests/test_torch_moe_paging.py``); the masters within the
    drift bound. A rerouted token moves the router's and the leaves' before
    it by whole tokens, so the params' mean gap (by 2^-5 * sum(lr)) and m
    and v (by ``MOMENT_REL``) are held over every leaf together, beyond the
    one-rank run's gap."""
    rs, base = _ranks(dpm, case), _baseline(case)
    one = _ranks(dpm, base)[0]
    splits, lrs = rs[0]["splits"], _lrs(dpm, case)
    drift = tadam.parity_bound(W._gspmd_run(case, "").train, lrs)
    assert any(tpt.tree_get(splits["param"], p) is not None
               for p in tpt.tree_paths(splits["param"]) if p[:2] == ("blocks", "moe"))
    paths = tpt.tree_paths(rs[0]["params"])
    for path in paths:
        name = _keystr(path)
        _within(_whole([r["params"] for r in rs], splits, "param", path),
                dpm.ref[f"{case}/params/{name}"], drift, (case, path))
        for rank, r in enumerate(rs):
            got = _np(tpt.tree_get(r["params"], path))
            want = dpm.ref[f"{case}/params_shard{rank}/{name}"]
            assert got.shape == want.shape, (case, rank, path)
            _within(got, want, drift, (case, rank, path))
            master = _np(tpt.tree_get(r["opt"][1], path))
            assert np.abs(master - dpm.ref[f"{case}/master_shard{rank}/{name}"]).max() <= drift
    joined = [np.concatenate([x.reshape(-1) for x in parts]) for parts in (
        [_whole([r["params"] for r in rs], splits, "param", p) for p in paths],
        [dpm.ref[f"{case}/params/{_keystr(p)}"] for p in paths],
        [_np(tpt.tree_get(one["params"], p)) for p in paths],
        [dpm.ref[f"{base}/params/{_keystr(p)}"] for p in paths])]
    mean, gap = np.abs(joined[0] - joined[1]).mean(), np.abs(joined[2] - joined[3]).mean()
    assert mean <= gap + 2**-5 * sum(lrs), (case, mean, gap)
    for i, moment in ((2, "m"), (3, "v")):
        joined = [np.concatenate([x.reshape(-1) for x in parts]) for parts in (
            [_whole([r["opt"][i] for r in rs], splits, "opt", p) for p in paths],
            [dpm.ref[f"{case}/{moment}/{_keystr(p)}"] for p in paths],
            [_np(tpt.tree_get(one["opt"][i], p)) for p in paths],
            [dpm.ref[f"{base}/{moment}/{_keystr(p)}"] for p in paths])]
        rel, gap = _rel(joined[0], joined[1]), _rel(joined[2], joined[3])
        assert rel <= gap + MOMENT_REL, (case, moment, rel, gap)
    assert all(int(r["opt"][0]) == W.GSPMD_STEPS for r in rs)


@pytest.mark.parametrize("case", GSPMD)
def test_gspmd_moe_rank_bytes(dpm, case):
    """Each rank's state bytes are its shards' (``shard_bytes``), their sum
    over the ranks the same on every rank."""
    rs = _ranks(dpm, case)
    for step in range(W.GSPMD_STEPS):
        for key in ("param_shard_bytes", "grad_shard_bytes", "opt_shard_bytes"):
            mine = [r["metrics"][step][key] for r in rs]
            assert all(m == rs[0]["shard_bytes"][key] for m in mine), (case, key)
            assert all(r["metrics"][step][f"{key}_all_ranks"] == sum(mine) for r in rs)


# ---------------------------------------------------------------------------
# the units: the wire gather, the plan, the slice-by-slice decode, the wave
# ---------------------------------------------------------------------------


def test_gathered_wire_row_is_the_slices_own_encodes(dpm):
    """Two ranks' q8 wire operands all-gathered (int8 quants, fp16 scales)
    are their slices' own encodes concatenated, byte for byte, each slice's
    last block padded to 32."""
    for r in dpm.ranks[2]:
        u = r["wire_gather"]
        assert u["q"].dtype == torch.int8 and u["s"].dtype == torch.float16
        assert u["q"].numel() == 2 * 4 * 32 and u["s"].numel() == 2 * 4
        assert torch.equal(u["q"], u["want_q"])
        assert torch.equal(u["s"].view(torch.int16), u["want_s"].view(torch.int16))


def _layout(d_model=None, cfg=None, dp=1):
    cfg = cfg or dataclasses.replace(tconfigs.smoke("smollm-135m"), n_layers=2,
                                     **({} if d_model is None else {"d_model": d_model}))
    return tpt.build_layout(transformer.param_defs(cfg)["blocks"], dp)


def test_quantized_plan_is_the_one_rank_plan_where_every_slice_is_on_the_grid():
    """Full smollm-135m: P = 3,540,096, and P/2 and P/4 are multiples of
    32, so the ranks' block grids join into the row's own and the plan at
    dp 2 and 4 is the one-rank plan (its three MLP weights; ``w_gate``
    crosses the dp-2 boundary, ``w_gate`` and ``w_in`` the dp-4 ones). At
    the smoke width (slices 16 off the grid) a leaf must lie within its
    slice and start on its grid: none does; at one rank the plan is the
    row's own (``w_out``'s N = 48 is not a multiple of 32)."""
    mlp = (("mlp", "w_gate"), ("mlp", "w_in"), ("mlp", "w_out"))
    full = _layout(cfg=tconfigs.get("smollm-135m"))
    assert full.padded == 3_540_096
    assert tpt.quantized_leaf_plan(full) == mlp
    for dp in (2, 4):
        assert full.padded // dp % 32 == 0
        assert tpt.quantized_leaf_plan(full, dp) == mlp
    assert tpt.quantized_leaf_plan(_layout(64), 1) == tpt.quantized_leaf_plan(_layout(64), 2) \
        == mlp
    assert tpt.quantized_leaf_plan(_layout(), 2) == ()
    assert tpt.quantized_leaf_plan(_layout(47, dp=4), 4) == ()
    assert tpt.quantized_leaf_plan(_layout(), 1) == mlp[:2]


@pytest.mark.parametrize("d_model,dp", [(None, 2), (64, 2), (47, 4)])
def test_wire_row_decodes_slice_by_slice_as_the_reference(d_model, dp):
    """A bf16 row split into dp slices, each encoded by the port on its own
    (``q8_encode``, blocks from the slice's first element) and the block
    grids concatenated, then ``unflatten_wire_row(..., dp)``: every leaf
    outside the plan equals the reference's per-slice decode (its
    ``encode_array`` / ``decode_array`` of each slice, the slices put
    together), bit for bit; a planned leaf's quants and scales are that
    leaf's blocks of its slice's encode."""
    layout = _layout(d_model, dp=dp)
    plan = tpt.quantized_leaf_plan(layout, dp)
    P, per = layout.padded, layout.padded // dp
    row = (torch.randn(P, generator=torch.Generator().manual_seed(7)) * 0.05).to(torch.bfloat16)
    row[sum(layout.sizes):] = 0  # the padding the layout leaves zero
    slices = row.split(per)
    grid = [tq.q8_encode(t) for t in slices]
    q = torch.cat([g[0].reshape(-1) for g in grid])
    s = torch.cat([g[1].reshape(-1) for g in grid])
    leaves = tpt.unflatten_wire_row(q, s, None, layout, plan, dp)
    decoded = np.concatenate([jq.decode_array(jq.encode_array(_bf16_np(t), "q8"))
                              for t in slices])
    off = 0
    for path, shape, size in zip(layout.paths, layout.shapes, layout.sizes):
        leaf = tpt.tree_get(leaves, path)
        if path in plan:  # here the slices' grids join: the row's own blocks
            assert per % 32 == 0
            assert torch.equal(leaf.q.reshape(-1), q[off:off + size])
            assert torch.equal(leaf.s.reshape(-1), s[off // 32:(off + size) // 32])
        else:
            want = decoded[off:off + size].view(np.uint16)
            got = leaf.reshape(-1).view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(got, want, err_msg=str(path))
        off += size


def _bf16_np(t):
    import ml_dtypes

    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def test_wave_backward_is_the_dim1_reduce_scatter(dpm):
    """``moe_wave_vjp`` at dp 2: the wave's (W, Pe/2) slices' gradient is
    the bf16 sum over the ranks of their whole-row cotangents' columns
    (the reduce-scatter along dim 1), upcast after; the router's gradient
    the f32 sum of the ranks' -- bit for bit."""
    for r in dpm.ranks[2]:
        u = r["wave_vjp"]
        assert u["der"].dtype == torch.float32
        assert torch.equal(u["der"], u["want_der"]) and torch.equal(u["drt"], u["want_drt"])


# ---------------------------------------------------------------------------
# what stays unported around MoE on a mesh, and the refusals' words
# ---------------------------------------------------------------------------


def test_serving_moe_on_a_mesh_refuses_naming_its_item():
    """MoE trains and serves on data-parallel ranks (serving:
    ``tests/test_torch_serve_mesh.py``) and over a model axis
    (``tests/test_torch_moe_tp.py``), as the hybrid does (item 8g.3,
    ``tests/test_torch_recurrent_tp.py``) and the encoder-decoder (item
    8g.4, ``tests/test_torch_encdec_tp.py``): nothing refuses them, and the
    engine each rank of ``launch.serve`` builds takes its mesh (the data
    ranks alone, or data x model under tensor parallelism)."""
    from repro_torch.config import ParallelConfig
    from repro_torch.config import RunConfig as TRun
    from repro_torch.core.engine import ZeroInfinityEngine
    from repro_torch.launch import serve

    base = ["--arch", "granite-moe-1b-a400m", "--smoke", "--device", "cpu", "--data-mesh", "2"]
    for argv, strategy in ((base, None), (base + ["--model-mesh", "2"], "tp"),
                           (base[2:] + ["--arch", "recurrentgemma-9b", "--model-mesh", "2"], "tp"),
                           (base[2:] + ["--arch", "seamless-m4t-medium", "--model-mesh", "2"],
                            "tp")):
        args = serve._parse(argv)
        D, M = args.data_mesh, args.model_mesh
        eng = ZeroInfinityEngine(TRun(model=tconfigs.smoke(args.arch),
                                      parallel=ParallelConfig(remat="none")), "cpu",
                                 mesh=mesh_mod.LocalMesh(D, M, 0, D * M, torch.device("cpu"),
                                                         None, "gloo"))
        assert (eng.mp.strategy if eng.mp is not None else None) == strategy, argv


def test_no_message_of_the_port_cites_a_global_capacity_or_item_8d():
    """Routing and capacity are local to a group of one sequence's tokens
    (``models/moe.py``): no message or docstring of the port says the
    capacity counts the global batch, and none cites item 8d, which is
    done."""
    import pathlib

    root = pathlib.Path(HERE).parent
    files = sorted((root / "src" / "repro_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    for path in files:
        text = path.read_text()
        assert "item 8d" not in text, path
        for line in text.splitlines():
            assert not ("capacity" in line and "global" in line), (path, line)
