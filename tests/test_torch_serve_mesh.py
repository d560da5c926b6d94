"""The port's serving on data-parallel ranks, one process per rank over
``torch.distributed`` (gloo, on the CPU), against the JAX package's
``launch.serve`` on a mesh of as many host devices.

* **Serving on ranks.** The module's fixture saves each case's params (the
  reference bundle's init at one device, as the port's whole tensors),
  then starts the reference (``tests/torch_dp_reference.py serve``: one
  subprocess with four host devices, every case of
  ``torch_dp_worker.SERVE_CASES`` on a mesh of its dp, the params laid out
  by its engine's param shardings) and the port's ranks
  (``tests/torch_dp_worker.py serve``: 2 ranks for the dp-2 cases, 4 for
  the dp-4 one, each rank its ZeRO-3 shards of the same params) together.
  Five sequences through two slots, four new tokens each: smollm at dp 2
  and 4 (at dp 4 the two slots do not divide: the batch is replicated),
  granite-moe, mamba2, recurrentgemma cut to 5 layers, llava and seamless
  at dp 2, smollm under ``--kv-quant q8``, on the NVMe tier, and under
  ``--plan auto --hw-devices 2``. The generated tokens and the admissions
  equal the reference's exactly, and the ``kv`` bytes summed over the
  ranks (rank 0's where the batch is replicated) equal its counters (under
  q8 each rank's store writes its own format record, 38 wire bytes, once,
  as the reference's one store does); each
  rank's ``param_shard_bytes`` is ``shard_bytes()``'s and they sum to the
  params' bytes; each rank's ``serve_params`` view gives exactly
  ``layer_params`` of the whole leaves, layer by layer, and no rank holds a
  whole split stacked leaf.
* **In this process.** The seeded draw on a mesh is the one-rank draw cut
  by ``shard_leaf``, bit for bit; no config's rules split a stacked leaf
  on its layer dim; ``--model-mesh 2`` (every family, item 8g), a
  ``--data-mesh`` or a plan for more ranks than the run has raises naming
  the ``launch.serve`` torchrun launch.
"""
import concurrent.futures
import dataclasses
import json
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
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import ParallelConfig, RunConfig  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core import qformat  # noqa: E402
from repro_torch.core.engine import ZeroInfinityEngine  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = list(W.SERVE_CASES)
KV_KEYS = ("in_bytes", "out_bytes", "in_wire_bytes", "out_wire_bytes", "resident_bytes")
TIMEOUT = 300.0


def _save_inits(tmp: str) -> None:
    """Each case's params: the reference bundle's init at one device (one
    draw per config), as the port's tensors."""
    drawn = {}
    for case in CASES:
        cfg = W.serve_cfg(case, jconfigs)
        key = repr(cfg)
        if key not in drawn:
            params = jax.jit(jreg.build(cfg).init)(jax.random.PRNGKey(0))
            drawn[key] = bridge.params_from_numpy(jax.tree.map(np.asarray, params))
        torch.save(drawn[key], W.serve_init_path(tmp, case))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's ``.npz`` and, per world size, each rank's results."""
    tmp = str(tmp_path_factory.mktemp("serve_mesh"))
    ref_path = os.path.join(tmp, "ref.npz")
    _save_inits(tmp)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    ref = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dp_reference.py"),
                            tmp, ref_path, "serve"], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = {world: pool.submit(W.spawn, "serve", world, tmp, TIMEOUT)
                    for world in (2, 4)}
            out = {world: f.result() for world, f in runs.items()}
        log, _ = ref.communicate(timeout=TIMEOUT)
    except BaseException:
        ref.kill()
        ref.communicate()
        raise
    assert ref.returncode == 0, log[-4000:]
    yield types.SimpleNamespace(ref=dict(np.load(ref_path)), ranks=out)


def _ranks(ranks, case):
    return [r[case] for r in ranks.ranks[W.SERVE_CASES[case][0]]]


def _metadata_bytes(fmt: str) -> int:
    """The wire bytes of a quantized store's format record
    (``QuantizedArrayStore._check_or_write_metadata``)."""
    return len(json.dumps({"format": fmt, "block": qformat.BLOCK, "version": 1},
                          separators=(",", ":")))


# ---------------------------------------------------------------------------
# serving on ranks against the reference on host devices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_tokens_and_admissions_equal_the_references(ranks, case):
    """Every rank returns the run: each sequence's tokens (gathered from the
    rank that served it) and the admissions summed over the ranks equal the
    reference's on as many host devices, and every sequence finished."""
    want = json.loads(str(ranks.ref[f"{case}/generated"]))
    for r in _ranks(ranks, case):
        assert r["generated"] == want
        assert all(r["done"])
        assert r["admissions"] == int(ranks.ref[f"{case}/admissions"]) == 3
        assert r["slots"] == int(ranks.ref[f"{case}/slots"]) == 2


@pytest.mark.parametrize("case", CASES)
def test_kv_bytes_summed_over_the_ranks_equal_the_references(ranks, case):
    """Where the slots divide, each rank parks and admits its own sequences
    in its own store, and the ``kv`` byte counters summed over the ranks
    equal the reference's (the device slot cache's bytes too); where they
    do not (dp 4, 2 slots), every rank serves every slot, and rank 0's
    counters, the run's, equal them. The ranks step in lockstep: one step
    count, the reference's."""
    rs = _ranks(ranks, case)
    want = {k: int(ranks.ref[f"{case}/kv/{k}"]) for k in KV_KEYS}
    split = W.SERVE_CASES[case][0] == 2
    if split and "--kv-quant" in W.SERVE_CASES[case][3]:
        # each rank's quantized store writes its format record once, as the
        # reference's one store does
        want["out_wire_bytes"] += (len(rs) - 1) * _metadata_bytes("q8")
    for r in rs:
        assert r["mesh"]["slots_split"] == split
        assert {k: r["kv"][k] for k in KV_KEYS} == want
        counted = r["kv_ranks"] if split else r["kv_ranks"][:1]
        assert {k: sum(kr[k] for kr in counted) for k in KV_KEYS} == want
        assert r["steps"] == rs[0]["steps"] == int(ranks.ref[f"{case}/steps"])
    assert want["out_bytes"] > 0
    if split:  # each rank parked what it prefilled: 2 waiting sequences, 1
        assert [a for a in rs[0]["admissions_ranks"]] == [2, 1]
        assert all(kr["out_bytes"] > 0 for kr in rs[0]["kv_ranks"])


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_zero3_param_shards(ranks, case):
    """Each rank's resident params are its ZeRO-3 shards: its
    ``param_shard_bytes`` equals ``engine.shard_bytes()``, the ranks' sum
    is the params' bytes, every stacked leaf the rules split is held as
    1/dp of its split dim, and every split leaf here splits."""
    rs = _ranks(ranks, case)
    dp = len(rs)
    eng = ZeroInfinityEngine(RunConfig(model=W.serve_cfg(case, tconfigs)), "cpu",
                             mesh=_fake_mesh(0, dp))
    defs = eng.bundle.defs
    # the leaves the rules leave whole (mamba2's and the hybrid's ``inner``
    # vectors, on the model axis) sit on every rank
    unsplit = sum(int(np.prod(tpt.tree_get(defs, p).shape))
                  * tpt.tree_get(defs, p).torch_dtype.itemsize
                  for p in tpt.tree_paths(defs) if tpt.tree_get(eng.splits["param"], p) is None)
    for rank, r in enumerate(rs):
        assert r["param_shard_bytes"] == [x["shard_bytes"] for x in rs]
        assert sum(r["param_shard_bytes"]) == r["whole_bytes"] + (dp - 1) * unsplit
        assert r["param_shard_bytes"][rank] == (r["whole_bytes"] - unsplit) // dp + unsplit
    g = rs[0]["gather"]
    assert g["split_stacked"], "no stacked leaf splits: nothing is gathered"
    for path in map(tuple, g["split_stacked"]):
        shape = tpt.tree_get(defs, path).shape
        held = g["held_shapes"][path]
        assert np.prod(held) * dp == np.prod(shape), (path, held, shape)


@pytest.mark.parametrize("case", CASES)
def test_layer_gather_gives_layer_params_of_the_whole_leaves(ranks, case):
    """``serve_params``: on every rank, each stacked subtree's
    ``layer(l)`` equals ``layer_params`` of the whole leaves exactly, and
    each unstacked leaf is gathered whole."""
    stacked = list(ZeroInfinityEngine(RunConfig(model=W.serve_cfg(case, tconfigs)),
                                      "cpu").stacked)
    assert stacked and set(stacked) <= {"blocks", "groups", "tail", "enc", "dec"}
    for r in _ranks(ranks, case):
        assert r["gather"]["equal"]
        assert r["gather"]["stacked"] == stacked


def test_plan_for_two_devices_serves_on_two_ranks(ranks):
    """``--plan auto --hw-devices 2`` (no ``--data-mesh``): the port plans
    for 2 devices, field for field the reference's plan but the hardware's
    ``devices_per_node`` (detected: the reference's process holds four host
    devices, a port rank one), and serves on the 2 ranks with the plan's
    two slots split one a rank."""
    want = json.loads(str(ranks.ref["plan_dp2/plan"]))
    assert want["hardware"].pop("devices_per_node") == 4
    for r in _ranks(ranks, "plan_dp2"):
        assert r["plan_devices"] == 2 and r["mesh"]["world"] == 2
        assert r["mesh"]["local_slots"] == 1
        got = json.loads(r["plan"])
        assert got["hardware"].pop("devices_per_node") == 1
        assert got == want


# ---------------------------------------------------------------------------
# in this process: the draw, the rules, the refusals
# ---------------------------------------------------------------------------


def _fake_mesh(rank: int, world: int):
    return mesh_mod.LocalMesh(world, 1, rank, world, torch.device("cpu"), None, "gloo")


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m", "mamba2-370m",
                                  "recurrentgemma-9b", "llava-next-34b",
                                  "seamless-m4t-medium"])
def test_seeded_draw_on_a_mesh_is_the_one_rank_draw_cut(arch):
    """On a mesh ``init_params`` draws leaf by leaf and keeps the rank's
    shard: bit for bit ``shard_leaf`` of the one-rank draw from the same
    seed, at dp 2 and 4."""
    run = RunConfig(model=tconfigs.smoke(arch), parallel=ParallelConfig(remat="none"))
    one = ZeroInfinityEngine(run, "cpu").init_params(torch.Generator().manual_seed(3))
    for dp in (2, 4):
        for rank in range(dp):
            eng = ZeroInfinityEngine(run, "cpu", mesh=_fake_mesh(rank, dp))
            got = eng.init_params(torch.Generator().manual_seed(3))
            for path in tpt.tree_paths(one):
                dim = tpt.tree_get(eng.splits["param"], path)
                want = tpt.shard_leaf(tpt.tree_get(one, path), dim, rank, dp)
                assert torch.equal(tpt.tree_get(got, path), want), (arch, dp, rank, path)


@pytest.mark.parametrize("stage", range(4))
def test_seeded_state_on_a_mesh_is_the_one_rank_states_shards(stage):
    """The GSPMD engine's ``init_state`` on a mesh (training's seeded
    start) builds on the shard draw: each rank's params, masters and
    moments are its ``respec`` of the one-rank state, bit for bit, at
    every ZeRO stage (params whole below 3, the optimizer split from 1)."""
    run = RunConfig(model=tconfigs.smoke("smollm-135m"),
                    parallel=ParallelConfig(remat="none", zero_stage=stage))
    one = ZeroInfinityEngine(run, "cpu").init_state(torch.Generator().manual_seed(5))
    for rank in range(2):
        eng = ZeroInfinityEngine(run, "cpu", mesh=_fake_mesh(rank, 2))
        got = eng.init_state(torch.Generator().manual_seed(5))
        want = {"params": eng.respec(one["params"], None, "param"),
                "master": eng.respec(one["opt"].master, None, "opt")}
        for name, tree in (("params", got["params"]), ("master", got["opt"].master)):
            for path in tpt.tree_paths(want[name]):
                assert torch.equal(tpt.tree_get(tree, path), tpt.tree_get(want[name], path)), \
                    (stage, rank, name, path)
        assert int(got["opt"].step) == 0


@pytest.mark.parametrize("smoke", [False, True])
def test_no_config_splits_a_stacked_leaf_on_its_layer_dim(smoke):
    """For every config, at dp 2 and 4 and ZeRO stages 0-3, no stacked
    leaf (first axis ``layers``) splits on dim 0: serving gathers each
    layer's slice along the split dim less one (the engine refuses
    otherwise)."""
    seen = 0
    for arch in tconfigs.ARCH_IDS:
        cfg = tconfigs.smoke(arch) if smoke else tconfigs.get(arch)
        defs = treg.FAMILY_MODULES[cfg.family].param_defs(cfg)
        for dp in (2, 4):
            for stage in range(4):
                par = ParallelConfig(zero_stage=stage)
                splits = tpt.leaf_splits(defs, cfg, {"data": dp, "model": 1}, par, "param")
                for path in tpt.tree_paths(defs):
                    if tpt.tree_get(defs, path).axes[0] == "layers":
                        assert tpt.tree_get(splits, path) != 0, (arch, dp, stage, path)
                        seen += 1
    assert seen


def test_model_mesh_raises_naming_item_8e():
    """A model axis serves every family: 8e's tensor parallelism (``tests/
    test_torch_tp_serve.py``), the SSM's inner dim, 8g.3 (``tests/
    test_torch_recurrent_tp.py``), and the encoder-decoder, 8g.4
    (``tests/test_torch_encdec_tp.py``). The smoke smollm's 3 heads over 2
    model ranks serve under context parallelism (``tests/test_torch_cp_
    serve.py``); each, on a (2, 2) mesh in a run of one process, raises
    naming the launch of its 4 ranks."""
    base = ["--smoke", "--device", "cpu", "--batch", "2", "--data-mesh", "2",
            "--model-mesh", "2"]
    for arch in ("smollm-135m", "mamba2-370m", "seamless-m4t-medium"):
        with pytest.raises(ValueError, match="needs 4 ranks.*--nproc-per-node 4"):
            tserve.run_serve(tserve._parse(base + ["--arch", arch]))


@pytest.mark.parametrize("flags", [["--data-mesh", "2"],
                                   ["--plan", "auto", "--hw-devices", "2"]])
def test_more_ranks_than_the_run_has_names_the_serve_launch(flags):
    """A mesh of 2 (or a plan for 2 devices, whose ranks the mesh takes)
    in a run of one process names the torchrun launch of
    ``launch.serve``."""
    with pytest.raises(ValueError, match=r"torchrun --standalone --nproc-per-node 2 "
                                         r"-m repro_torch\.launch\.serve"):
        tserve.run_serve(tserve._parse(["--smoke", "--device", "cpu", "--batch", "2"]
                                       + flags))
