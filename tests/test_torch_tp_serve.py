"""Serving under tensor parallelism: the port's ``launch.serve
--model-mesh M`` on ``data x model`` ranks, one process each over
``torch.distributed`` (gloo, on the CPU), against the JAX package's
``launch.serve`` on a mesh of as many host devices.

* **Serving on ranks.** The module's fixture saves each case's params (the
  reference bundle's init at one device), then starts the reference
  (``tests/torch_dp_reference.py tp_serve``: one subprocess with four host
  devices, every case of ``torch_dp_worker.TP_SERVE_CASES`` on its mesh)
  and the port's ranks (``tests/torch_dp_worker.py tp_serve``) together.
  Five sequences through two slots, four new tokens each: llama at (1, 2)
  and (2, 2), llava at (1, 2) and at (1, 4) (its 2 KV heads do not split
  over 4: each rank parks the one its query head reads), llama under
  ``--kv-quant q8`` and on the NVMe tier.
* **What is held.** Each sequence's tokens equal the reference's; where
  they part, the reference's own teacher-forced logits (one device) at
  the first differing token hold the two candidates within the logits'
  tolerance of each other (a near-tie that rounding decides), and the
  ranks' teacher-forced prefill logits (every prompt, the vocab shards
  gathered) are held to the reference's by ``tests/test_torch_models.py``'s
  tolerance (3e-2 of the largest). The ``kv`` bytes summed over the ranks
  equal the reference's where the KV heads split over the model ranks;
  where they do not, each rank's K/V bytes are its KV heads' share of the
  reference's, and the ``len`` leaf parks once a data row. Each rank
  holds its shards along both axes (``shard_bytes``), and serving gathers
  over the data axis alone: each rank's view of a layer is the model shard
  of the whole layer, bit for bit.
"""
import concurrent.futures
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dp_worker as W  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import ParallelConfig, RunConfig, ShapeConfig  # noqa: E402
from repro_torch.core.engine import ZeroInfinityEngine  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from test_torch_serve_mesh import KV_KEYS, _metadata_bytes  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = list(W.TP_SERVE_CASES)
TIMEOUT = 300.0
LOGIT_TOL = 3e-2  # tests/test_torch_models.py's: a few bf16 ulps of the largest logit
LEN_BYTES = 4  # the int32 ``len`` leaf parked (a 0-d placeholder) or resident (a slot's)


def _save_inits(tmp: str) -> dict:
    drawn, params = {}, {}
    for case in CASES:
        cfg = W.serve_cfg(case, jconfigs)
        key = repr(cfg)
        if key not in drawn:
            drawn[key] = jax.jit(jreg.build(cfg).init)(jax.random.PRNGKey(0))
        params[case] = drawn[key]
        torch.save(bridge.params_from_numpy(jax.tree.map(np.asarray, drawn[key])),
                   W.serve_init_path(tmp, case))
    return params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's ``.npz``, each world size's ranks' results and the
    reference's params by case."""
    tmp = str(tmp_path_factory.mktemp("tp_serve"))
    ref_path = os.path.join(tmp, "ref.npz")
    params = _save_inits(tmp)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    ref = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dp_reference.py"),
                            tmp, ref_path, "tp_serve"], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = {world: pool.submit(W.spawn, "tp_serve", world, tmp, TIMEOUT)
                    for world in (2, 4)}
            out = {world: f.result() for world, f in runs.items()}
        log, _ = ref.communicate(timeout=TIMEOUT)
    except BaseException:
        ref.kill()
        ref.communicate()
        raise
    assert ref.returncode == 0, log[-4000:]
    yield types.SimpleNamespace(ref=dict(np.load(ref_path)), ranks=out, params=params)


def _ranks(ranks, case):
    return [r[case] for r in ranks.ranks[W.TP_SERVE_CASES[case][0]]]


def _prompts(case) -> dict:
    """Every sequence's prefill inputs as both drivers draw them."""
    args = tserve._parse(W.serve_argv(case, "torch", ""))
    cfg = W.serve_cfg(case, tconfigs)
    specs = treg.build(cfg).input_specs(ShapeConfig("serve", args.prompt_len, args.batch,
                                                    "prefill"))
    full = tserve.draw_inputs(specs, args.batch, cfg.vocab_size, args.seed)
    return {k: v.float().numpy() if v.dtype.is_floating_point else v.numpy()
            for k, v in full.items()}


def _ref_logits(ranks, case, prompts: dict, rows, extra=None) -> np.ndarray:
    """The reference bundle's prefill logits (one device) of ``rows``'
    prompts, each followed by its ``extra`` tokens: the teacher-forced
    logits of the next token."""
    cfg = W.serve_cfg(case, jconfigs)
    batch = {k: jnp.asarray(v[rows]).astype(jnp.bfloat16 if v.dtype == np.float32 else v.dtype)
             for k, v in prompts.items()}
    if extra is not None:
        batch["tokens"] = jnp.concatenate([batch["tokens"], jnp.asarray(extra, jnp.int32)], 1)
    lg, _ = jax.jit(jreg.build(cfg).prefill)(ranks.params[case], batch)
    return np.asarray(lg[:, -1]).astype(np.float32)


@pytest.mark.parametrize("case", CASES)
def test_tokens_equal_the_references_or_part_at_a_near_tie(ranks, case):
    """Each sequence's tokens equal the reference's, every sequence
    finished, the admissions and slots are the reference's; a sequence
    that parts from them does so where the reference's teacher-forced
    logits of its token and of the ranks' are within ``LOGIT_TOL`` of the
    largest logit."""
    want = json.loads(str(ranks.ref[f"{case}/generated"]))
    prompts = _prompts(case)
    for r in _ranks(ranks, case):
        assert all(r["done"]) and [len(g) for g in r["generated"]] == [len(g) for g in want]
        assert r["admissions"] == int(ranks.ref[f"{case}/admissions"]) == 3
        assert r["slots"] == int(ranks.ref[f"{case}/slots"]) == 2
        for s, (got, ref) in enumerate(zip(r["generated"], want)):
            if got == ref:
                continue
            i = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
            lg = _ref_logits(ranks, case, prompts, [s], [ref[:i]] if i else None)[0]
            assert abs(lg[ref[i]] - lg[got[i]]) <= LOGIT_TOL * np.abs(lg).max(), (case, s, i)
    assert _ranks(ranks, case)[0]["generated"] == _ranks(ranks, case)[-1]["generated"]


@pytest.mark.parametrize("case", CASES)
def test_teacher_forced_prefill_logits_match_the_reference(ranks, case):
    """Every prompt through the ranks' ``prefill`` (each model rank its
    vocab columns, gathered) against the reference bundle's."""
    prompts = _prompts(case)
    want = _ref_logits(ranks, case, prompts, list(range(len(prompts["tokens"]))))
    for r in _ranks(ranks, case):
        got = r["prefill_logits"].numpy()
        assert got.shape == want.shape
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= LOGIT_TOL, (case, err)


@pytest.mark.parametrize("case", CASES)
def test_kv_bytes_are_the_references_by_the_ranks_kv_heads(ranks, case):
    """The ``kv`` counters summed over the ranks: the reference's K/V bytes
    times the KV heads the model ranks of a data row hold over the
    config's (1 where they split: the reference's exactly), plus the
    ``len`` leaf once a data row; the ranks step in lockstep, the
    reference's step count. Under q8 each rank's store frames its own
    arrays (a header and a block grid each, as the reference's store
    frames its whole ones): the logical bytes are held so, and each rank's
    wire bytes read are those it wrote less its format record, fewer than
    the logical ones."""
    rs = _ranks(ranks, case)
    cfg = W.serve_cfg(case, tconfigs)
    D, M = rs[0]["mesh_shape"]
    share = (sum(r["kv_heads"] for r in rs[:M]), cfg.n_kv_heads)
    want = {k: int(ranks.ref[f"{case}/kv/{k}"]) for k in KV_KEYS}
    lens = {"resident_bytes": 2 * LEN_BYTES}  # one a slot
    lens.update({k: 3 * LEN_BYTES for k in KV_KEYS if k != "resident_bytes"})  # one a parked seq
    keys = KV_KEYS
    if "--kv-quant" in W.TP_SERVE_CASES[case][3]:
        keys = [k for k in KV_KEYS if "wire" not in k]
        for kr in rs[0]["kv_ranks"]:
            assert kr["in_wire_bytes"] == kr["out_wire_bytes"] - _metadata_bytes("q8")
            assert 0 < kr["in_wire_bytes"] < kr["in_bytes"]
    for r in rs:
        got = {k: sum(kr[k] for kr in r["kv_ranks"]) for k in KV_KEYS}
        assert got == {k: r["kv"][k] for k in KV_KEYS}
        for k in keys:
            assert (got[k] - lens[k]) * share[1] == (want[k] - lens[k]) * share[0], (case, k)
        assert r["steps"] == int(ranks.ref[f"{case}/steps"])
    if share[0] > share[1]:  # every model rank of a row parks its own KV heads
        assert all(r["kv_heads"] == 1 for r in rs) and M == 4


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_shards_and_gathers_over_data_alone(ranks, case):
    """Each rank's resident param bytes are ``shard_bytes()``'s for its
    place on the mesh; its ``serve_params`` view of every layer and of the
    unstacked leaves is the model shard of the whole leaves, bit for bit
    (no param byte crosses the model axis), and it holds each stacked leaf
    the rules split as its shard."""
    rs = _ranks(ranks, case)
    D, M = rs[0]["mesh_shape"]
    for rank, r in enumerate(rs):
        eng = ZeroInfinityEngine(RunConfig(model=W.serve_cfg(case, tconfigs),
                                           parallel=ParallelConfig(remat="none")), "cpu",
                                 mesh=mesh_mod.LocalMesh(D, M, rank, D * M, torch.device("cpu"),
                                                         None, "gloo"))
        assert eng.mp.strategy == "tp"
        assert r["param_shard_bytes"][rank] == eng.shard_bytes()["param_shard_bytes"]
        assert r["gather"]["equal"], (case, rank)
        assert r["mesh"]["model"] == M and r["mesh"]["strategy"] == "tp"


def test_context_parallel_serving_and_other_families_raise_naming_8g():
    """Serving where the heads do not split over the model ranks (the
    smoke smollm's 3 over 2: context parallelism, ``tests/test_torch_cp_
    serve.py``), the MoE family (``tests/test_torch_moe_tp.py``), the SSM
    and the hybrid (``tests/test_torch_recurrent_tp.py``) and the
    encoder-decoder (item 8g.4, ``tests/test_torch_encdec_tp.py``) meet no
    refusal and, in a run of one process, raise naming the torchrun launch
    that gives them their ranks."""
    base = ["--smoke", "--device", "cpu", "--batch", "2", "--model-mesh", "2"]
    launch = r"needs 2 ranks.*torchrun --standalone --nproc-per-node 2"
    with pytest.raises(ValueError, match=launch):
        tserve.run_serve(tserve._parse(base))
    for arch in ("granite-moe-1b-a400m", "mamba2-370m", "recurrentgemma-9b",
                 "seamless-m4t-medium"):
        with pytest.raises(ValueError, match=launch):
            tserve.run_serve(tserve._parse(base + ["--arch", arch]))


def test_global_argmax_takes_the_first_index_of_a_tie():
    """Over a vocab sharded on two model ranks: the shards' maxima
    compared, a tie going to the smaller global index, as ``jnp.argmax``;
    on one model rank the plain argmax."""

    class TwoRanks:
        """Rank 0 of a (1, 2) mesh whose rank 1 holds ``other``."""

        def __init__(self, other):
            self.other = other

        def coords(self):
            return {"data": 0, "model": 0}

        def all_gather(self, t, dim, axis):
            assert axis == "model" and dim == 0
            theirs = self.other[0] if t.dtype.is_floating_point else self.other[1]
            return torch.cat([t, theirs[None]], 0)

    mine = torch.tensor([[0.0, 3.0, 3.0], [1.0, 0.0, 0.0]])
    # rank 1's maxima: 3.0 at its column 0 (global 3): a tie with rank 0's
    # column 1 (global 1); 5.0 at its column 2 (global 5)
    other = (torch.tensor([3.0, 5.0]), torch.tensor([3, 5]))
    got = tserve.global_argmax(mine, TwoRanks(other), sharded=True)
    assert got.tolist() == [1, 5]
    assert tserve.global_argmax(mine, None, sharded=False).tolist() == [1, 0]
    assert int(jnp.argmax(jnp.asarray([0.0, 3.0, 3.0, 3.0]))) == 1
