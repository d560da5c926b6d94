"""Serving under context parallelism: the port's ``launch.serve
--model-mesh M`` where the heads do not split over M, on ``data x model``
ranks, one process each over ``torch.distributed`` (gloo, on the CPU),
against the JAX package's ``launch.serve`` on a mesh of as many host
devices; and the flash-decode combine on its own.

* **Serving on ranks.** The module's fixture saves each case's params (the
  reference bundle's init at one device), then starts the reference
  (``tests/torch_dp_reference.py cp_serve``: one subprocess with four host
  devices, every case of ``torch_dp_worker.CP_SERVE_CASES``) and the
  port's ranks (``tests/torch_dp_worker.py cp_serve``) together. Five
  sequences through two slots: smollm (3 heads) at (1, 2) and (2, 2),
  llava (4 heads) at (1, 3), smollm on the NVMe tier with a 4-token prompt
  (its capacity's second half holds no prompt position: rank 1 parks an
  empty range, and the decode crosses into its range), and smollm at a
  capacity of 13 (no split: the whole cache on each rank).
* **What is held.** The tokens (equal, or parting at a near-tie the
  reference's own teacher-forced logits show, ``tests/test_torch_tp_
  serve.py``'s rule); the teacher-forced prefill and decode logits (every
  prompt, then two decode steps of drawn tokens, the cache laid out as the
  driver lays it out) against the reference bundle's prefill and decode
  steps on one device, by ``LOGIT_TOL`` of the largest logit; the ``kv``
  bytes summed over the ranks (model rank 0's where the cache is whole)
  equal the reference's; each rank's resident K/V is ``1/M`` of the
  reference's (to within the ``len`` leaf, which model rank 0 holds) where
  the capacity splits, all of it where it does not; each rank holds its
  param shards and its view of a layer is the whole of every leaf context
  parallelism gathers over the model axis; a decode step's model-axis
  gather brings in ``(M - 1) / M`` of those leaves' bytes.
* **The combine.** ``decode_partial`` over each rank's range and
  ``combine_partials`` against ``decode_attention`` on the whole cache:
  per-row lengths, ranks with no valid position (their weight exactly
  zero, no NaN), and the write of a token at the boundary of two ranks'
  ranges landing on its owner alone.

The reference's decode combines its ranks' partial softmaxes with ``p /
l`` rounded to bf16 before the product; the port normalises after the
sum, so the two round apart: held by the logits' tolerance, not loosened.
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
from repro_torch.core import kvcache  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core.engine import ZeroInfinityEngine  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from test_torch_serve_mesh import KV_KEYS  # noqa: E402
from test_torch_tp_serve import LEN_BYTES, LOGIT_TOL  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = list(W.CP_SERVE_CASES)
TIMEOUT = 300.0


def save_serve_inits(tmp: str, cases) -> dict:
    """Each case's params (the reference bundle's init at one device, one
    draw per config) saved as the port's tensors; the reference's by
    case."""
    drawn, params = {}, {}
    for case in cases:
        cfg = W.serve_cfg(case, jconfigs)
        key = repr(cfg)
        if key not in drawn:
            drawn[key] = jax.jit(jreg.build(cfg).init)(jax.random.PRNGKey(0))
        params[case] = drawn[key]
        torch.save(bridge.params_from_numpy(jax.tree.map(np.asarray, drawn[key])),
                   W.serve_init_path(tmp, case))
    return params


def start_reference(tmp: str, job: str):
    """The reference's job in a subprocess of its own (four host
    devices); returns ``(process, the .npz it writes)``."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    path = os.path.join(tmp, "ref.npz")
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dp_reference.py"),
                             tmp, path, job], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, path


def finish_reference(proc, path) -> dict:
    log, _ = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, log[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's ``.npz``, each world size's ranks' results and the
    reference's params by case."""
    tmp = str(tmp_path_factory.mktemp("cp_serve"))
    params = save_serve_inits(tmp, CASES)
    ref, path = start_reference(tmp, "cp_serve")
    try:
        worlds = sorted({W.CP_SERVE_CASES[c][0] for c in CASES})
        with concurrent.futures.ThreadPoolExecutor(len(worlds)) as pool:
            runs = {w: pool.submit(W.spawn, "cp_serve", w, tmp, TIMEOUT) for w in worlds}
            out = {w: f.result() for w, f in runs.items()}
        npz = finish_reference(ref, path)
    except BaseException:
        ref.kill()
        ref.communicate()
        raise
    yield types.SimpleNamespace(ref=npz, ranks=out, params=params)


def case_ranks(ranks, case) -> list:
    return [r[case] for r in ranks.ranks[W.MODEL_SERVE_CASES[case][0]]]


def prompts(case) -> dict:
    """Every sequence's prefill inputs as both drivers draw them."""
    args = tserve._parse(W.serve_argv(case, "torch", ""))
    cfg = W.serve_cfg(case, tconfigs)
    specs = treg.build(cfg).input_specs(ShapeConfig("serve", args.prompt_len, args.batch,
                                                    "prefill"))
    full = tserve.draw_inputs(specs, args.batch, cfg.vocab_size, args.seed)
    return {k: v.float().numpy() if v.dtype.is_floating_point else v.numpy()
            for k, v in full.items()}


def ref_logits(params, case, batch: dict, rows, extra=None) -> np.ndarray:
    """The reference bundle's prefill logits (one device) of ``rows``'
    prompts, each followed by its ``extra`` tokens: the teacher-forced
    logits of the next token."""
    cfg = W.serve_cfg(case, jconfigs)
    jb = {k: jnp.asarray(v[rows]).astype(jnp.bfloat16 if v.dtype == np.float32 else v.dtype)
          for k, v in batch.items()}
    if extra is not None:
        jb["tokens"] = jnp.concatenate([jb["tokens"], jnp.asarray(extra, jnp.int32)], 1)
    lg, _ = jax.jit(jreg.build(cfg).prefill)(params, jb)
    return np.asarray(lg[:, -1]).astype(np.float32)


def ref_forced_logits(params, case, batch: dict, fed: np.ndarray, cap: int) -> list:
    """The reference bundle's teacher-forced logits on one device: every
    prompt's prefill, its cache grown to ``cap`` positions with a length a
    row (as its serving driver grows it), then one decode step for each
    column of ``fed``; the last position's logits of each call. (A MoE
    decode step routes each token alone, with its own capacity, so its
    logits are not those of a prefill over the prompt and the tokens.)"""
    from repro.core import kvcache as jkv

    cfg = W.serve_cfg(case, jconfigs)
    bundle = jreg.build(cfg)
    jb = {k: jnp.asarray(v).astype(jnp.bfloat16 if v.dtype == np.float32 else v.dtype)
          for k, v in batch.items()}
    lg, cache = jax.jit(bundle.prefill)(params, jb)
    P = int(cache["len"])
    cache = {**jkv.grow_cache(cache, cap - P, cfg.family),
             "len": jnp.full((lg.shape[0],), P, jnp.int32)}
    out = [lg]
    step = jax.jit(bundle.decode_step)
    for i in range(fed.shape[1]):
        lg, cache = step(params, cache, {"tokens": jnp.asarray(fed[:, i:i + 1])})
        out.append(lg)
    return [np.asarray(x[:, -1]).astype(np.float32) for x in out]


def check_tokens(ref: dict, rs: list, case: str, params) -> None:
    """Each sequence's tokens equal the reference's, every sequence
    finished, the admissions and slots the reference's; a sequence that
    parts from them does so where the reference's teacher-forced logits
    of its token and of the ranks' are within ``LOGIT_TOL`` of the largest
    logit; every rank returns the same run."""
    want = json.loads(str(ref[f"{case}/generated"]))
    batch = prompts(case)
    for r in rs:
        assert all(r["done"]) and [len(g) for g in r["generated"]] == [len(g) for g in want]
        assert r["admissions"] == int(ref[f"{case}/admissions"]) == 3
        assert r["slots"] == int(ref[f"{case}/slots"]) == 2
        for s, (got, exp) in enumerate(zip(r["generated"], want)):
            if got == exp:
                continue
            i = next(i for i, (a, b) in enumerate(zip(got, exp)) if a != b)
            lg = ref_logits(params, case, batch, [s], [exp[:i]] if i else None)[0]
            assert abs(lg[exp[i]] - lg[got[i]]) <= LOGIT_TOL * np.abs(lg).max(), (case, s, i)
    assert rs[0]["generated"] == rs[-1]["generated"]


def check_forced_logits(rs: list, case: str, params) -> None:
    """The ranks' teacher-forced prefill logits and each decode step's
    against the reference bundle's (``ref_forced_logits``, at the run's
    capacity), by ``LOGIT_TOL`` of the largest logit."""
    batch = prompts(case)
    args = tserve._parse(W.serve_argv(case, "torch", ""))
    fed = W.teacher_tokens(args.batch, W.serve_cfg(case, tconfigs).vocab_size)
    wants = ref_forced_logits(params, case, batch, fed, args.prompt_len + args.new_tokens)
    for step, want in enumerate(wants):
        for r in rs:
            got = (r["prefill_logits"] if step == 0 else r["decode_logits"][step - 1]).numpy()
            assert got.shape == want.shape
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= LOGIT_TOL, (case, step, err)


def check_kv_bytes(ref: dict, rs: list, case: str) -> None:
    """The run's ``kv`` counters (every rank's summed where the capacity
    splits, model rank 0's of each data row where the cache is whole) are
    the reference's exactly, and so is the step count."""
    for r in rs:
        msh = r["mesh"]
        whole = msh["strategy"] == "cp" and not msh["cache_seq_split"]
        counted = r["kv_ranks"][::msh["model"]] if whole else r["kv_ranks"]
        for k in KV_KEYS:
            assert r["kv"][k] == sum(kr[k] for kr in counted), (case, k)
            if k != "resident_bytes":
                assert r["kv"][k] == int(ref[f"{case}/kv/{k}"]), (case, k)
        assert r["steps"] == int(ref[f"{case}/steps"])


def check_resident(ref: dict, rs: list, case: str) -> None:
    """Each rank's resident K/V bytes (less the slots' ``len`` leaf, which
    model rank 0 of each data row holds) are the reference's over the
    ranks that split it: its data ranks' slots and, where the capacity
    splits, its model ranks' positions."""
    want = int(ref[f"{case}/kv/resident_bytes"]) - 2 * LEN_BYTES
    for r in rs:
        msh = r["mesh"]
        D, M = msh["data"], msh["model"]
        parts = (D if msh["slots_split"] else 1) * (M if msh["cache_seq_split"] else 1)
        for rank, kr in enumerate(r["kv_ranks"]):
            lens = LEN_BYTES * msh["local_slots"] if rank % M == 0 else 0
            assert (kr["resident_bytes"] - lens) * parts == want, (case, rank)


@pytest.mark.parametrize("case", CASES)
def test_tokens_equal_the_references_or_part_at_a_near_tie(ranks, case):
    check_tokens(ranks.ref, case_ranks(ranks, case), case, ranks.params[case])


@pytest.mark.parametrize("case", CASES)
def test_teacher_forced_prefill_and_decode_logits_match_the_reference(ranks, case):
    check_forced_logits(case_ranks(ranks, case), case, ranks.params[case])


@pytest.mark.parametrize("case", CASES)
def test_kv_bytes_summed_over_the_ranks_are_the_references(ranks, case):
    check_kv_bytes(ranks.ref, case_ranks(ranks, case), case)


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_share_of_the_resident_kv(ranks, case):
    rs = case_ranks(ranks, case)
    check_resident(ranks.ref, rs, case)
    args = tserve._parse(W.serve_argv(case, "torch", ""))
    cap = args.prompt_len + args.new_tokens  # a VLM's prompt counts its vision positions
    msh = rs[0]["mesh"]
    assert msh["cache_seq_split"] == (cap % msh["model"] == 0) == (case != "whole_cp_1x2")
    assert msh["local_cache_len"] == (cap // msh["model"] if msh["cache_seq_split"] else cap)


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_shards_and_gathers_the_leaves_cp_uses_whole(ranks, case):
    """Each rank's resident param bytes are ``shard_bytes()``'s; its view of
    every layer and unstacked leaf is the whole leaf where context
    parallelism gathers it over the model axis (the MLP's columns, the
    vocab rows), bit for bit; a decode step's model-axis gather brings in
    ``(M - 1) / M`` of those leaves' bytes."""
    rs = case_ranks(ranks, case)
    msh = rs[0]["mesh"]
    D, M = msh["data"], msh["model"]
    for rank, r in enumerate(rs):
        eng = ZeroInfinityEngine(RunConfig(model=W.serve_cfg(case, tconfigs),
                                           parallel=ParallelConfig(remat="none")), "cpu",
                                 mesh=mesh_mod.LocalMesh(D, M, rank, D * M, torch.device("cpu"),
                                                         None, "gloo"))
        assert eng.mp.strategy == "cp" and r["mesh"]["strategy"] == "cp"
        assert r["param_shard_bytes"][rank] == eng.shard_bytes()["param_shard_bytes"]
        assert r["gather"]["equal"], (case, rank)
        whole = sum(int(np.prod(d.shape)) * d.torch_dtype.itemsize
                    for p, d in zip(tpt.tree_paths(eng.bundle.defs),
                                    tpt.tree_leaves(eng.bundle.defs))
                    if eng._whole_over_model(p) is not None)
        # smollm's MLP and vocab split over 2; llava's over 3 do not
        assert bool(whole) == (M == 2), case
        assert r["mesh"]["model_gather_bytes_per_step"] == whole * (M - 1) // M


def test_serving_under_cp_raises_nothing_and_other_families_name_8g():
    """Context parallelism serves (no refusal), and so do the SSM and the
    hybrid on a model axis (8g.3, ``tests/test_torch_recurrent_tp.py``)
    and the encoder-decoder (8g.4, ``tests/test_torch_encdec_tp.py``): the
    engine each rank of ``launch.serve --model-mesh 2`` builds takes its
    strategy on a (1, 2) mesh, context parallelism where the heads do not
    split (the smoke smollm's 3, mamba2's none), tensor parallelism where
    they do."""
    base = ["--smoke", "--device", "cpu", "--batch", "2", "--model-mesh", "2"]
    for arch, strategy in (("smollm-135m", "cp"), ("mamba2-370m", "cp"),
                           ("recurrentgemma-9b", "tp"), ("seamless-m4t-medium", "tp")):
        args = tserve._parse(base + ["--arch", arch])
        eng = ZeroInfinityEngine(RunConfig(model=tconfigs.smoke(args.arch),
                                           parallel=ParallelConfig(remat="none")), "cpu",
                                 mesh=mesh_mod.LocalMesh(1, args.model_mesh, 0, 2,
                                                         torch.device("cpu"), None, "gloo"))
        assert eng.mp.strategy == strategy, arch


# ---------------------------------------------------------------------------
# the flash-decode combine on its own
# ---------------------------------------------------------------------------


def _draw(B=3, S=12, H=4, KV=2, D=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(B, 1, H, D, generator=gen).to(torch.bfloat16)
    k = torch.randn(B, S, KV, D, generator=gen).to(torch.bfloat16)
    v = torch.randn(B, S, KV, D, generator=gen).to(torch.bfloat16)
    return q, k, v


def _split_attention(q, k, v, lens, M):
    """``decode_partial`` over each of ``M`` ranks' ranges of the cache,
    each rank's valid count ``clamp(len - lo, 0, n)``, combined."""
    n = k.shape[1] // M
    parts = []
    for m in range(M):
        valid = torch.clamp(torch.as_tensor(lens) - m * n, 0, n)
        parts.append(tcm.decode_partial(q, k[:, m * n:(m + 1) * n], v[:, m * n:(m + 1) * n],
                                        valid))
    m_, l_, o_ = (torch.stack([p[i] for p in parts]) for i in range(3))
    B, _, H, D = q.shape
    return tcm.combine_partials(m_, l_, o_).reshape(B, 1, H, D)


@pytest.mark.parametrize("M", [2, 3, 4])
@pytest.mark.parametrize("lens", [[12, 12, 12], [1, 5, 12], [3, 7, 9]])
def test_combine_equals_decode_attention_on_the_whole_cache(M, lens):
    """Per-row lengths over 2-4 ranks, rows whose tail ranks hold no
    valid position among them: the combine against ``decode_attention``
    on the whole cache within bf16's rounding of its output (the
    reference rounds ``p / l`` to bf16 before the product, the combine
    normalises after it)."""
    q, k, v = _draw()
    want = tcm.decode_attention(q, k, v, torch.tensor(lens)).float()
    got = _split_attention(q, k, v, lens, M)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 2 ** -7 * want.abs().max(), (M, lens)


def test_an_empty_rank_contributes_exactly_zero():
    """A rank with no valid position: its ``m`` is ``NEG_INF``, its ``l``
    and ``o`` zero, and combining it with a rank's partial leaves that
    partial's normalised output bit for bit, with no NaN."""
    q, k, v = _draw(S=6)
    m0, l0, o0 = tcm.decode_partial(q, k, v, torch.tensor([3, 6, 1]))
    m1, l1, o1 = tcm.decode_partial(q, k, v, 0)
    assert (m1 == tcm.NEG_INF).all() and not l1.any() and not o1.any()
    alone = tcm.combine_partials(m0[None], l0[None], o0[None])
    both = tcm.combine_partials(torch.stack([m0, m1]), torch.stack([l0, l1]),
                                torch.stack([o0, o1]))
    assert torch.isfinite(both).all() and torch.equal(both, alone)
    assert torch.equal(alone, o0 / l0)


class _OneRank:
    """A model rank whose combine sees its own partial alone: enough to
    watch where ``attention_block`` writes a split cache."""

    tp, seq = False, False

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def stack(self, t):
        return t[None]


def test_a_decode_write_lands_on_its_positions_owner_alone():
    """A decode token at each position of a 12-slot cache split over 2
    ranks (6 a rank), one row at the boundary (position 6, rank 1's first)
    and one just before it (5, rank 0's last), one past capacity: each
    rank's cache changes only at the owner's local slot."""
    cfg = tconfigs.smoke("smollm-135m")
    gen = torch.Generator().manual_seed(3)
    p = {k: (torch.randn(d.shape, generator=gen) * 0.1).to(torch.bfloat16)
         for k, d in tcm.attn_defs(cfg).items()}
    B, n, KV, D = 3, 6, cfg.n_kv_heads, cfg.resolved_head_dim
    x = torch.randn(B, 1, cfg.d_model, generator=gen).to(torch.bfloat16)
    lens = torch.tensor([5, 6, 12], dtype=torch.int32)
    for m in range(2):
        k0 = torch.randn(B, n, KV, D, generator=gen).to(torch.bfloat16)
        v0 = torch.randn(B, n, KV, D, generator=gen).to(torch.bfloat16)
        cache = {"k": k0.clone(), "v": v0.clone(), "len": lens, "seq_lo": m * n}
        tcm.attention_block(p, x, lens.reshape(-1, 1), cfg, cache=cache, mp=_OneRank(m, 2))
        for b, pos in enumerate(lens.tolist()):
            own = m * n <= pos < (m + 1) * n
            for t0, t in ((k0, cache["k"]), (v0, cache["v"])):
                changed = (t[b] != t0[b]).flatten(1).any(1)
                assert changed.tolist() == [own and j == pos - m * n for j in range(n)], (m, b)


def test_decode_positions_keep_each_ranks_range_of_the_prompt():
    """``decode_positions`` on a prefill whose prompt is whole on the rank:
    under context parallelism with the capacity split, the rank's range of
    the prompt's positions (empty past the prompt) and its C / M capacity;
    without the split, every position and the whole capacity; under
    tensor parallelism or at one rank, the cache as it is."""
    P, C, M = 5, 12, 2
    k = torch.arange(P, dtype=torch.float32).reshape(1, 1, P, 1, 1).expand(2, 1, P, 1, 1)
    cache = {"k": k, "v": k + 100, "len": torch.tensor(P, dtype=torch.int32)}
    for m, want in ((0, [0, 1, 2, 3, 4]), (1, [])):
        mp = types.SimpleNamespace(rank=m, size=M, mesh=None, tp=False)
        got, own, n, split = kvcache.decode_positions(cache, mp, C)
        assert (own, n, split) == (len(want), C // M, True)
        assert got["k"][0, 0, :, 0, 0].tolist() == want
        assert got["v"][0, 0, :, 0, 0].tolist() == [w + 100 for w in want]
    mp = types.SimpleNamespace(rank=1, size=M, mesh=None, tp=False)
    got, own, n, split = kvcache.decode_positions(cache, mp, 13)
    assert (own, n, split) == (P, 13, False) and torch.equal(got["k"], k)
    for mp in (None, types.SimpleNamespace(tp=True)):
        assert kvcache.decode_positions(cache, mp, C) == (cache, P, C, False)
    assert [kvcache.seq_split(c, m) for c, m in ((12, 2), (13, 2), (21, 3), (12, 1))] == [
        True, False, True, False]
