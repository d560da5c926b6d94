"""The port's recurrentgemma family (``repro_torch/models/rglru.py``) against
the JAX package's (``repro/models/rglru.py``), on the CPU.

Covered: the odd/even ``associative_scan`` against
``jax.lax.associative_scan``; ``rg_lru`` for S from 2 to 50 (as
``tests/test_recurrences.py`` samples it) and its decode fast path; the bundle's loss
and every gradient (one group and the two-block tail: 5 layers); prefill
logits and caches below, at and past the window (the smoke window is 32),
the rings laid out as the reference's; decode across the ring's wrap with
per-slot lengths; the parameter count; ``remat="full"``; the GSPMD step in
every one-card placement against the reference's
``InfinityExecutor(engine="pjit")``; a checkpoint of the nested
``groups``/``tail`` tree as the reference's files; paging the nested cache
whole; the serve and train CLIs; and the explicit engine's refusal.

Tolerances, from the arithmetic:

* ``associative_scan`` under products of small integer 2x2 matrices:
  exact (every entry stays an integer below 2^24), so any other order of
  the non-commutative products would show.
* ``rg_lru``: f32 on both sides, combined in the same order; the
  transcendental functions (softplus, exp, sqrt, sigmoid) of the two
  libraries differ by an ulp or two and XLA may fuse a multiply-add:
  1e-5 relative to the largest element.
* the bundle's loss, logits, caches and gradients: bf16 activations
  rounded at other places in XLA and torch, one bf16 ulp (2^-8) per
  rounding compounded over a group: 2e-2 relative to the largest element,
  3e-2 for gradients and decode logits, the loss 2e-3 (the bounds of
  ``tests/test_torch_ssm.py``). The f32 LRU states carry the same bf16
  inputs: 2e-2.
* the GSPMD step: ``tests/test_torch_gspmd.py``'s bounds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import recurrent_parity as rp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import kvcache as jkv  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import RunConfig, make_offload, make_parallel  # noqa: E402
from repro_torch.core import kvcache as tkv  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core.offload import HostArrayStore  # noqa: E402
from repro_torch.core.zero import ExplicitZero3Engine  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402

ARCH = "recurrentgemma-9b"
LRU_REL = 1e-5
LOSS_REL = 2e-3
ACT_REL = 2e-2
GRAD_REL = 3e-2
LAYERS = 5  # one (rec, rec, attn) group and a two-block tail


@pytest.mark.parametrize("S", [1, 2, 3, 7, 8, 33])
def test_associative_scan_combines_in_the_references_order(S):
    """Under a non-commutative combine (2x2 integer matrix products, exact
    in f32) the scan equals the reference's element for element."""
    rng = np.random.default_rng(S)
    m = rng.integers(-2, 3, (2, S, 2, 2)).astype(np.float32)

    def jcomb(a, b):
        return (jnp.einsum("...ij,...jk->...ik", a[0], b[0]),)

    def tcomb(a, b):
        return (torch.einsum("...ij,...jk->...ik", a[0], b[0]),)

    want = jax.lax.associative_scan(jcomb, (jnp.asarray(m),), axis=1)[0]
    got = trg.associative_scan(tcomb, (torch.from_numpy(m),))[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _lru_inputs(S, r=16, seed=0):
    rng = np.random.default_rng(seed * 100 + S)
    x = rng.standard_normal((2, S, r)).astype(np.float32)
    rg = (1 / (1 + np.exp(-rng.standard_normal((2, S, r))))).astype(np.float32)
    ig = (1 / (1 + np.exp(-rng.standard_normal((2, S, r))))).astype(np.float32)
    lam = rng.standard_normal((r,)).astype(np.float32)
    h0 = rng.standard_normal((2, r)).astype(np.float32)
    return x, rg, ig, lam, h0


# S from 2 to 50 as tests/test_recurrences.py samples it: every S up to 9
# (each parity pattern of the recursion's first three levels) and the
# lengths around 16, 32 and 50
@pytest.mark.parametrize("S", list(range(2, 10)) + [15, 16, 17, 31, 32, 33, 49, 50])
def test_rg_lru_matches_the_reference_associative_scan(S):
    x, rg, ig, lam, h0 = _lru_inputs(S)
    yj, hj = jax.jit(jrg.rg_lru)(*(jnp.asarray(a) for a in (x, rg, ig, lam)),
                                 h0=jnp.asarray(h0))
    yt, ht = trg.rg_lru(*(torch.from_numpy(a) for a in (x, rg, ig, lam)),
                        h0=torch.from_numpy(h0))
    rp.close(yt, yj, LRU_REL, "y")
    rp.close(ht, hj, LRU_REL, "h_last")


def test_rg_lru_decode_fast_path_matches_reference():
    x, rg, ig, lam, h0 = _lru_inputs(1)
    yj, hj = jrg.rg_lru(*(jnp.asarray(a) for a in (x, rg, ig, lam)), h0=jnp.asarray(h0))
    yt, ht = trg.rg_lru(*(torch.from_numpy(a) for a in (x, rg, ig, lam)),
                        h0=torch.from_numpy(h0))
    rp.close(yt, yj, LRU_REL, "y")
    rp.close(ht, hj, LRU_REL, "h")


@pytest.fixture(scope="module")
def bundles():
    return rp.bundles(ARCH, LAYERS)


def test_defs_and_cache_defs_match_reference():
    jcfg, tcfg = rp.cfgs(ARCH, LAYERS)
    is_def = lambda d: hasattr(d, "axes")  # noqa: E731
    jdefs = jax.tree_util.tree_flatten_with_path(jrg.param_defs(jcfg), is_leaf=is_def)[0]
    tdefs = tpt.tree_paths(trg.param_defs(tcfg))
    assert [tuple(k.key for k in p) for p, _ in jdefs] == tdefs
    assert [(d.shape, d.axes, d.dtype, d.init) for d in tpt.tree_leaves(trg.param_defs(tcfg))] \
        == [(d.shape, d.axes, d.dtype, d.init) for _, d in jdefs]
    jc = jax.tree.leaves(jreg.build(jcfg).cache_defs(3, 64), is_leaf=is_def)
    tc = tpt.tree_leaves(treg.build(tcfg).cache_defs(3, 64))
    assert [(d.shape, d.axes, d.dtype) for d in tc] == [(d.shape, d.axes, d.dtype) for d in jc]


def test_bundle_loss_and_every_gradient_match_reference_past_the_window(bundles):
    rp.loss_and_grads(bundles, 1, 45, LOSS_REL, GRAD_REL)


@pytest.mark.parametrize("Sn", [20, 32, 45])  # below, at and past the window
def test_prefill_logits_and_ring_caches_match_reference(bundles, Sn):
    jcfg, jb, jparams, tb, tparams = bundles
    toks = rp.tokens(jcfg, 5, Sn=Sn)
    lj, jc = jax.jit(jb.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    lt, tc = tb.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    rp.close(lt, lj, ACT_REL, "prefill logits")
    jl, tl = rp.cache_leaves(jc), rp.cache_leaves(tc)
    assert list(tl) == list(jl)
    for key, leaf in tl.items():
        assert leaf.shape == tuple(jl[key].shape), key
        rp.close(leaf, jl[key], ACT_REL, key)
    assert tl["groups/attn/k"].shape[2] == jcfg.window
    assert int(tc["len"]) == Sn


def test_decode_across_the_ring_wrap_with_per_slot_lengths_matches_reference(bundles):
    """Two prompts, one below the window and one past it, prefill alone and
    decode as one batch with per-slot lengths; the shorter one's ring
    fills and wraps during the decode."""
    jcfg, jb, jparams, tb, tparams = bundles
    toks = rp.tokens(jcfg, 6, Sn=60)
    lens = (29, 40)
    jcs, tcs = [], []
    for row, n in enumerate(lens):
        jcs.append(jax.jit(jb.prefill)(jparams, {"tokens": jnp.asarray(toks[row:row + 1, :n])})[1])
        tcs.append(tb.prefill(tparams, {"tokens": torch.from_numpy(toks[row:row + 1, :n])})[1])
    jc = jax.tree.map(lambda *ls: jnp.concatenate(ls, axis=1),
                      *[{k: v for k, v in c.items() if k != "len"} for c in jcs])
    tc = {}
    for path in tpt.tree_paths(tcs[0]):
        if path != ("len",):
            tpt.tree_set(tc, path, torch.cat([tpt.tree_get(c, path) for c in tcs], dim=1))
    jc["len"] = jnp.asarray(lens, jnp.int32)
    tc["len"] = torch.tensor(lens, dtype=torch.int32)
    jdec = jax.jit(jb.decode_step)
    for i in range(8):  # row 0 passes len 32 (its first wrap) at step 3
        step = np.stack([toks[r, lens[r] + i] for r in range(2)])[:, None]
        lj, jc = jdec(jparams, jc, {"tokens": jnp.asarray(step)})
        lt, tc = tb.decode_step(tparams, tc, {"tokens": torch.from_numpy(step)})
        rp.close(lt, lj, GRAD_REL, f"decode step {i}")
    jl = rp.cache_leaves(jc)
    for key, leaf in rp.cache_leaves(tc).items():
        if key != "len":
            rp.close(leaf, jl[key], GRAD_REL, f"decoded {key}")
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_param_count_and_cache_bytes_match_reference():
    jb, tb = jreg.build(jconfigs.get(ARCH)), treg.build(tconfigs.get(ARCH))
    assert tb.n_params() == jb.n_params() == 9_396_301_824
    for ctx in (16, 2592, 32768):
        assert tkv.sequence_kv_bytes(tconfigs.get(ARCH), ctx) == \
            jkv.sequence_kv_bytes(jconfigs.get(ARCH), ctx)


def test_remat_dots_saves_the_products_bit_equal_to_none():
    """The group's attention recomputed (its flash forward twice), the
    MLP products saved (the plain matmul as under ``none``)."""
    n = rp.remat_dots_saves_the_products(rp.cfgs(ARCH, LAYERS)[1], 4)
    assert n["none"]["attention"] == 1 and n["dots"]["attention"] == 2


def test_remat_dots_loss_and_every_gradient_match_reference_past_the_window():
    rp.loss_and_grads(rp.bundles(ARCH, LAYERS, remat="dots"), 1, 45, LOSS_REL, GRAD_REL)


def test_remat_dots_keeps_the_reference_products_and_each_blocks_last():
    """What ``dots`` keeps over the group and the two tail blocks: the
    reference's residuals (the recurrences' gate and in projections, the
    f32 RG-LRU gates, the out projections, the MLPs' up and gate
    projections and every down projection but the block's last), plus
    each block's last down projection."""
    port, last, ref = rp.saved_product_bytes(ARCH, LAYERS)
    cfg = rp.cfgs(ARCH, LAYERS)[1]
    assert last == 3 * 2 * 16 * cfg.d_model * 2  # one group, two tail blocks
    assert port - last == ref > 0


def test_remat_full_recomputes_to_the_same_loss_and_gradients():
    rp.remat_full_equals_none(rp.cfgs(ARCH, LAYERS)[1], 4)


def test_explicit_engine_refuses_the_family_in_the_reference_words():
    run = RunConfig(model=tconfigs.smoke(ARCH), parallel=make_parallel("zero3"),
                    offload=make_offload())
    with pytest.raises(NotImplementedError, match="dense and moe families only"):
        ExplicitZero3Engine(run, "cpu")


def test_paged_cache_parks_nested_leaves_whole_and_fetches_them_back():
    cfg = rp.cfgs(ARCH, LAYERS)[1]
    tb = treg.build(cfg)
    params = tb.init(torch.Generator().manual_seed(0))
    _, cache = tb.prefill(params, {"tokens": torch.from_numpy(rp.tokens(cfg, 7, Sn=40))})
    kv = tkv.PagedKVCache(HostArrayStore(), block_tokens=16, seq_axis_names=())
    one = tkv.slice_sequence(cache, 1)
    n = kv.park("s", one, 40)
    assert n == tkv.device_kv_bytes(one) == tkv.sequence_kv_bytes(cfg, 40)  # len placeholder too
    got, length = kv.fetch("s", 56)
    assert length == 40 and tpt.tree_paths(got) == tpt.tree_paths(one)
    for path in tpt.tree_paths(one):
        assert torch.equal(tpt.tree_get(got, path), tpt.tree_get(one, path)), path
    kv.store.close()


# ---------------------------------------------------------------------------
# the GSPMD step, every one-card placement
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh(1, 1)


@pytest.fixture(scope="module")
def reference(mesh):
    return rp.reference_run(ARCH, mesh)


@pytest.fixture(scope="module", params=list(rp.PLACEMENTS))
def placed(request, tmp_path_factory, reference):
    return request.param, rp.run_placement(ARCH, request.param,
                                           tmp_path_factory.mktemp(request.param), reference)


@pytest.mark.parametrize("step", range(rp.STEPS))
def test_gspmd_step_matches_reference_loss_grad_norm_and_lr(placed, step):
    rp.check_step(placed[1], step)


def test_gspmd_params_after_last_step_match_reference(placed):
    rp.check_params(placed[1])


def test_gspmd_optimizer_states_match_reference(placed):
    rp.check_optimizer(placed[1], placed[0] in rp.OFFGRAPH)


def test_checkpoint_of_the_nested_tree_is_the_reference_files_both_ways(tmp_path, mesh):
    keys = rp.checkpoint_both_ways(ARCH, LAYERS, tmp_path, mesh)
    assert "params/groups/rec1/lam" in keys and "params/tail/mlp/mlp/w_gate" in keys
    assert "opt/v/groups/attn/attn/wq" in keys


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------


def test_serve_cli_past_the_window_pages_whole_caches_through_the_host_tier():
    """Prompts past the smoke window (32), 5 sequences through 2 slots at
    5 layers: the waiting caches park whole and come back whole."""
    args = tserve._parse(["--arch", ARCH, "--smoke", "--layers", str(LAYERS), "--device", "cpu",
                          "--batch", "5", "--kv-slots", "2", "--kv-tier", "host",
                          "--prompt-len", "40", "--new-tokens", "6"])
    out = tserve.run_serve(args, [])
    assert all(out["done"]) and all(len(g) == 6 for g in out["generated"])
    per_seq = tkv.sequence_kv_bytes(rp.cfgs(ARCH, LAYERS)[1], 46)  # the len placeholder too
    assert out["admissions"] == 3 and out["kv"]["out_bytes"] == 3 * per_seq
    assert out["kv"]["resident_bytes"] == 2 * (per_seq - 4) + 2 * 4  # two slots and their lengths


def test_train_cli_plans_and_trains_past_the_window_with_falling_loss(tmp_path, capsys):
    hist = ttrain.main(["--arch", ARCH, "--smoke", "--layers", str(LAYERS), "--device", "cpu",
                        "--plan", "auto", "--steps", "6", "--batch", "2", "--seq", "48",
                        "--lr", "3e-3", "--ckpt-every", "0", "--nvme-dir", str(tmp_path)])
    losses = hist["losses"]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert "done in" in capsys.readouterr().out
