"""The port's MoE family (``repro_torch/models/moe.py``) against the JAX
package's (``repro/models/moe.py``), on the CPU.

Both smoke MoE configs: granite (8 experts, top-2) and llama4-scout (4
experts, top-1). Inputs come from numpy seeds; the bundles' weights are
the reference's ``init`` carried across by ``repro_torch.bridge``.

Tolerances, from the arithmetic:

* router logits: both sides multiply the bf16-rounded operands in f32, so
  they differ only in summation order: 1e-5 relative to the largest logit.
* the routing plan (counts, the slots' tokens, occupancy) must be equal.
  A choice flips only where a token's k-th and (k+1)-th gates lie within
  the logits' tolerance of each other; a mismatch is reported with each
  such token's margin (the inputs are not re-drawn to avoid one).
* gate weights: f32 softmax and renormalization, 1e-6.
* MoE outputs and the bundles' losses, logits and gradients: bf16
  activations rounded at other places in XLA and torch, one bf16 ulp
  (2^-8 relative) per rounding compounded over a few ops: 2e-2 relative to
  the largest element (the dense bundle's bound in
  ``tests/test_torch_models.py``); gradients 3e-2. Under top-1 the
  router's gradient is analytically zero (the renormalized gate is 1), so
  both sides hold f32 rounding noise there, a few ulps of the gate's
  cotangent (O(10) at most here): it is held to 1e-5 absolute
  (``ZERO_GRAD_ATOL``).
* a partition of the selected experts into waves against ``moe_ffn``: in
  f32 the two differ only in the order each token's k outputs are summed
  (1e-5 relative); the padded slot of a wave takes exactly zero gradient.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import recurrent_parity as rp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.config import make_parallel as jmake_parallel  # noqa: E402
from repro.core import kvcache as jkv  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import ParallelConfig  # noqa: E402
from repro_torch.core import kvcache as tkv  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "llama4-scout-17b-a16e"]
RULES = jreg.NULL_RULES
LOGIT_REL = 1e-5
ACT_REL = 2e-2
GRAD_REL = 3e-2
ZERO_GRAD_ATOL = 1e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: max rel err {err} > {tol}"


def _cfgs(arch):
    jcfg, tcfg = jconfigs.smoke(arch), tconfigs.smoke(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _bf16(arr):
    arr = np.asarray(arr, np.float32)
    return jnp.asarray(arr).astype(jnp.bfloat16), torch.from_numpy(arr).to(torch.bfloat16)


def _route_inputs(cfg, seed, G=3, T=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, T, cfg.d_model)).astype(np.float32)
    router = (rng.standard_normal((cfg.d_model, cfg.n_experts)) * 0.3).astype(np.float32)
    return x, router


def _margins(logits: np.ndarray, k: int) -> np.ndarray:
    """Each token's gap between its k-th and (k+1)-th gate logit."""
    srt = -np.sort(-logits, axis=-1)
    if k >= logits.shape[-1]:
        return np.full(logits.shape[:-1], np.inf)
    return srt[..., k - 1] - srt[..., k]


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_tokens_matches_reference(arch, seed):
    jcfg, tcfg = _cfgs(arch)
    x, router = _route_inputs(jcfg, seed)
    xj, xt = _bf16(x)
    want = jmoe.route_tokens(jnp.asarray(router), xj, jcfg)
    got = tmoe.route_tokens(torch.from_numpy(router), xt, tcfg)
    lj = np.asarray(jnp.einsum("gtd,de->gte", xj, jnp.asarray(router).astype(jnp.bfloat16),
                               preferred_element_type=jnp.float32))
    lt = torch.matmul(xt.float(), torch.from_numpy(router).to(torch.bfloat16).float()).numpy()
    _close(lt, lj, LOGIT_REL, "router logits")
    near = np.argwhere(_margins(lj, jcfg.top_k) <= LOGIT_REL * np.abs(lj).max())
    valid = np.asarray(want["valid_ec"])
    for key in ("counts", "valid_ec"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), \
            f"{key} differs; tokens with a top-k margin under the logits' tolerance: {near}"
    # an empty slot's token index is an arbitrary clipped read on both sides
    assert np.array_equal(np.where(valid, got["tok_ec"].numpy(), -1),
                          np.where(valid, np.asarray(want["tok_ec"]), -1)), \
        f"tok_ec differs; near-tied tokens: {near}"
    np.testing.assert_allclose(got["w_ec"].numpy(), np.asarray(want["w_ec"]), atol=1e-6)
    assert got["cap"] == want["cap"] == jmoe._capacity(jcfg, x.shape[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_inverse_slot_map_is_the_transpose_of_the_slot_plan(arch):
    """Every occupied slot's token lists that slot among its choices exactly
    once; every other choice of a token is dropped (``inv`` == E * C)."""
    _, tcfg = _cfgs(arch)
    x, router = _route_inputs(tcfg, 5, G=2, T=32)
    r = tmoe.route_tokens(torch.from_numpy(router), torch.from_numpy(x).to(torch.bfloat16), tcfg)
    G, E, C = r["tok_ec"].shape
    inv = r["inv"].numpy()
    seen = np.zeros_like(inv, dtype=bool)
    for g in range(G):
        for e in range(E):
            for c in range(C):
                if r["valid_ec"][g, e, c]:
                    t = int(r["tok_ec"][g, e, c])
                    hits = np.nonzero(inv[g, t] == e * C + c)[0]
                    assert len(hits) == 1, (g, e, c, inv[g, t])
                    seen[g, t, hits[0]] = True
    assert np.all(inv[~seen] == E * C)
    kept = int(r["valid_ec"].sum())
    assert kept == int(np.minimum(r["counts"].numpy(), C).sum()) == int(seen.sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_routing_stats_match_reference(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, (3, 8)).astype(np.int32)
    want = jmoe.routing_stats(jnp.asarray(counts), 4, 2)
    got = tmoe.routing_stats(torch.from_numpy(counts).long(), 4, 2)
    for key in want:
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), rtol=1e-7)


def _moe_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    arrs = {"router": (rng.standard_normal((d, E)) * 0.3).astype(np.float32),
            "w_in": (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32),
            "w_gate": (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32),
            "w_out": (rng.standard_normal((E, f, d)) * f ** -0.5).astype(np.float32)}
    jp = {k: jnp.asarray(v) if k == "router" else jnp.asarray(v).astype(jnp.bfloat16)
          for k, v in arrs.items()}
    tp = {k: torch.from_numpy(v) if k == "router" else torch.from_numpy(v).to(torch.bfloat16)
          for k, v in arrs.items()}
    return jp, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_value_stats_and_gradients_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _moe_params(jcfg, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    xj, xt = _bf16(x)

    def jf(p, x):
        y, st = jmoe.moe_ffn(p, x, jcfg, RULES, with_stats=True)
        return jnp.sum(y.astype(jnp.float32) * dy), (y, st)

    (_, (yj, stj)), (gpj, gxj) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(jp, xj)
    tpl = {k: v.detach().requires_grad_() for k, v in tp.items()}
    xl = xt.detach().requires_grad_()
    yt, stt = tmoe.moe_ffn(tpl, xl, tcfg, with_stats=True)
    grads = torch.autograd.grad(torch.sum(yt.float() * torch.from_numpy(dy)),
                                [xl] + [tpl[k] for k in sorted(tpl)])
    _close(yt, yj, ACT_REL, "moe_ffn")
    for key in stj:
        np.testing.assert_allclose(_np(stt[key]), np.asarray(stj[key]), rtol=1e-6)
    _close(grads[0], gxj, GRAD_REL, "dx")
    for k, g in zip(sorted(tpl), grads[1:]):
        if k == "router" and jcfg.top_k == 1:
            np.testing.assert_allclose(_np(g), np.asarray(gpj[k], np.float32),
                                       atol=ZERO_GRAD_ATOL)
        else:
            _close(g, gpj[k], GRAD_REL, k)


def _waves(sel, W):
    out = []
    for i in range(0, len(sel), W):
        wave = sel[i:i + W]
        pad = W - len(wave)
        out.append((wave, wave + [wave[-1]] * pad, [1.0] * len(wave) + [0.0] * pad))
    return out


def _selected_rows(p, ids, lib):
    take = (lambda a: jnp.take(a, jnp.asarray(ids), axis=0)) if lib == "jax" else \
        (lambda a: a[torch.tensor(ids)])
    return {k: take(v) for k, v in p.items() if k != "router"}


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_selected_matches_reference_wave_by_wave(arch):
    """Waves of ``top_k`` selected experts (the last one padded by repeating
    its last id under a zero mask), as the layered epoch runs them."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _moe_params(jcfg, 6)
    x = np.random.default_rng(7).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    xj, xt = _bf16(x)
    counts = np.asarray(jmoe.moe_counts(jp["router"], xj, jcfg)).sum(0)
    sel = [int(e) for e in np.nonzero(counts > 0)[0]]
    W = max(jcfg.top_k, 3)  # at least one padded slot on every arch
    for wave, ids, mask in _waves(sel, W):
        want = jmoe.moe_ffn_selected(jp["router"], _selected_rows(jp, ids, "jax"), xj,
                                     jnp.asarray(ids, jnp.int32), jnp.asarray(mask), jcfg,
                                     RULES)
        got = tmoe.moe_ffn_selected(tp["router"], _selected_rows(tp, ids, "torch"), xt,
                                    torch.tensor(ids), torch.tensor(mask), tcfg)
        _close(got, want, ACT_REL, f"wave {wave}")


@pytest.mark.parametrize("arch", ARCHS)
def test_a_partition_into_waves_sums_to_moe_ffn(arch):
    _, tcfg = _cfgs(arch)
    _, tp = _moe_params(tcfg, 8)
    tp = {k: v.float() for k, v in tp.items()}
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32))
    full = tmoe.moe_ffn(tp, x, tcfg)
    counts = tmoe.moe_counts(tp["router"], x, tcfg).sum(0)
    sel = [int(e) for e in torch.nonzero(counts > 0).flatten()]
    total = torch.zeros_like(full)
    for _, ids, mask in _waves(sel, 3):
        total = total + tmoe.moe_ffn_selected(tp["router"], _selected_rows(tp, ids, "torch"),
                                              x, torch.tensor(ids), torch.tensor(mask), tcfg)
    _close(total, full, 1e-5, "sum of waves")


def test_a_padded_wave_slot_takes_no_gradient():
    """The padded slot repeats a real expert's row under a zero mask: its
    row's gradient is exactly zero, and the real row's is what a wave
    without padding gives it."""
    _, tcfg = _cfgs("granite-moe-1b-a400m")
    _, tp = _moe_params(tcfg, 10)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    counts = tmoe.moe_counts(tp["router"], x, tcfg).sum(0)
    e = int(torch.nonzero(counts > 0)[0])

    def row_grads(ids, mask):
        rows = {k: v.detach().requires_grad_() for k, v in
                _selected_rows(tp, ids, "torch").items()}
        y = tmoe.moe_ffn_selected(tp["router"], rows, x, torch.tensor(ids),
                                  torch.tensor(mask), tcfg)
        return torch.autograd.grad(y.float().sum(), [rows[k] for k in sorted(rows)])

    padded = row_grads([e, e], [1.0, 0.0])
    alone = row_grads([e], [1.0])
    for gp, ga in zip(padded, alone):
        assert torch.equal(gp[1], torch.zeros_like(gp[1]))
        assert torch.equal(gp[0], ga[0])
        assert gp[0].abs().sum() > 0


# ---------------------------------------------------------------------------
# the bundle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def bundles(request):
    jcfg, tcfg = _cfgs(request.param)
    jb = jreg.build(jcfg)
    jparams = jb.init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, jb, jparams, treg.build(tcfg), tparams


def _tokens(cfg, seed, B=2, S=16):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _torch_value_and_grad(fn, params, batch):
    paths = tpt.tree_paths(params)
    leaves = [tpt.tree_get(params, p).detach().requires_grad_() for p in paths]
    live: dict = {}
    for p, leaf in zip(paths, leaves):
        tpt.tree_set(live, p, leaf)
    loss, aux = fn(live, batch)
    return loss, aux, dict(zip(paths, torch.autograd.grad(loss, leaves)))


def test_bundle_loss_stats_and_gradients_match_reference(bundles):
    _check_loss_stats(bundles)


def _check_loss_stats(bundles):
    jcfg, jb, jparams, tb, tparams = bundles
    toks, labels = _tokens(jcfg, 1), _tokens(jcfg, 2)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    (lj, auxj), gj = jax.jit(jax.value_and_grad(jb.loss_stats, has_aux=True))(jparams, jbatch)
    lt, auxt, gt = _torch_value_and_grad(tb.loss_stats, tparams, tbatch)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=2e-3)
    np.testing.assert_allclose(float(auxt["moe_dropped_token_fraction"]),
                               float(auxj["moe_dropped_token_fraction"]), rtol=1e-6)
    np.testing.assert_allclose(_np(auxt["moe_expert_load"]),
                               np.asarray(auxj["moe_expert_load"]), rtol=1e-6)
    assert auxt["moe_expert_load"].shape == (jcfg.n_experts,)
    for path, g in gt.items():
        want = gj
        for k in path:
            want = want[k]
        if path[-1] == "router" and jcfg.top_k == 1:
            np.testing.assert_allclose(_np(g), np.asarray(want, np.float32),
                                       atol=ZERO_GRAD_ATOL)
        else:
            _close(g, want, GRAD_REL, "/".join(path))
    assert float(tb.loss(tparams, tbatch)) == float(lt.detach())


def test_bundle_prefill_and_teacher_forced_decode_match_reference(bundles):
    jcfg, jb, jparams, tb, tparams = bundles
    S, n = 16, 3
    toks = _tokens(jcfg, 3, S=S + n)
    lj, jc = jax.jit(jb.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    lt, tc = tb.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S])})
    _close(lt, lj, ACT_REL, "prefill logits")
    _close(tc["k"], jc["k"], ACT_REL, "prefill k cache")
    jc = {**jkv.pad_seq_caches(jc, n), "len": jnp.full((2,), S, jnp.int32)}
    tc = {**tkv.pad_seq_caches(tc, n), "len": torch.full((2,), S, dtype=torch.int32)}
    jdec = jax.jit(jb.decode_step)
    for i in range(n):
        step = toks[:, S + i:S + i + 1]
        lj, jc = jdec(jparams, jc, {"tokens": jnp.asarray(step)})
        lt, tc = tb.decode_step(tparams, tc, {"tokens": torch.from_numpy(step)})
        _close(lt, lj, 3e-2, f"decode step {i}")
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_remat_dots_saves_the_router_bit_equal_to_none():
    """The router's ``mm`` saved, the experts' batched einsums and the
    attention recomputed (its plain forward as often as under ``full``),
    gradients equal ``none``'s."""
    n = rp.remat_dots_saves_the_products(_cfgs("granite-moe-1b-a400m")[1], 4)
    assert n["dots"]["attention"] == 2 * n["none"]["attention"] > 0


def test_remat_dots_loss_stats_and_gradients_match_reference():
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m")
    jb = jreg.build(jcfg, parallel=jmake_parallel("pjit", remat="dots"))
    jparams = jax.jit(jb.init)(jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    _check_loss_stats((jcfg, jb, jparams,
                       treg.build(tcfg, ParallelConfig(remat="dots")), tparams))


def test_remat_full_recomputes_to_the_same_loss_and_gradients():
    _, tcfg = _cfgs("granite-moe-1b-a400m")
    params = treg.build(tcfg).init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(tcfg, 4))
    batch = {"tokens": toks, "labels": toks}
    out = {}
    for remat in ("none", "full"):
        tb = treg.build(tcfg, ParallelConfig(remat=remat))
        out[remat] = _torch_value_and_grad(tb.loss_stats, params, batch)
    assert torch.equal(out["none"][0], out["full"][0])
    for path in out["none"][2]:
        assert torch.equal(out["none"][2][path], out["full"][2][path]), path


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    """The full configs' totals, and the active count (experts-axis leaves
    at top_k / E): what 6 * N_active * D reads."""
    jb, tb = jreg.build(jconfigs.get(arch)), treg.build(tconfigs.get(arch))
    assert tb.n_params() == jb.n_params()
    assert tb.n_params_active() == jb.n_params_active()
    if arch == "granite-moe-1b-a400m":
        assert (tb.n_params(), tb.n_params_active()) == (1_336_722_432, 430_752_768)


def test_moe_defs_and_expert_rows_match_reference():
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        want = jmoe.expert_row_defs(jcfg)
        got = tmoe.expert_row_defs(tcfg)
        assert list(got) == list(want) and tmoe.expert_leaf_names(tcfg) == \
            jmoe.expert_leaf_names(jcfg)
        for k in want:
            assert (got[k].shape, got[k].axes, got[k].dtype) == \
                (want[k].shape, want[k].axes, want[k].dtype)
        for T in (1, 16, 512, 1024):
            assert tmoe._capacity(tcfg, T) == jmoe._capacity(jcfg, T)
