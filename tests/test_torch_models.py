"""The port's dense model against the JAX package, module by module, on the
CPU (where the port's kernels run their plain versions).

Inputs come from numpy seeds; weights come from the reference's
``registry.build(cfg).init(PRNGKey(0))`` through ``repro_torch.bridge``.
Tolerances: f32 paths differ only in summation order and transcendental
implementations (1e-5 .. 1e-4); bf16 paths round intermediates at
different places in XLA and torch, one bf16 ulp (~4e-3 relative) per
rounding, compounded over a few layers (stated per test). Across
frameworks logits are compared under teacher forcing, never as
free-running greedy tokens: a bf16 near-tie may flip an argmax.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import kvcache as jkv  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import kvcache as tkv  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

RULES = jreg.NULL_RULES


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, rel=False):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30) if rel else 1.0
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max {'rel' if rel else 'abs'} err {err} > {tol}"


def _both(arr, dtype="float32"):
    arr = np.asarray(arr, np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(arr).astype(jnp.bfloat16), torch.from_numpy(arr).to(torch.bfloat16)
    return jnp.asarray(arr), torch.from_numpy(arr)


@pytest.fixture(scope="module")
def smoke():
    """smollm smoke config in both packages + bridged reference weights."""
    jcfg = jconfigs.smoke("smollm-135m")
    tcfg = tconfigs.smoke("smollm-135m")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jb = jreg.build(jcfg)
    jparams = jb.init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jb, jparams, treg.build(tcfg), tparams


def test_bridge_is_bit_exact(smoke):
    _, _, _, jparams, _, tparams = smoke
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert flat
    for path, leaf in flat:
        t = tparams
        for p in path:
            t = t[p.key]
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)
        np.testing.assert_array_equal(_np(t), _np(leaf))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_and_layer_norm(dtype):
    rng = np.random.default_rng(1)
    xj, xt = _both(rng.standard_normal((2, 5, 48)), dtype)
    sj, st = _both(rng.standard_normal(48) * 0.5)  # nonzero: (1 + scale)
    bj, bt = _both(rng.standard_normal(48) * 0.5)
    tol = 1e-5 if dtype == "float32" else 8e-3  # one bf16 ulp at |x| ~ 2
    _close(tcm.rms_norm(xt, st), jcm.rms_norm(xj, sj), tol, rel=True)
    _close(tcm.layer_norm(xt, st, bt), jcm.layer_norm(xj, sj, bj), tol, rel=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_rotates_split_halves(dtype):
    rng = np.random.default_rng(2)
    xj, xt = _both(rng.standard_normal((2, 7, 3, 16)), dtype)
    pos = np.stack([np.arange(7), np.arange(7) + 40]).astype(np.int32)  # per-row offsets
    got = tcm.rope(xt, torch.from_numpy(pos), 10000.0)
    want = jcm.rope(xj, jnp.asarray(pos), 10000.0)
    _close(got, want, 1e-5 if dtype == "float32" else 8e-3, rel=True)


def test_decode_attention_per_row_lengths():
    rng = np.random.default_rng(3)
    qj, qt = _both(rng.standard_normal((3, 1, 4, 16)) * 0.5)
    kj, kt = _both(rng.standard_normal((3, 12, 2, 16)) * 0.5)
    vj, vt = _both(rng.standard_normal((3, 12, 2, 16)) * 0.5)
    lens = np.array([5, 12, 1], np.int32)
    got = tcm.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    want = jcm.decode_attention(qj, kj, vj, jnp.asarray(lens))
    _close(got, want, 1e-5)


def test_scatter_cache_index_write_matches_one_hot():
    """Per-row write positions, one at capacity: the reference's one-hot
    form drops it, and so does the port's in-place index write."""
    rng = np.random.default_rng(4)
    cache = rng.standard_normal((3, 10, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    pos = np.array([0, 9, 10], np.int32)
    want = jcm._scatter_cache(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos))
    t = torch.from_numpy(cache.copy())
    got = tcm._scatter_cache(t, torch.from_numpy(new), torch.from_numpy(pos))
    assert got.data_ptr() == t.data_ptr()  # in place
    np.testing.assert_array_equal(_np(got), _np(want))
    # a scalar position broadcasts over rows, as in lockstep decode
    want = jcm._scatter_cache(jnp.asarray(cache), jnp.asarray(new), 3)
    got = tcm._scatter_cache(torch.from_numpy(cache.copy()), torch.from_numpy(new), 3)
    np.testing.assert_array_equal(_np(got), _np(want))


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def test_attention_block_prefill_and_decode(smoke):
    """Prefill (the flash path, Sq == Sk so both causal alignments agree)
    collects bf16 K/V; decode writes at per-row lengths and attends."""
    jcfg, tcfg, _, jparams, _, tparams = smoke
    jp = _layer0(jparams["blocks"]["attn"])
    tp = {k: v[0] for k, v in tparams["blocks"]["attn"].items()}
    rng = np.random.default_rng(5)
    B, S = 2, 12
    xj, xt = _both(rng.standard_normal((B, S, jcfg.d_model)), "bfloat16")
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jout, jkv_ = jcm.attention_block(jp, xj, jnp.asarray(pos), jcfg, RULES, collect_kv=True)
    tout, tkv_ = tcm.attention_block(tp, xt, torch.from_numpy(pos.copy()), tcfg, collect_kv=True)
    # bf16 projections (K = 48) then attention: a couple of bf16 ulps
    _close(tout, jout, 2e-2, rel=True)
    _close(tkv_["k"], jkv_["k"], 2e-2, rel=True)
    _close(tkv_["v"], jkv_["v"], 2e-2, rel=True)

    cache = np.zeros((B, S + 2, jcfg.n_kv_heads, jcfg.resolved_head_dim), np.float32)
    cache[:, :S] = _np(jkv_["k"])
    vcache = np.zeros_like(cache)
    vcache[:, :S] = _np(jkv_["v"])
    lens = np.array([S, S - 3], np.int32)
    x1j, x1t = _both(rng.standard_normal((B, 1, jcfg.d_model)), "bfloat16")
    jc = {"k": jnp.asarray(cache).astype(jnp.bfloat16),
          "v": jnp.asarray(vcache).astype(jnp.bfloat16), "len": jnp.asarray(lens)}
    tc = {"k": torch.from_numpy(cache).to(torch.bfloat16),
          "v": torch.from_numpy(vcache).to(torch.bfloat16), "len": torch.from_numpy(lens)}
    jout, jnew = jcm.attention_block(jp, x1j, jnp.asarray(lens)[:, None], jcfg, RULES, cache=jc)
    tout, tnew = tcm.attention_block(tp, x1t, tc["len"][:, None], tcfg, cache=tc)
    _close(tout, jout, 2e-2, rel=True)
    _close(tnew["k"], jnew["k"], 2e-2, rel=True)
    np.testing.assert_array_equal(tnew["len"].numpy(), np.asarray(jnew["len"]))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_block_every_kind(kind):
    jcfg = dataclasses.replace(jconfigs.smoke("smollm-135m"), mlp_kind=kind)
    tcfg = dataclasses.replace(tconfigs.smoke("smollm-135m"), mlp_kind=kind)
    rng = np.random.default_rng(6)
    d, f = jcfg.d_model, jcfg.d_ff
    names = {"w_in": (d, f), "w_out": (f, d)}
    if kind in ("swiglu", "geglu"):
        names["w_gate"] = (d, f)
    jp, tp = {}, {}
    for n, shp in names.items():
        jp[n], tp[n] = _both(rng.standard_normal(shp) * 0.2, "bfloat16")
    xj, xt = _both(rng.standard_normal((2, 5, d)), "bfloat16")
    # two bf16 products around a bf16 activation
    _close(tcm.mlp_block(tp, xt, tcfg), jcm.mlp_block(jp, xj, jcfg, RULES), 2e-2, rel=True)


@pytest.mark.parametrize("tiles,axis", [(2, "n"), (4, "k")])
def test_tiled_linear_equals_untiled(tiles, axis):
    from repro.core.tiling import tiled_matmul_xla
    from repro_torch.core.tiling import tiled_matmul

    rng = np.random.default_rng(7)
    xj, xt = _both(rng.standard_normal((3, 4, 32)), "bfloat16")
    wj, wt = _both(rng.standard_normal((32, 16)) * 0.2, "bfloat16")
    _close(tiled_matmul(xt, wt, tiles, axis), tiled_matmul_xla(xj, wj, tiles, axis),
           1e-2, rel=True)


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma-7b", "nemotron-4-340b"])
def test_embed_and_logits(arch):
    """bf16 gather (gemma scales by sqrt(d)); tied and untied logits over
    the padded vocab; an optional softcap."""
    jcfg = dataclasses.replace(jconfigs.smoke(arch), logit_softcap=5.0)
    tcfg = dataclasses.replace(tconfigs.smoke(arch), logit_softcap=5.0)
    rng = np.random.default_rng(8)
    v, d = jcfg.padded_vocab(), jcfg.d_model
    jp, tp = {}, {}
    jp["tok"], tp["tok"] = _both(rng.standard_normal((v, d)) * 0.5)
    if not jcfg.tie_embeddings:
        jp["unembed"], tp["unembed"] = _both(rng.standard_normal((d, v)) * 0.5)
    toks = rng.integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    xj = jcm.embed(jp, jnp.asarray(toks), jcfg, RULES)
    xt = tcm.embed(tp, torch.from_numpy(toks), tcfg)
    assert xt.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(xt), _np(xj))  # a gather and one bf16 multiply
    lj, lt = jcm.logits(jp, xj, jcfg, RULES), tcm.logits(tp, xt, tcfg)
    assert lt.shape[-1] == v
    _close(lt, lj, 2e-2, rel=True)  # a bf16 product with bf16 output


def test_lm_loss_masks_padded_vocab():
    rng = np.random.default_rng(9)
    lg = rng.standard_normal((2, 5, 2048)).astype(np.float32)
    labels = rng.integers(0, 131, (2, 5)).astype(np.int32)
    got = tcm.lm_loss(torch.from_numpy(lg), torch.from_numpy(labels), 131)
    want = jcm.lm_loss(jnp.asarray(lg), jnp.asarray(labels), 131)
    _close(got, want, 1e-5, rel=True)


def test_bundle_prefill_logits_and_cache(smoke):
    jcfg, _, jb, jparams, tb, tparams = smoke
    toks = np.random.default_rng(10).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jc = jax.jit(jb.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = tb.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 1, jcfg.padded_vocab())
    # 2 layers of bf16 activations: a few bf16 ulps relative to max |value|
    _close(tl, jl, 3e-2, rel=True)
    _close(tc["k"], jc["k"], 3e-2, rel=True)
    _close(tc["v"], jc["v"], 3e-2, rel=True)
    assert int(tc["len"]) == int(jc["len"]) == 16


def test_bundle_decode_steps_per_slot_lengths(smoke):
    """Teacher-forced decode with a per-slot ``len`` vector (slot 1 restarts
    three tokens back, as a refilled slot would): logits and caches track
    the reference step after step."""
    jcfg, _, jb, jparams, tb, tparams = smoke
    rng = np.random.default_rng(11)
    S, n = 16, 4
    toks = rng.integers(0, jcfg.vocab_size, (2, S + n)).astype(np.int32)
    _, jc = jax.jit(jb.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    _, tc = tb.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S])})
    lens = np.array([S, S - 3], np.int32)
    jc = {**jkv.pad_seq_caches(jc, n), "len": jnp.asarray(lens)}
    tc = {**tkv.pad_seq_caches(tc, n), "len": torch.from_numpy(lens)}
    jdec = jax.jit(jb.decode_step)
    for i in range(n):
        step = toks[:, S + i:S + i + 1]
        jl, jc = jdec(jparams, jc, {"tokens": jnp.asarray(step)})
        tl, tc = tb.decode_step(tparams, tc, {"tokens": torch.from_numpy(step)})
        _close(tl, jl, 3e-2, rel=True)
    _close(tc["k"], jc["k"], 3e-2, rel=True)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_every_arch_builds_with_the_references_param_counts(arch):
    """Every config of the reference builds in the port, full and smoke,
    with its parameter counts: all, and active (MoE's top-k of E)."""
    for get in ("get", "smoke"):
        jb = jreg.build(getattr(jconfigs, get)(arch))
        tb = treg.build(getattr(tconfigs, get)(arch))
        assert tb.n_params() == jb.n_params()
        assert tb.n_params_active() == jb.n_params_active()


@pytest.mark.parametrize("score_dtype", ["bfloat16", "float16"])
def test_a_score_dtype_other_than_float32_is_refused_where_a_model_is_built(score_dtype):
    """The port's attention scores are f32 everywhere; the reference's
    chunked attention computes them in ``score_dtype``. Until the port
    honours the field, building a model with another value raises, and the
    default builds on both sides."""
    cfg = dataclasses.replace(tconfigs.smoke("smollm-135m"), score_dtype=score_dtype)
    with pytest.raises(ValueError, match="score_dtype"):
        treg.build(cfg)
    assert tconfigs.smoke("smollm-135m").score_dtype == "float32"
    assert jconfigs.smoke("smollm-135m").score_dtype == "float32"
    treg.build(tconfigs.smoke("smollm-135m"))
    jreg.build(jconfigs.smoke("smollm-135m"))
