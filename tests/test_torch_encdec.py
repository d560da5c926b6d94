"""The port's encoder-decoder family (``repro_torch/models/encdec.py``,
seamless-m4t-medium) against the JAX package's (``repro/models/encdec.py``),
on the CPU, at the smoke config (2 encoder + 2 decoder layers, 4 heads of
16, layernorm, gelu, tied embeddings).

Covered: ``attention_block(kv_source=...)`` (cross-attention: no RoPE,
never causal, Sq != Sk) against the reference's, with a case where RoPE
would change the answer; the defs, cache defs (``xk``/``xv`` sized at
``cache_len // 4``, as the reference's) and input specs; the bundle's loss
and every gradient; prefill logits and every cache leaf, ``xk``/``xv``
included; decode over several steps with per-slot lengths; ``grow_cache``
and paging leaving ``xk``/``xv`` whole; ``remat="full"``; the GSPMD step
in every one-card placement against the reference's
``InfinityExecutor(engine="pjit")``; checkpoints both ways; the frames of
``SyntheticStream``, bit for bit the reference's; ``--layers`` refused;
the explicit engine's refusal in both packages; the serve and train CLIs.

Tolerances, from the arithmetic (those of ``tests/test_torch_hybrid.py``,
whose bf16 activations round the same way): the loss 2e-3 relative;
attention outputs, logits and caches 2e-2 of the largest element (bf16
activations rounded at other places in XLA and torch, one 2^-8 ulp a
rounding compounded over the blocks); gradients and decode logits 3e-2;
the GSPMD step ``tests/test_torch_gspmd.py``'s bounds. Bits: exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import recurrent_parity as rp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.config import RunConfig as JRun  # noqa: E402
from repro.config import ShapeConfig as JShape  # noqa: E402
from repro.config import make_offload as jmake_offload  # noqa: E402
from repro.config import make_parallel as jmake_parallel  # noqa: E402
from repro.core import kvcache as jkv  # noqa: E402
from repro.core import zero as jzero  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import RunConfig, ShapeConfig, make_offload, make_parallel  # noqa: E402
from repro_torch.core import kvcache as tkv  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core.offload import HostArrayStore  # noqa: E402
from repro_torch.core.zero import ExplicitZero3Engine  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

ARCH = "seamless-m4t-medium"
LOSS_REL = 2e-3
ACT_REL = 2e-2
GRAD_REL = 3e-2


@pytest.fixture(scope="module")
def bundles():
    return rp.bundles(ARCH)


def _frames(cfg, seed, S, B=2):
    return rp.embeds(cfg, seed, (B, S, cfg.d_model))


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------


def _attn_inputs(cfg, Sq, Sk, seed):
    rng = np.random.default_rng(seed)
    d, H, KV, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w = {"wq": (d, H, D), "wk": (d, KV, D), "wv": (d, KV, D), "wo": (H, D, d)}
    p = {k: (rng.standard_normal(s) * d ** -0.5).astype(np.float32) for k, s in w.items()}
    x = rng.standard_normal((2, Sq, d)).astype(np.float32)
    mem = rng.standard_normal((2, Sk, d)).astype(np.float32)
    return p, x, mem


def _both_blocks(cfg, p, x, mem, positions, causal):
    jout, _ = jcm.attention_block(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}, jnp.asarray(x, jnp.bfloat16),
        jnp.asarray(positions), jconfigs.smoke(ARCH), jreg.NULL_RULES, causal=causal,
        kv_source=jnp.asarray(mem, jnp.bfloat16))
    tout, _ = tcm.attention_block(
        {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()},
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(positions), cfg,
        causal=causal, kv_source=torch.from_numpy(mem).to(torch.bfloat16))
    return tout, jout


@pytest.mark.parametrize("Sq,Sk", [(5, 19), (8, 32), (12, 12)])
@pytest.mark.parametrize("causal", [True, False])
def test_cross_attention_block_matches_reference_never_causal_at_any_positions(Sq, Sk, causal):
    """K and V from the memory, not causal whatever ``causal`` says, and
    no RoPE: the output does not move with the query positions."""
    cfg = tconfigs.smoke(ARCH)
    p, x, mem = _attn_inputs(cfg, Sq, Sk, Sq * 100 + Sk)
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32) + 7, (2, Sq)).copy()
    tout, jout = _both_blocks(cfg, p, x, mem, pos, causal)
    assert tout.shape == (2, Sq, cfg.d_model)
    rp.close(tout, jout, ACT_REL, "cross-attention")
    noncausal, _ = _both_blocks(cfg, p, x, mem, pos * 0, False)
    assert torch.equal(tout, noncausal)


def test_rope_would_change_the_cross_attention_answer():
    """With the memory as the query input too, cross-attention (no RoPE)
    and the encoder's non-causal self-attention (RoPE) differ by far more
    than the tolerance: the parity above would see a rotated q or k."""
    cfg = tconfigs.smoke(ARCH)
    p, _, mem = _attn_inputs(cfg, 12, 12, 3)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    cross, jcross = _both_blocks(cfg, p, mem, mem, pos, False)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    m = torch.from_numpy(mem).to(torch.bfloat16)
    rotated, _ = tcm.attention_block(tp, m, torch.from_numpy(pos), cfg, causal=False)
    rp.close(cross, jcross, ACT_REL, "cross-attention")
    assert rp.rel_err(rotated, jcross) > 10 * ACT_REL


# ---------------------------------------------------------------------------
# the bundle
# ---------------------------------------------------------------------------


def test_defs_cache_defs_and_input_specs_match_reference():
    jcfg, tcfg = rp.cfgs(ARCH)
    jb, tb = jreg.build(jcfg), treg.build(tcfg)
    is_def = lambda d: hasattr(d, "axes")  # noqa: E731
    jdefs = jax.tree_util.tree_flatten_with_path(jb.defs, is_leaf=is_def)[0]
    assert [tuple(k.key for k in p) for p, _ in jdefs] == tpt.tree_paths(tb.defs)
    assert [(d.shape, d.axes, d.dtype, d.init) for d in tpt.tree_leaves(tb.defs)] \
        == [(d.shape, d.axes, d.dtype, d.init) for _, d in jdefs]
    for cache_len in (1, 64, 66):
        jc = jax.tree.leaves(jb.cache_defs(3, cache_len), is_leaf=is_def)
        tc = tb.cache_defs(3, cache_len)
        assert [(d.shape, d.axes, d.dtype) for d in tpt.tree_leaves(tc)] \
            == [(d.shape, d.axes, d.dtype) for d in jc]
        assert tc["xk"].shape[2] == max(cache_len // 4, 1)  # the reference's sizing
    for kind in ("train", "prefill", "decode"):
        js = jb.input_specs(JShape("s", 24, 3, kind))
        ts = tb.input_specs(ShapeConfig("s", 24, 3, kind))
        assert list(ts) == list(js)
        for k in ts:
            assert tuple(ts[k].shape) == tuple(js[k].shape), (kind, k)
            assert str(ts[k].dtype).removeprefix("torch.") == np.dtype(js[k].dtype).name


@pytest.mark.parametrize("S_enc,S_dec", [(16, 4), (37, 9)])
def test_bundle_loss_and_every_gradient_match_reference(bundles, S_enc, S_dec):
    jcfg = bundles[0]
    rp.loss_and_grads(bundles, 1, S_dec, LOSS_REL, GRAD_REL,
                      extra={"frames": _frames(jcfg, 2, S_enc)})


@pytest.mark.parametrize("S_enc,S_dec", [(16, 4), (33, 8)])
def test_prefill_logits_and_every_cache_leaf_match_reference(bundles, S_enc, S_dec):
    jcfg, jb, jparams, tb, tparams = bundles
    toks, frames = rp.tokens(jcfg, 5, Sn=S_dec), _frames(jcfg, 6, S_enc)
    lj, jc = jax.jit(jb.prefill)(jparams, {"tokens": jnp.asarray(toks),
                                           "frames": jnp.asarray(frames)})
    lt, tc = tb.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                  "frames": torch.from_numpy(frames)})
    rp.close(lt, lj, ACT_REL, "prefill logits")
    jl, tl = rp.cache_leaves(jc), rp.cache_leaves(tc)
    assert sorted(tl) == sorted(jl) == ["k", "len", "v", "xk", "xv"]
    L, KV, D = jcfg.n_dec_layers, jcfg.n_kv_heads, jcfg.head_dim
    for key, S in (("k", S_dec), ("v", S_dec), ("xk", S_enc), ("xv", S_enc)):
        assert tl[key].shape == tuple(jl[key].shape) == (L, 2, S, KV, D), key
        assert tl[key].dtype == torch.bfloat16
        rp.close(tl[key], jl[key], ACT_REL, key)
    assert int(tc["len"]) == int(jc["len"]) == S_dec


def test_decode_over_several_steps_with_per_slot_lengths_matches_reference(bundles):
    """Teacher-forced decode with a per-slot ``len`` vector (slot 1
    restarts three tokens back), the self-attention caches grown by the
    steps and the cross keys left as prefill made them."""
    jcfg, jb, jparams, tb, tparams = bundles
    S, n, S_enc = 8, 5, 32
    toks, frames = rp.tokens(jcfg, 7, Sn=S + n), _frames(jcfg, 8, S_enc)
    _, jc = jax.jit(jb.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :S]),
                                          "frames": jnp.asarray(frames)})
    _, tc = tb.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S]),
                                 "frames": torch.from_numpy(frames)})
    lens = np.array([S, S - 3], np.int32)
    jc = {**jkv.grow_cache(jc, n, "encdec"), "len": jnp.asarray(lens)}
    tc = {**tkv.grow_cache(tc, n, "encdec"), "len": torch.from_numpy(lens)}
    xk = tc["xk"].clone()
    jdec = jax.jit(jb.decode_step)
    for i in range(n):
        step = toks[:, S + i:S + i + 1]
        lj, jc = jdec(jparams, jc, {"tokens": jnp.asarray(step)})
        lt, tc = tb.decode_step(tparams, tc, {"tokens": torch.from_numpy(step)})
        rp.close(lt, lj, GRAD_REL, f"decode step {i}")
    for key in ("k", "v", "xk", "xv"):
        rp.close(tc[key], jc[key], GRAD_REL, f"decoded {key}")
    assert torch.equal(tc["xk"], xk)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_grow_cache_pads_k_and_v_and_leaves_the_cross_keys_whole(bundles):
    jcfg, jb, jparams, tb, tparams = bundles
    toks, frames = rp.tokens(jcfg, 9, Sn=6), _frames(jcfg, 10, 24)
    _, jc = jax.jit(jb.prefill)(jparams, {"tokens": jnp.asarray(toks),
                                          "frames": jnp.asarray(frames)})
    _, tc = tb.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                 "frames": torch.from_numpy(frames)})
    jg, tg = jkv.grow_cache(jc, 7, "encdec"), tkv.grow_cache(tc, 7, "encdec")
    for key in ("k", "v", "xk", "xv"):
        assert tg[key].shape == tuple(jg[key].shape), key
    assert tg["k"].shape[2] == 13 and not tg["k"][:, :, 6:].any()
    assert tg["xk"] is tc["xk"] and tg["xv"] is tc["xv"]
    assert tg["xk"].shape[2] == 24


def test_paging_parks_the_cross_keys_whole_and_the_decoder_keys_in_blocks(bundles):
    jcfg, _, _, tb, tparams = bundles
    toks, frames = rp.tokens(jcfg, 11, Sn=8), _frames(jcfg, 12, 32)
    _, cache = tb.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                    "frames": torch.from_numpy(frames)})
    store = HostArrayStore()
    kv = tkv.PagedKVCache(store, block_tokens=4, seq_axis_names=("k", "v"))
    one = tkv.slice_sequence(cache, 1)
    n = kv.park("s", one, 8)
    assert n == tkv.device_kv_bytes(one)  # the len placeholder too
    assert n != tkv.sequence_kv_bytes(rp.cfgs(ARCH)[1], 8)  # xk/xv at the encoder's 32
    got, length = kv.fetch("s", 13)
    assert length == 8
    assert got["k"].shape[2] == 13 and torch.equal(got["k"][:, :, :8], one["k"])
    for key in ("xk", "xv"):
        assert torch.equal(got[key], one[key]), key
    store.close()


def test_remat_full_recomputes_to_the_same_loss_and_gradients():
    tcfg = rp.cfgs(ARCH)[1]
    rp.remat_full_equals_none(tcfg, 4, extra={"frames": _frames(tcfg, 13, 20)}, Sn=5)


def test_remat_dots_saves_the_products_bit_equal_to_none():
    """Encoder, decoder and cross-attention: the MLP products saved (the
    plain matmul's calls as under ``none``), every attention forward
    recomputed (as under ``full``), gradients equal ``none``'s."""
    tcfg = rp.cfgs(ARCH)[1]
    rp.remat_dots_saves_the_products(tcfg, 4, extra={"frames": _frames(tcfg, 13, 20)}, Sn=5)


def test_remat_dots_loss_and_every_gradient_match_reference():
    jcfg = rp.cfgs(ARCH)[0]
    rp.loss_and_grads(rp.bundles(ARCH, remat="dots"), 1, 4, LOSS_REL, GRAD_REL,
                      extra={"frames": _frames(jcfg, 2, 16)})


def test_explicit_engine_refuses_the_family_in_both_packages():
    run = RunConfig(model=tconfigs.smoke(ARCH), parallel=make_parallel("zero3"),
                    offload=make_offload())
    with pytest.raises(NotImplementedError, match="dense and moe families only"):
        ExplicitZero3Engine(run, "cpu")
    jrun = JRun(model=jconfigs.smoke(ARCH), parallel=jmake_parallel("zero3"),
                offload=jmake_offload())
    with pytest.raises(AssertionError, match="dense and moe families only"):
        jzero.ExplicitZero3Engine(jrun, make_local_mesh(1, 1))


def test_synthetic_stream_gives_the_references_frame_bits():
    tcfg = rp.cfgs(ARCH)[1]
    tspecs = treg.build(tcfg).input_specs(ShapeConfig("t", 24, 4, "train"))
    jspecs = jreg.build(jconfigs.smoke(ARCH)).input_specs(JShape("t", 24, 4, "train"))
    for step in (0, 5):
        got = tpipe.SyntheticStream(tspecs, tcfg.vocab_size, seed=1).batch_at(step)
        want = jpipe.SyntheticStream(jspecs, tcfg.vocab_size, seed=1).batch_at(step)
        assert sorted(got) == sorted(want)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[key], want[key])
        frames = torch.from_numpy(got["frames"]).to(tspecs["frames"].dtype)
        np.testing.assert_array_equal(frames.view(torch.int16).numpy(),
                                      np.asarray(want["frames"]).view(np.int16))


# ---------------------------------------------------------------------------
# the GSPMD step, every one-card placement; checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh(1, 1)


@pytest.fixture(scope="module")
def reference(mesh):
    # 64 frames: the decoder's 16 tokens are the other families' rp.S, the
    # length over which MOMENT_REL's five-ulp measurement was taken (Adam's
    # moments average the roundings of that many positions)
    return rp.reference_run(ARCH, mesh, seq=4 * rp.S)


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


def test_checkpoint_of_both_stacks_is_the_reference_files_both_ways(tmp_path, mesh):
    keys = rp.checkpoint_both_ways(ARCH, None, tmp_path, mesh)
    assert "params/enc/attn/wq" in keys and "params/dec/cross_attn/wk" in keys
    assert "opt/v/ln_enc/bias" in keys


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------


def test_serve_cli_parks_decoder_blocks_and_whole_cross_keys():
    """5 sequences through 2 slots on the host tier, 32 frames (8 decoder
    tokens) each: a parked cache is its decoder K/V up to the prompt and
    its cross K/V at the encoder's 32 positions, not the ``cache_len //
    4`` of ``cache_defs``."""
    P, N = 32, 6
    args = tserve._parse(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "5",
                          "--kv-slots", "2", "--kv-tier", "host", "--prompt-len", str(P),
                          "--new-tokens", str(N), "--kv-block-tokens", "4"])
    out = tserve.run_serve(args, [])
    assert all(out["done"]) and all(len(g) == N for g in out["generated"])
    cfg = rp.cfgs(ARCH)[1]
    row = cfg.n_dec_layers * cfg.n_kv_heads * cfg.head_dim * 2  # bf16 bytes a position
    per_seq = 2 * row * (P // 4) + 2 * row * P + 4  # k/v, xk/xv, the len placeholder
    assert out["admissions"] == 3 and out["kv"]["out_bytes"] == 3 * per_seq
    assert out["kv"]["resident_bytes"] == 2 * (2 * row * (P // 4 + N) + 2 * row * P) + 2 * 4


@pytest.mark.parametrize("cli", ["serve", "train"])
def test_layers_is_refused_on_the_encoder_decoder(cli):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--layers", "2"]
    with pytest.raises(ValueError, match="--layers 2: .*encoder-decoder"):
        if cli == "serve":
            tserve.run_serve(tserve._parse(argv), [])
        else:
            ttrain.train(ttrain.build_argparser().parse_args(argv + ["--steps", "1"]))


def test_train_cli_plans_and_trains_with_falling_loss(tmp_path, capsys):
    hist = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--plan", "auto",
                        "--steps", "6", "--batch", "2", "--seq", "48", "--lr", "3e-3",
                        "--ckpt-every", "0", "--nvme-dir", str(tmp_path)])
    losses = hist["losses"]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert "done in" in capsys.readouterr().out
