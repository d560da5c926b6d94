"""The port's VLM family (``vlm`` in ``repro_torch/models/transformer.py``,
llava-next-34b) against the JAX package's (``repro/models/transformer.py``),
on the CPU, at the smoke config (2 layers, 4 query heads on 2 KV heads,
``vision_len`` 8).

Covered: the defs, cache defs and input specs; the bundle's loss (text
positions only) and every gradient; prefill logits and caches, ``len``
counting the vision positions; decode with per-slot lengths after them;
``remat="full"``; the GSPMD step in every one-card placement against the
reference's ``InfinityExecutor(engine="pjit")``; checkpoints both ways;
the float-input draw of the serve driver and of ``SyntheticStream``, bit
for bit the reference's; the explicit engine's refusal in both packages;
the serve and train CLIs.

Tolerances, from the arithmetic (those of ``tests/test_torch_hybrid.py``,
whose bf16 activations round the same way): the loss 2e-3 relative; logits
and caches 2e-2 of the largest element (bf16 activations rounded at other
places in XLA and torch, one 2^-8 ulp a rounding compounded over the
blocks); gradients and decode logits 3e-2; the GSPMD step
``tests/test_torch_gspmd.py``'s bounds. The float inputs' bits: exact.
"""
import dataclasses

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
from repro.models import registry as jreg  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import RunConfig, ShapeConfig, make_offload, make_parallel  # noqa: E402
from repro_torch.core import kvcache as tkv  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core.zero import ExplicitZero3Engine  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.transformer import TensorSpec  # noqa: E402

ARCH = "llava-next-34b"
LOSS_REL = 2e-3
ACT_REL = 2e-2
GRAD_REL = 3e-2


@pytest.fixture(scope="module")
def bundles():
    return rp.bundles(ARCH)


def _vision(cfg, seed, B=2):
    return rp.embeds(cfg, seed, (B, cfg.vision_len, cfg.d_model))


def test_defs_cache_defs_and_input_specs_match_reference():
    jcfg, tcfg = rp.cfgs(ARCH)
    jb, tb = jreg.build(jcfg), treg.build(tcfg)
    is_def = lambda d: hasattr(d, "axes")  # noqa: E731
    jdefs = jax.tree_util.tree_flatten_with_path(jb.defs, is_leaf=is_def)[0]
    assert [tuple(k.key for k in p) for p, _ in jdefs] == tpt.tree_paths(tb.defs)
    assert [(d.shape, d.axes, d.dtype, d.init) for d in tpt.tree_leaves(tb.defs)] \
        == [(d.shape, d.axes, d.dtype, d.init) for _, d in jdefs]
    jc = jax.tree.leaves(jb.cache_defs(3, 64), is_leaf=is_def)
    tc = tpt.tree_leaves(tb.cache_defs(3, 64))
    assert [(d.shape, d.axes, d.dtype) for d in tc] == [(d.shape, d.axes, d.dtype) for d in jc]
    for kind in ("train", "prefill", "decode"):
        js = jb.input_specs(JShape("s", 24, 3, kind))
        ts = tb.input_specs(ShapeConfig("s", 24, 3, kind))
        assert list(ts) == list(js)
        for k in ts:
            assert tuple(ts[k].shape) == tuple(js[k].shape), (kind, k)
            assert str(ts[k].dtype).removeprefix("torch.") == np.dtype(js[k].dtype).name
    assert tuple(tb.input_specs(ShapeConfig("s", 24, 3, "train"))["tokens"].shape) == (3, 16)
    with pytest.raises(ValueError, match="no text"):
        tb.input_specs(ShapeConfig("s", tcfg.vision_len, 3, "prefill"))


@pytest.mark.parametrize("Sn", [1, 9])  # one text token; more text than vision
def test_bundle_loss_on_text_positions_and_every_gradient_match_reference(bundles, Sn):
    jcfg = bundles[0]
    rp.loss_and_grads(bundles, 1, Sn, LOSS_REL, GRAD_REL,
                      extra={"vision_embeds": _vision(jcfg, 2)})


@pytest.mark.parametrize("Sn", [4, 12])
def test_prefill_logits_and_caches_match_reference_len_counting_vision(bundles, Sn):
    jcfg, jb, jparams, tb, tparams = bundles
    toks, vis = rp.tokens(jcfg, 5, Sn=Sn), _vision(jcfg, 6)
    lj, jc = jax.jit(jb.prefill)(jparams, {"tokens": jnp.asarray(toks),
                                           "vision_embeds": jnp.asarray(vis)})
    lt, tc = tb.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                  "vision_embeds": torch.from_numpy(vis)})
    rp.close(lt, lj, ACT_REL, "prefill logits")
    jl, tl = rp.cache_leaves(jc), rp.cache_leaves(tc)
    assert sorted(tl) == sorted(jl) == ["k", "len", "v"]
    for key in ("k", "v"):
        assert tl[key].shape == tuple(jl[key].shape) == (jcfg.n_layers, 2, jcfg.vision_len + Sn,
                                                         jcfg.n_kv_heads, jcfg.head_dim)
        rp.close(tl[key], jl[key], ACT_REL, key)
    assert int(tc["len"]) == int(jc["len"]) == jcfg.vision_len + Sn


def test_decode_after_the_vision_positions_with_per_slot_lengths_matches_reference(bundles):
    """Teacher-forced decode with a per-slot ``len`` vector (slot 1
    restarts three tokens back, as a refilled slot would)."""
    jcfg, jb, jparams, tb, tparams = bundles
    S, n = 8, 5
    toks, vis = rp.tokens(jcfg, 7, Sn=S + n), _vision(jcfg, 8)
    _, jc = jax.jit(jb.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :S]),
                                          "vision_embeds": jnp.asarray(vis)})
    _, tc = tb.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S]),
                                 "vision_embeds": torch.from_numpy(vis)})
    P = jcfg.vision_len + S
    lens = np.array([P, P - 3], np.int32)
    jc = {**jkv.pad_seq_caches(jc, n), "len": jnp.asarray(lens)}
    tc = {**tkv.pad_seq_caches(tc, n), "len": torch.from_numpy(lens)}
    jdec = jax.jit(jb.decode_step)
    for i in range(n):
        step = toks[:, S + i:S + i + 1]
        lj, jc = jdec(jparams, jc, {"tokens": jnp.asarray(step)})
        lt, tc = tb.decode_step(tparams, tc, {"tokens": torch.from_numpy(step)})
        rp.close(lt, lj, GRAD_REL, f"decode step {i}")
    for key in ("k", "v"):
        rp.close(tc[key], jc[key], GRAD_REL, f"decoded {key}")
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_remat_dots_saves_the_products_bit_equal_to_none():
    tcfg = rp.cfgs(ARCH)[1]
    rp.remat_dots_saves_the_products(tcfg, 4, extra={"vision_embeds": _vision(tcfg, 9)}, Sn=6)


def test_remat_dots_loss_on_text_positions_and_every_gradient_match_reference():
    jcfg = rp.cfgs(ARCH)[0]
    rp.loss_and_grads(rp.bundles(ARCH, remat="dots"), 1, 9, LOSS_REL, GRAD_REL,
                      extra={"vision_embeds": _vision(jcfg, 2)})


def test_remat_full_recomputes_to_the_same_loss_and_gradients():
    tcfg = rp.cfgs(ARCH)[1]
    rp.remat_full_equals_none(tcfg, 4, extra={"vision_embeds": _vision(tcfg, 9)}, Sn=6)


def test_explicit_engine_refuses_the_family_in_both_packages():
    run = RunConfig(model=tconfigs.smoke(ARCH), parallel=make_parallel("zero3"),
                    offload=make_offload())
    with pytest.raises(NotImplementedError, match="dense and moe families only"):
        ExplicitZero3Engine(run, "cpu")
    jrun = JRun(model=jconfigs.smoke(ARCH), parallel=jmake_parallel("zero3"),
                offload=jmake_offload())
    with pytest.raises(AssertionError, match="dense and moe families only"):
        jzero.ExplicitZero3Engine(jrun, make_local_mesh(1, 1))


# ---------------------------------------------------------------------------
# the float inputs: the same bits as the reference's draws
# ---------------------------------------------------------------------------


def _bf16_bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def test_the_serve_draw_gives_the_references_bits_on_2m_vision_draws():
    """The serve driver's f64 -> f32 -> bf16 cast against the reference
    driver's f64 -> bf16, on 2,007,040 unit-normal * 0.1 draws (280
    vision positions of llava's d_model 7168) and the token ids drawn
    before them."""
    specs = {"tokens": TensorSpec((1, 192), torch.int32),
             "vision_embeds": TensorSpec((1, 280, 7168), torch.bfloat16)}
    got = tserve.draw_inputs(specs, 1, 64000, seed=3)
    rng = np.random.default_rng(3)  # the reference driver's loop
    want_toks = rng.integers(0, 64000, (1, 192), dtype=np.int32)
    want_vis = (rng.standard_normal((1, 280, 7168)) * 0.1).astype(jnp.bfloat16)
    np.testing.assert_array_equal(got["tokens"].numpy(), want_toks)
    np.testing.assert_array_equal(_bf16_bits(got["vision_embeds"]), _bf16_bits(want_vis))


def test_synthetic_stream_gives_the_references_vision_bits():
    tcfg = rp.cfgs(ARCH)[1]
    tspecs = treg.build(tcfg).input_specs(ShapeConfig("t", 24, 4, "train"))
    jspecs = jreg.build(jconfigs.smoke(ARCH)).input_specs(JShape("t", 24, 4, "train"))
    for step in (0, 5):
        got = tpipe.SyntheticStream(tspecs, tcfg.vocab_size, seed=1).batch_at(step)
        want = jpipe.SyntheticStream(jspecs, tcfg.vocab_size, seed=1).batch_at(step)
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        vis = torch.from_numpy(got["vision_embeds"]).to(tspecs["vision_embeds"].dtype)
        np.testing.assert_array_equal(_bf16_bits(vis), _bf16_bits(want["vision_embeds"]))


# ---------------------------------------------------------------------------
# the GSPMD step, every one-card placement; checkpoints
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


def test_checkpoint_is_the_reference_files_both_ways(tmp_path, mesh):
    keys = rp.checkpoint_both_ways(ARCH, None, tmp_path, mesh)
    assert "params/embed/unembed" in keys and "opt/m/blocks/attn/wq" in keys


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------


def test_serve_cli_pages_caches_with_their_vision_positions():
    """5 sequences through 2 slots on the host tier; each parked cache
    holds its prompt's vision and text positions in blocks."""
    P, N = 20, 6
    args = tserve._parse(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "5",
                          "--kv-slots", "2", "--kv-tier", "host", "--prompt-len", str(P),
                          "--new-tokens", str(N), "--kv-block-tokens", "8"])
    out = tserve.run_serve(args, [])
    assert all(out["done"]) and all(len(g) == N for g in out["generated"])
    tcfg = rp.cfgs(ARCH)[1]
    per_seq = tkv.sequence_kv_bytes(tcfg, P)  # the blocks up to the prompt, with len
    assert out["admissions"] == 3 and out["kv"]["out_bytes"] == 3 * per_seq


def test_train_cli_plans_and_trains_with_falling_loss(tmp_path, capsys):
    hist = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--plan", "auto",
                        "--steps", "6", "--batch", "2", "--seq", "40", "--lr", "3e-3",
                        "--ckpt-every", "0", "--nvme-dir", str(tmp_path)])
    losses = hist["losses"]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert "done in" in capsys.readouterr().out


def test_layers_cuts_the_vlm_at_full_width():
    cfg = tconfigs.with_layers(tconfigs.get(ARCH), 8)
    assert cfg == dataclasses.replace(tconfigs.get(ARCH), n_layers=8)
    assert tconfigs.with_layers(cfg, 0) is cfg
