"""The port's mamba2 family (``repro_torch/models/mamba2.py``) against the
JAX package's (``repro/models/mamba2.py``), on the CPU.

Covered: ``ssd_chunked`` (the padded last chunk and a carried-in state
``h0``, f32 and bf16 inputs), the causal conv with and without its decode
tail, the bundle's loss and every gradient, prefill logits and caches,
decode with per-slot lengths, the parameter count, ``remat="full"``, the
GSPMD step in every one-card placement against the reference's
``InfinityExecutor(engine="pjit")``, a checkpoint as the reference's
files, the serve and train CLIs, and the explicit engine's refusal.
Machinery shared with ``tests/test_torch_hybrid.py`` lives in
``tests/recurrent_parity.py``.

Tolerances, from the arithmetic:

* ``ssd_chunked`` on f32 inputs: both sides multiply f32 operands in f32
  and differ in summation order and in the order of the chunk
  contractions: 1e-5 relative to the largest element. On bf16 inputs the
  decays are rounded to bf16 on both sides at the same places
  (``L``, the state decays, the carried states); the products then
  accumulate in f32 in another association (XLA contracts the operands
  pairwise in its own order): 2e-3, a quarter of a bf16 ulp (2^-8).
* the conv: the same four products summed in the same order: 1e-6.
* the bundle's loss, logits, caches and gradients: bf16 activations
  rounded at other places in XLA and torch, one bf16 ulp (2^-8 relative)
  per rounding compounded over a block: 2e-2 relative to the largest
  element (the dense bundle's bound in ``tests/test_torch_models.py``),
  3e-2 for gradients and decode logits; the loss itself 2e-3.
* the GSPMD step: ``tests/test_torch_gspmd.py``'s bounds (loss and grad
  norm 2e-3, params to AdamW's drift bound, moments 2^-5 in norm).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import recurrent_parity as rp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import kvcache as jkv  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import RunConfig, make_offload, make_parallel  # noqa: E402
from repro_torch.core import kvcache as tkv  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core.zero import ExplicitZero3Engine  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

ARCH = "mamba2-370m"
SSD_F32 = 1e-5
SSD_BF16 = 2e-3
CONV = 1e-6
LOSS_REL = 2e-3
ACT_REL = 2e-2
GRAD_REL = 3e-2


def _ssd_inputs(seed, S, dtype, H=2, P=8, N=4):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((2, S, H, P)) * 0.5,
            -np.abs(rng.standard_normal((2, S, H))) * 0.3,
            rng.standard_normal((2, S, N)) * 0.5,
            rng.standard_normal((2, S, N)) * 0.5,
            rng.standard_normal((2, H, P, N)) * 0.5]
    arrs = [a.astype(np.float32) for a in arrs]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    # dA stays f32, as mamba_block computes it
    j = [jnp.asarray(a).astype(jd if i in (0, 2, 3) else jnp.float32) for i, a in enumerate(arrs)]
    t = [torch.from_numpy(a).to(td if i in (0, 2, 3) else torch.float32)
         for i, a in enumerate(arrs)]
    return j, t


@pytest.mark.parametrize("S", [16, 37, 64])  # one chunk, a padded last chunk, four chunks
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_reference(S, with_h0, dtype):
    j, t = _ssd_inputs(S, S, dtype)
    yj, hj = jm2.ssd_chunked(*j[:4], 16, h0=j[4] if with_h0 else None)
    yt, ht = tm2.ssd_chunked(*t[:4], 16, h0=t[4] if with_h0 else None)
    tol = SSD_F32 if dtype == "float32" else SSD_BF16
    assert yt.dtype == ht.dtype == torch.float32
    rp.close(yt, yj, tol, "y")
    rp.close(ht, hj, tol, "final state")


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    yj, sj = jm2._causal_conv(xj, jnp.asarray(w), jnp.asarray(st) if with_state else None)
    yt, s_t = tm2._causal_conv(xt, torch.from_numpy(w), torch.from_numpy(st) if with_state else None)
    rp.close(yt, yj, CONV, "conv")
    if with_state:
        assert s_t.dtype == torch.bfloat16
        np.testing.assert_array_equal(rp.np_(s_t), rp.np_(sj))
    else:
        assert s_t is None and sj is None


@pytest.fixture(scope="module")
def bundles():
    return rp.bundles(ARCH)


def test_defs_and_cache_defs_match_reference():
    jcfg, tcfg = rp.cfgs(ARCH)
    jdefs = jax.tree.leaves(jm2.param_defs(jcfg), is_leaf=lambda d: hasattr(d, "axes"))
    tdefs = tpt.tree_leaves(tm2.param_defs(tcfg))
    assert [(d.shape, d.axes, d.dtype, d.init) for d in tdefs] == \
        [(d.shape, d.axes, d.dtype, d.init) for d in jdefs]
    jc = jax.tree.leaves(jm2.cache_defs_fn(jcfg)(3, 64), is_leaf=lambda d: hasattr(d, "axes"))
    tc = tpt.tree_leaves(tm2.cache_defs_fn(tcfg)(3, 64))
    assert [(d.shape, d.axes, d.dtype) for d in tc] == [(d.shape, d.axes, d.dtype) for d in jc]


@pytest.mark.parametrize("Sn", [16, 37])  # whole chunks; a padded last chunk
def test_bundle_loss_and_every_gradient_match_reference(bundles, Sn):
    rp.loss_and_grads(bundles, 1, Sn, LOSS_REL, GRAD_REL)


def test_prefill_and_decode_with_per_slot_lengths_match_reference(bundles):
    """Two prompts of different lengths prefill alone and decode as one
    batch with per-slot lengths; each step's logits and the final caches
    (conv tails, states) against the reference doing the same."""
    jcfg, jb, jparams, tb, tparams = bundles
    toks = rp.tokens(jcfg, 3, Sn=40)
    lens = (21, 33)
    jcs, tcs = [], []
    for row, n in enumerate(lens):
        lj, jc = jax.jit(jb.prefill)(jparams, {"tokens": jnp.asarray(toks[row:row + 1, :n])})
        lt, tc = tb.prefill(tparams, {"tokens": torch.from_numpy(toks[row:row + 1, :n])})
        rp.close(lt, lj, ACT_REL, f"prefill logits {n}")
        for key, leaf in rp.cache_leaves(tc).items():
            rp.close(leaf, rp.cache_leaves(jc)[key], ACT_REL, f"prefill {key}")
        jcs.append(jc)
        tcs.append(tc)
    jc = {k: jnp.concatenate([c[k] for c in jcs], axis=1) for k in tm2.CACHE_KEYS}
    tc = {k: torch.cat([c[k] for c in tcs], dim=1) for k in tm2.CACHE_KEYS}
    jc["len"] = jnp.asarray(lens, jnp.int32)
    tc["len"] = torch.tensor(lens, dtype=torch.int32)
    jdec = jax.jit(jb.decode_step)
    for i in range(5):
        step = np.stack([toks[r, lens[r] + i] for r in range(2)])[:, None]
        lj, jc = jdec(jparams, jc, {"tokens": jnp.asarray(step)})
        lt, tc = tb.decode_step(tparams, tc, {"tokens": torch.from_numpy(step)})
        rp.close(lt, lj, GRAD_REL, f"decode step {i}")
    for key in tm2.CACHE_KEYS:
        rp.close(tc[key], jc[key], GRAD_REL, f"decoded {key}")
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_param_count_and_cache_bytes_match_reference():
    jb, tb = jreg.build(jconfigs.get(ARCH)), treg.build(tconfigs.get(ARCH))
    assert tb.n_params() == jb.n_params() == tb.n_params_active() == 369_169_920
    for ctx in (16, 2592):
        assert tkv.sequence_kv_bytes(tconfigs.get(ARCH), ctx) == \
            jkv.sequence_kv_bytes(jconfigs.get(ARCH), ctx)


def test_remat_dots_saves_the_projections_bit_equal_to_none():
    """No flash and no tiled matmul here: the counts are zero under every
    policy; the projections' ``mm`` outputs are saved, the SSD's einsums
    recomputed, and the gradients equal ``none``'s."""
    n = rp.remat_dots_saves_the_products(rp.cfgs(ARCH)[1], 4)
    assert all(c == {"matmul": 0, "attention": 0} for c in n.values()), n


@pytest.mark.parametrize("Sn", [16, 37])
def test_remat_dots_loss_and_every_gradient_match_reference(Sn):
    rp.loss_and_grads(rp.bundles(ARCH, remat="dots"), 1, Sn, LOSS_REL, GRAD_REL)


def test_remat_full_recomputes_to_the_same_loss_and_gradients():
    rp.remat_full_equals_none(rp.cfgs(ARCH)[1], 4)


def test_explicit_engine_refuses_the_family_in_the_reference_words():
    run = RunConfig(model=tconfigs.smoke(ARCH), parallel=make_parallel("zero3"),
                    offload=make_offload())
    with pytest.raises(NotImplementedError, match="dense and moe families only"):
        ExplicitZero3Engine(run, "cpu")


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


def test_checkpoint_is_the_reference_files_both_ways(tmp_path, mesh):
    keys = rp.checkpoint_both_ways(ARCH, None, tmp_path, mesh)
    assert "params/blocks/A_log" in keys and "opt/m/blocks/conv_x" in keys


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------


def test_serve_cli_pages_whole_states_through_the_host_tier():
    """5 sequences through 2 slots: the waiting sequences' caches park
    whole on the host tier (no token blocks) and every sequence finishes
    its budget."""
    args = tserve._parse(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "5",
                          "--kv-slots", "2", "--kv-tier", "host", "--prompt-len", "20",
                          "--new-tokens", "6"])
    out = tserve.run_serve(args, [])
    assert all(out["done"]) and all(len(g) == 6 for g in out["generated"])
    assert out["admissions"] == 3 and out["kv"]["in_bytes"] == out["kv"]["out_bytes"] > 0
    per_seq = tkv.sequence_kv_bytes(tconfigs.smoke(ARCH), 26)  # the len placeholder too
    assert out["kv"]["out_bytes"] == 3 * per_seq


def test_train_cli_plans_and_trains_with_falling_loss(tmp_path, capsys):
    hist = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--plan", "auto",
                        "--steps", "6", "--batch", "4", "--seq", "32", "--lr", "3e-3",
                        "--ckpt-every", "0", "--nvme-dir", str(tmp_path)])
    losses = hist["losses"]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert "done in" in capsys.readouterr().out


def test_train_cli_layers_cuts_depth_at_full_width():
    args = ttrain.build_argparser().parse_args(["--arch", ARCH, "--layers", "2"])
    cfg = ttrain.make_run(args, [])[0].model
    assert cfg.n_layers == 2 and cfg.d_model == tconfigs.get(ARCH).d_model
    assert dataclasses.replace(cfg, n_layers=48) == tconfigs.get(ARCH)
