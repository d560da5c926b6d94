"""The port's GSPMD engine at one device against the JAX package's
``InfinityExecutor(engine="pjit")`` on a 1x1 mesh, on the CPU (where the
port's kernels run their plain versions).

Each placement a dense model on one card can be planned into runs in both
packages for ``STEPS`` steps from the same weights (the reference engine's
``init_state``, carried over by ``repro_torch.bridge``) and the same
batches (each package's ``SyntheticStream``, bit-identical): all on the
device (in-graph fused Adam), the optimizer on the host tier in-graph, the
optimizer on NVMe off-graph (``ChunkedAdamOffload``), the gradients
drained to NVMe, the params on the host tier, two microbatches,
``remat="full"`` and ``"dots"``, and the params on NVMe through the leaf
scheduler: with the optimizer in-graph on the device, with every state
class on NVMe, and so again with q8 rows. On the CPU the host tier is the
device in both packages (the reference's CPU backend has no pinned-host
memory kind); the pinned tier itself is held on the card
(``tests/test_torch_cuda.py``). Model: the smoke smollm cut to 2 layers.

Tolerances, each reasoned from the arithmetic:

* loss and grad norm per step: the reference's cross-tier tolerance
  (``tests/test_executor.py`` TIER_TOL, rtol = atol = 2e-3). The
  gradients are bf16 in both packages (the params' dtype), and the two
  frameworks round bf16 activations and gradient sums at different places:
  one bf16 ulp (2^-8 relative) per element, averaged down in a mean loss
  and in a norm over every element.
* params after the last step: AdamW's normalized update is bounded
  whatever the gradient, so two runs that start equal drift apart by at
  most ``adam.parity_bound`` (~2 * sum(lr): a tiny gradient may flip sign
  between the packages), plus each side's bf16 rounding of its master
  (half an ulp, <= 2^-8 of the value); in the bulk the bf16 gradients'
  rounding (2^-8) moves Adam's ratio by a few 2^-8 of lr a step: mean
  |diff| <= 2^-5 * sum(lr). These are the layered epoch's bounds
  (``tests/test_torch_training.py``).
* params on NVMe under q8: each package re-encodes its own updated leaves,
  so a value may land one quant step (its 32-element block's absmax/127)
  from the other's, twice over for the two encodes; the mean bound holds
  as it is. Both packages start from the same unquantized weights.
* f32 masters where the optimizer is in-graph: the drift bound alone
  (no rounding to bf16 on either side).
* Adam moments where on the device: each is a decaying sum of the
  gradients, so they differ as the gradients do. A bf16 gradient carries
  the roundings of the whole backward chain (each op's bf16 output, one
  ulp of 2^-8 each, rounded at other places in the two frameworks);
  measured on the CPU the moments differ by 0.018-0.019 in relative norm,
  about five ulps, in every in-graph placement. The bound 2^-5 (eight
  ulps) sits above that and far below what a fault opens (a skipped
  moment update, or a gradient not divided by the microbatch count, moves
  them by tens of percent).

Measured on the CPU, as fractions of these bounds: loss and grad norm
0.11-0.35, params 0.28-0.29 (mean 0.23-0.26), masters 0.29.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import recurrent_parity as rp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.config import RunConfig as JRun  # noqa: E402
from repro.config import TrainConfig as JTrain  # noqa: E402
from repro.config import make_offload as jmake_offload  # noqa: E402
from repro.config import make_parallel as jmake_parallel  # noqa: E402
from repro.core import executor as jexec  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.config import RunConfig, ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.config import make_offload, make_parallel  # noqa: E402
from repro_torch.core import executor as texec  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core.engine import ZeroInfinityEngine  # noqa: E402
from repro_torch.core.zero import ExplicitZero3Engine  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402

TIER_TOL = dict(rtol=2e-3, atol=2e-3)
MOMENT_REL = 2**-5
STEPS = 3
B, S = 4, 16

# placement -> (param tier, grad tier, opt tier, grad_accum, remat)
PLACEMENTS = {
    "all_device": ("device", "device", "device", 1, "none"),
    "opt_host": ("device", "device", "host", 1, "none"),
    "opt_nvme": ("device", "device", "nvme", 1, "none"),
    "grad_nvme": ("device", "nvme", "host", 1, "none"),
    "param_host": ("host", "device", "device", 1, "none"),
    "grad_accum_2": ("device", "device", "device", 2, "none"),
    "remat_full": ("device", "device", "device", 1, "full"),
    "remat_dots": ("device", "device", "device", 1, "dots"),
    "param_nvme": ("nvme", "device", "device", 1, "none"),
    "all_nvme": ("nvme", "nvme", "nvme", 1, "none"),
    "all_nvme_q8": ("nvme", "nvme", "nvme", 1, "none"),
}
QUANT = {"all_nvme_q8": "q8"}
OFFGRAPH = ("opt_nvme", "grad_nvme", "all_nvme", "all_nvme_q8")
# the params on NVMe, loaded and written back by the leaf scheduler
STREAMED = ("param_nvme", "all_nvme", "all_nvme_q8")
# the 2-layer smoke smollm's leaves (every param read and written once a
# step) and the leaf scheduler's peak residency (the reference's counters)
PARAM_TOTAL_BYTES = 295_872
PEAK_RESIDENT_PARAM_BYTES = 221_184


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _runs(nvme_dir, placement):
    param, grad, opt, accum, remat = PLACEMENTS[placement]
    jcfg = dataclasses.replace(jconfigs.smoke("smollm-135m"), n_layers=2)
    tcfg = dataclasses.replace(tconfigs.smoke("smollm-135m"), n_layers=2)
    off = dict(param_tier=param, grad_tier=grad, opt_tier=opt,
               param_quant=QUANT.get(placement, "none"))
    jrun = JRun(model=jcfg, parallel=jmake_parallel("pjit", remat=remat, grad_accum=accum),
                offload=jmake_offload(nvme_dir=f"{nvme_dir}/jax", **off),
                train=JTrain(lr=3e-3, warmup_steps=2))
    trun = RunConfig(model=tcfg, parallel=make_parallel("pjit", remat=remat, grad_accum=accum),
                     offload=make_offload(nvme_dir=f"{nvme_dir}/torch", **off),
                     train=TrainConfig(lr=3e-3, warmup_steps=2))
    return jrun, trun


@pytest.fixture(scope="module")
def mesh():
    return make_local_mesh(1, 1)


@pytest.fixture(scope="module", params=list(PLACEMENTS))
def placed(request, tmp_path_factory, mesh):
    """Both executors, ``STEPS`` steps of one placement from the same
    weights and batches."""
    jrun, trun = _runs(tmp_path_factory.mktemp(request.param), request.param)
    jex = jexec.InfinityExecutor(jrun, mesh)
    # the unquantized weights: seeding drops NVMe-resident params
    jstate = jex.init_state(jax.random.PRNGKey(0), seed_stores=False)
    init = jax.tree.map(np.asarray, jstate["params"])
    jstate = jex.reseed(jstate)
    tex = texec.InfinityExecutor(trun, "cpu")
    tstate = tex.reseed(tex.engine.adopt_params(bridge.params_from_numpy(init)))
    stream = tpipe.SyntheticStream(tex.input_specs(ShapeConfig("t", S, B, "train")),
                                   trun.model.vocab_size, seed=0)
    jstep, tstep = jex.make_train_step(), tex.make_train_step()
    jm, tm = [], []
    for i in range(STEPS):
        batch = stream.batch_at(i)
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jm.append(m)
        tstate, m = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        tm.append(m)
    # NVMe-resident params materialized from each package's store
    jparams = jex.checkpoint_state(jstate)["params"]
    tparams = tex.checkpoint_state(tstate)["params"]
    yield types.SimpleNamespace(name=request.param, jex=jex, tex=tex, jstate=jstate,
                                tstate=tstate, jm=jm, tm=tm, trun=trun,
                                jparams=jparams, tparams=tparams,
                                grad_tier_slow=PLACEMENTS[request.param][1] == "nvme")
    tex.close()
    jex.close()


@pytest.mark.parametrize("step", range(STEPS))
def test_step_matches_reference_loss_grad_norm_and_lr(placed, step):
    jm, tm = placed.jm[step], placed.tm[step]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **TIER_TOL,
                                   err_msg=f"{placed.name} {key}")


def _quant_steps(want: np.ndarray) -> np.ndarray:
    """Each element's q8 quant step: its 32-element block's absmax/127
    over the flattened leaf."""
    flat = want.reshape(-1)
    blocks = np.pad(flat, (0, (-flat.size) % 32)).reshape(-1, 32)
    step = np.repeat(np.abs(blocks).max(-1) / 127.0, 32)[:flat.size]
    return step.reshape(want.shape)


def test_params_after_last_step_match_reference(placed):
    lrs = [float(m["lr"]) for m in placed.jm]
    drift = tadam.parity_bound(placed.trun.train, lrs)
    tparams = placed.tparams
    for path in tpt.tree_paths(tparams):
        got, jleaf = tpt.tree_get(tparams, path), tpt.tree_get(placed.jparams, path)
        want = _np(jleaf)
        assert str(got.dtype) == f"torch.{jleaf.dtype}" and got.shape == want.shape
        diff = np.abs(_np(got) - want)
        allowed = drift + 2**-8 * (np.abs(want) + np.abs(_np(got)))
        if placed.name in QUANT:
            allowed = allowed + 2 * _quant_steps(want)
        assert (diff <= allowed).all(), (placed.name, path, diff.max())
        assert diff.mean() <= 2**-5 * sum(lrs), (placed.name, path, diff.mean())


def test_in_graph_optimizer_states_match_reference(placed):
    """Masters to the drift bound; m and v to ``MOMENT_REL`` in norm; the
    step count exact. Off-graph placements carry no optimizer state."""
    if placed.name in OFFGRAPH:
        assert "opt" not in placed.tstate and "opt" not in placed.jstate
        return
    jo, to = placed.jstate["opt"], placed.tstate["opt"]
    assert int(to.step) == int(jo.step) == STEPS
    drift = tadam.parity_bound(placed.trun.train, [float(m["lr"]) for m in placed.jm])
    for path in tpt.tree_paths(to.master):
        diff = np.abs(_np(tpt.tree_get(to.master, path)) - _np(tpt.tree_get(jo.master, path)))
        assert diff.max() <= drift, (placed.name, path, diff.max())
        for name in ("m", "v"):
            got = _np(tpt.tree_get(getattr(to, name), path))
            want = _np(tpt.tree_get(getattr(jo, name), path))
            rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
            assert rel <= MOMENT_REL, (placed.name, path, name, rel)


def test_tier_counters_match_reference(placed):
    """Off-graph steps move the reference's bytes per tier (f32 master, m
    and v read and written, f32 gradients drained); NVMe-resident params
    are read and written once a step, each leaf whole, with the
    reference's scheduler residency; fully in-graph steps report no tier
    counters in either package."""
    for jm, tm in zip(placed.jm, placed.tm):
        keys = [k for k in jm if k.endswith("_bytes") and "pinned" not in k]
        if placed.name not in OFFGRAPH + STREAMED:
            assert not keys and not [k for k in tm if k.endswith("_bytes")]
            continue
        assert sorted(k for k in tm if k.endswith("_bytes") and "pinned" not in k) \
            == sorted(keys)
        n = sum(t.numel() for t in tpt.tree_leaves(placed.tparams))
        if placed.name in OFFGRAPH:
            assert tm["opt_read_bytes"] == tm["opt_write_bytes"] == 12 * n
        if placed.grad_tier_slow:
            assert tm["grad_out_bytes"] == 4 * n
        if placed.name in STREAMED:
            assert (tm["param_in_bytes"] == tm["param_out_bytes"] == tm["param_total_bytes"]
                    == PARAM_TOTAL_BYTES)
            assert tm["peak_resident_param_bytes"] == PEAK_RESIDENT_PARAM_BYTES
        for k in keys:
            assert int(tm[k]) == int(jm[k]), k


def test_store_keys_are_the_reference_keystr_names(placed):
    if placed.name in STREAMED:
        assert placed.tex.param_stream.names() == placed.jex.param_stream.names()
        assert "['blocks']['attn']['wq']" in placed.tex.param_stream.names()
        assert sorted(placed.tex.param_store.keys()) == sorted(placed.jex.param_store.keys())
    if placed.name not in OFFGRAPH:
        return
    jkeys = [k for k, _, _ in placed.jex.offload.layout]
    assert [k for k, _, _ in placed.tex.offload.layout] == jkeys
    assert "['blocks']['attn']['wq']" in jkeys
    assert sorted(placed.tex.opt_store.keys()) == sorted(placed.jex.opt_store.keys())
    if placed.grad_tier_slow:
        assert sorted(placed.tex.grad_store.keys()) == sorted(placed.jex.grad_store.keys())


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def test_keystr_matches_jax_for_every_leaf():
    tree = {"blocks": {"attn": {"wq": 1, "wk": 2}, "ln1": {"scale": 3}}, "embed": {"tok": 4}}
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert list(texec.flatten_with_paths(tree)) == want


def test_make_engine_selects_by_engine_name():
    cfg = tconfigs.smoke("smollm-135m")
    eng = texec.make_engine(RunConfig(model=cfg, parallel=make_parallel("pjit")), "cpu")
    assert isinstance(eng, ZeroInfinityEngine)
    run = RunConfig(model=cfg, parallel=make_parallel("zero3"),
                    offload=make_offload(param_tier="nvme", opt_tier="nvme"))
    assert isinstance(texec.make_engine(run, "cpu"), ExplicitZero3Engine)


@pytest.mark.parametrize("engine,param,n_devices", [("pjit", "device", 2)])
def test_check_ported_raises_for_what_stays_unported(engine, param, n_devices):
    """A plan for more devices than this one rank raises, naming both
    counts (plans for N devices run on N ranks: tests/test_torch_gspmd_mesh.py;
    what stays unported on a GSPMD mesh raises there, naming its item)."""
    run = RunConfig(model=tconfigs.smoke("smollm-135m"), parallel=make_parallel(engine),
                    offload=make_offload(param_tier=param, opt_tier="nvme"))
    with pytest.raises(ValueError, match=f"a plan for {n_devices} device.*this run has 1"):
        texec.check_ported(run, n_devices)


def test_init_state_holds_the_optimizer_only_in_graph():
    cfg = dataclasses.replace(tconfigs.smoke("smollm-135m"), n_layers=2)
    gen = torch.Generator().manual_seed(0)
    dev = ZeroInfinityEngine(RunConfig(model=cfg), "cpu").init_state(gen)
    assert set(dev) == {"params", "opt"}
    assert all(t.dtype == torch.float32 for t in tpt.tree_leaves(dev["opt"].master))
    off = ZeroInfinityEngine(RunConfig(model=cfg, offload=make_offload(opt_tier="nvme")),
                             "cpu").init_state(gen)
    assert set(off) == {"params"}


def test_remat_full_recomputes_each_block_in_backward(monkeypatch):
    """``remat="full"``: the backward runs every block's forward again (the
    matmul launches through the plain path count the recompute), and the
    gradients equal ``remat="none"``'s."""
    from repro_torch.kernels import ref

    cfg = dataclasses.replace(tconfigs.smoke("smollm-135m"), n_layers=2)
    eng = ZeroInfinityEngine(RunConfig(model=cfg), "cpu")
    params = eng.init_params(torch.Generator().manual_seed(0))
    stream = tpipe.SyntheticStream(eng.input_specs(ShapeConfig("t", 8, 2, "train")),
                                   cfg.vocab_size)
    batch = {k: torch.from_numpy(v) for k, v in stream.batch_at(0).items()}
    calls = {"n": 0}
    real = ref.matmul_ref

    def counting(x, w):
        calls["n"] += 1
        return real(x, w)

    monkeypatch.setattr(ref, "matmul_ref", counting)
    grads, n_calls = {}, {}
    for remat in ("none", "full"):
        run = RunConfig(model=cfg, parallel=make_parallel("pjit", remat=remat))
        step = ZeroInfinityEngine(run, "cpu").make_train_step(grads_only=True)
        calls["n"] = 0
        grads[remat], _ = step({"params": params}, batch)
        n_calls[remat] = calls["n"]
    # per layer: three MLP projections forward, two gradient products each;
    # full adds the three forward projections of the recompute
    assert n_calls["full"] == n_calls["none"] + 3 * cfg.n_layers
    for path in tpt.tree_paths(grads["none"]):
        assert torch.equal(tpt.tree_get(grads["full"], path),
                           tpt.tree_get(grads["none"], path)), path


def test_remat_dots_saves_the_products_and_recomputes_attention():
    """``remat="dots"``: gradients equal ``"none"``'s bit for bit, the MLP
    products (the plain matmul) run as often as under ``"none"`` and the
    attention forward as often as under ``"full"``."""
    cfg = dataclasses.replace(tconfigs.smoke("smollm-135m"), n_layers=2)
    n = rp.remat_dots_saves_the_products(cfg, 4)
    assert n["full"]["matmul"] == n["none"]["matmul"] + 3 * cfg.n_layers
    assert n["full"]["attention"] == 2 * n["none"]["attention"] == 2 * cfg.n_layers


def test_remat_dots_keeps_the_reference_products_and_each_blocks_last():
    """The bytes ``dots`` keeps of the products without a batch dim: the
    reference's residuals (q, k, v, the out projection, the MLP's up and
    gate projections), plus each block's down projection, whose output
    only feeds the block's residual sum (``models/remat.py``)."""
    port, last, ref = rp.saved_product_bytes("smollm-135m")
    cfg = tconfigs.smoke("smollm-135m")
    assert last == cfg.n_layers * 2 * 16 * cfg.d_model * 2  # (B * S, d) bf16 per block
    assert port - last == ref > 0


def test_gspmd_nvme_params_drop_to_specs_and_checkpoint_from_the_store(tmp_path):
    """With params on NVMe the state carries the engine's ``TensorSpec``
    tree between steps; ``checkpoint_state`` reads the leaves back from the
    store, and ``total_param_bytes`` counts them at their dtypes."""
    cfg = dataclasses.replace(tconfigs.smoke("smollm-135m"), n_layers=2)
    run = RunConfig(model=cfg, parallel=make_parallel("pjit", remat="none"),
                    offload=make_offload(param_tier="nvme", nvme_dir=str(tmp_path)))
    ex = texec.InfinityExecutor(run, "cpu")
    params = ex.engine.init_params(torch.Generator().manual_seed(0))
    state = ex.reseed(ex.engine.adopt_params(params))
    specs = tpt.tree_leaves(state["params"])
    assert all(isinstance(s, texec.TensorSpec) for s in specs)
    assert ex.total_param_bytes == PARAM_TOTAL_BYTES == sum(
        t.numel() * t.element_size() for t in tpt.tree_leaves(params))
    back = ex.checkpoint_state(state)["params"]
    for path in tpt.tree_paths(params):
        assert torch.equal(tpt.tree_get(back, path), tpt.tree_get(params, path)), path
    ex.close()


def test_grad_accum_averages_the_microbatches_in_f32():
    """Two microbatches: the loss is the mean of the halves' losses and the
    gradient the f32 mean of their bf16 gradients."""
    cfg = dataclasses.replace(tconfigs.smoke("smollm-135m"), n_layers=2)
    eng1 = ZeroInfinityEngine(RunConfig(model=cfg, parallel=make_parallel("pjit", remat="none")),
                              "cpu")
    eng2 = ZeroInfinityEngine(RunConfig(model=cfg, parallel=make_parallel(
        "pjit", remat="none", grad_accum=2)), "cpu")
    params = eng1.init_params(torch.Generator().manual_seed(0))
    stream = tpipe.SyntheticStream(eng1.input_specs(ShapeConfig("t", 8, 4, "train")),
                                   cfg.vocab_size)
    batch = {k: torch.from_numpy(v) for k, v in stream.batch_at(0).items()}
    g2, m2 = eng2.make_train_step(grads_only=True)({"params": params}, batch)
    step1 = eng1.make_train_step(grads_only=True)
    halves = [step1({"params": params}, {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()})
              for i in range(2)]
    assert float(m2["loss"]) == pytest.approx(
        (float(halves[0][1]["loss"]) + float(halves[1][1]["loss"])) / 2, rel=1e-6)
    for path in tpt.tree_paths(g2):
        got = tpt.tree_get(g2, path)
        assert got.dtype == torch.float32
        want = (tpt.tree_get(halves[0][0], path).float()
                + tpt.tree_get(halves[1][0], path).float()) * 0.5
        assert torch.equal(got, want), path
