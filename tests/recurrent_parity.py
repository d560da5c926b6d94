"""Shared machinery of ``tests/test_torch_{ssm,hybrid,vlm,encdec}.py``:
the port's families added after the dense one (mamba2, recurrentgemma,
llava, seamless) against the JAX package's, on the CPU, and of every
family's ``remat="dots"`` checks. Not a test module; each test file calls
these with its arch and states its tolerances.

The bundles' weights are the reference's ``init`` carried across by
``repro_torch.bridge``; batches come from numpy seeds (or each package's
bit-identical ``SyntheticStream``).
"""
import dataclasses
import json
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax._src.ad_checkpoint import saved_residuals
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from repro import configs as jconfigs
from repro.checkpoint import manager as jman
from repro.config import RunConfig as JRun
from repro.config import TrainConfig as JTrain
from repro.config import make_offload as jmake_offload
from repro.config import make_parallel as jmake_parallel
from repro.core import executor as jexec
from repro.models import registry as jreg
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import manager as tman
from repro_torch.config import RunConfig, ShapeConfig, TrainConfig
from repro_torch.config import make_offload, make_parallel
from repro_torch.core import executor as texec
from repro_torch.core import partition as tpt
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ref as tref
from repro_torch.models import registry as treg
from repro_torch.models import remat as tremat
from repro_torch.optim import adam as tadam
from repro_torch.optim.adam import AdamState

# the GSPMD step's bounds (tests/test_torch_gspmd.py states their reasoning)
TIER_TOL = dict(rtol=2e-3, atol=2e-3)
MOMENT_REL = 2**-5
STEPS = 2
B, S = 4, 16

# placement -> (param tier, grad tier, opt tier, grad_accum, remat): every
# one-card placement of the GSPMD step (tests/test_torch_gspmd.py)
PLACEMENTS = {
    "all_device": ("device", "device", "device", 1, "none"),
    "opt_host": ("device", "device", "host", 1, "none"),
    "opt_nvme": ("device", "device", "nvme", 1, "none"),
    "grad_nvme": ("device", "nvme", "host", 1, "none"),
    "param_host": ("host", "device", "device", 1, "none"),
    "grad_accum_2": ("device", "device", "device", 2, "none"),
    "remat_full": ("device", "device", "device", 1, "full"),
}
OFFGRAPH = ("opt_nvme", "grad_nvme")


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def rel_err(got, want) -> float:
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def close(got, want, tol, what=""):
    err = rel_err(got, want)
    assert err <= tol, f"{what}: max rel err {err} > {tol}"


def cfgs(arch, n_layers=None):
    jcfg, tcfg = jconfigs.smoke(arch), tconfigs.smoke(arch)
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def bundles(arch, n_layers=None, remat=None):
    """(jcfg, jbundle, jparams, tbundle, tparams) from the same weights;
    ``remat`` builds both bundles under that policy (default: each
    package's default)."""
    jcfg, tcfg = cfgs(arch, n_layers)
    if remat is None:
        jb, tb = jreg.build(jcfg), treg.build(tcfg)
    else:
        jb = jreg.build(jcfg, parallel=jmake_parallel("pjit", remat=remat))
        tb = treg.build(tcfg, make_parallel("pjit", remat=remat))
    jparams = jax.jit(jb.init)(jax.random.PRNGKey(0))  # one compile, not per-leaf dispatch
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, jb, jparams, tb, tparams


def tokens(cfg, seed, Bn=2, Sn=16) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (Bn, Sn)).astype(np.int32)


def torch_value_and_grad(fn, params, batch):
    """(loss, {path: grad}) of ``fn(params, batch)`` over every leaf."""
    paths = tpt.tree_paths(params)
    leaves = [tpt.tree_get(params, p).detach().requires_grad_() for p in paths]
    live: dict = {}
    for p, leaf in zip(paths, leaves):
        tpt.tree_set(live, p, leaf)
    loss = fn(live, batch)
    return loss.detach(), dict(zip(paths, torch.autograd.grad(loss, leaves)))


def embeds(cfg, seed, shape) -> np.ndarray:
    """Float model inputs (vision embeddings, frames): unit-normal * 0.1 in
    f32, as the drivers draw them; each package casts them to bf16."""
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


def loss_and_grads(bs, seed, Sn, act_rel, grad_rel, extra=None):
    """The bundle's loss and every gradient against the reference's;
    ``extra`` adds numpy inputs beside the tokens and labels."""
    jcfg, jb, jparams, tb, tparams = bs
    toks, labels = tokens(jcfg, seed, Sn=Sn), tokens(jcfg, seed + 1, Sn=Sn)
    batch = {"tokens": toks, "labels": labels, **(extra or {})}
    lj, gj = jax.jit(jax.value_and_grad(jb.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    lt, gt = torch_value_and_grad(tb.loss, tparams,
                                  {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(lt), float(lj), rtol=act_rel)
    assert len(gt) == len(jax.tree.leaves(gj))
    for path, g in gt.items():
        close(g, tpt.tree_get(gj, path), grad_rel, "/".join(path))


def cache_leaves(cache) -> dict:
    """Every leaf of a (nested) cache by its ``/``-joined path."""
    return {"/".join(p): tpt.tree_get(cache, p) for p in tpt.tree_paths(cache)}


def _remat_batch(tcfg, seed, extra, Sn):
    toks = torch.from_numpy(tokens(tcfg, seed, Sn=Sn))
    return {"tokens": toks, "labels": toks,
            **{k: torch.from_numpy(v) for k, v in (extra or {}).items()}}


def _loss_of(tb):
    """The bundle's scalar loss (the MoE's ``loss_stats`` without aux)."""
    if tb.loss_stats is None:
        return tb.loss
    return lambda params, batch: tb.loss_stats(params, batch)[0]


def remat_full_equals_none(tcfg, seed, extra=None, Sn=16):
    """``remat="full"`` recomputes each checkpointed unit in backward to
    the same loss and gradients, bit for bit; ``extra`` adds numpy
    inputs."""
    params = treg.build(tcfg).init(torch.Generator().manual_seed(0))
    batch = _remat_batch(tcfg, seed, extra, Sn)
    out = {r: torch_value_and_grad(treg.build(tcfg, make_parallel("pjit", remat=r)).loss,
                                   params, batch) for r in ("none", "full")}
    assert torch.equal(out["none"][0], out["full"][0])
    for path, g in out["none"][1].items():
        assert torch.equal(g, out["full"][1][path]), path


def remat_dots_saves_the_products(tcfg, seed, extra=None, Sn=16):
    """``remat="dots"``: the loss and every gradient equal ``none``'s bit
    for bit; the plain matmul (the MLP products) runs as often as under
    ``none`` (saved, never recomputed) and attention's plain forward as
    often as under ``full`` (recomputed). Returns the calls by policy."""
    params = treg.build(tcfg).init(torch.Generator().manual_seed(0))
    batch = _remat_batch(tcfg, seed, extra, Sn)
    calls = {"matmul": 0, "attention": 0}
    real_mm, real_att = tref.matmul_ref, tref.attention_fwd_ref

    def mm(*a, **k):
        calls["matmul"] += 1
        return real_mm(*a, **k)

    def att(*a, **k):
        calls["attention"] += 1
        return real_att(*a, **k)

    out, n = {}, {}
    tref.matmul_ref, tref.attention_fwd_ref = mm, att
    try:
        for r in ("none", "full", "dots"):
            calls.update(matmul=0, attention=0)
            tb = treg.build(tcfg, make_parallel("pjit", remat=r))
            out[r] = torch_value_and_grad(_loss_of(tb), params, batch)
            n[r] = dict(calls)
    finally:
        tref.matmul_ref, tref.attention_fwd_ref = real_mm, real_att
    assert torch.equal(out["none"][0], out["dots"][0])
    for path, g in out["none"][1].items():
        assert torch.equal(g, out["dots"][1][path]), path
    assert n["dots"]["matmul"] == n["none"]["matmul"], n
    assert n["dots"]["attention"] == n["full"]["attention"], n
    return n


def saved_product_bytes(arch, n_layers=None, seed=3, Sn=16):
    """What ``remat="dots"`` keeps from the products without a batch dim,
    in one forward of the bundles' loss on the same weights and batch:
    (the port's saved bytes, the sum over its checkpointed blocks of each
    block's last saved product, the reference's kept residual bytes). The
    reference's are its residuals (``saved_residuals``) under ``dots``
    beyond those under ``full``, which saves only each block's input."""
    jcfg, jb, jparams, tb, tparams = bundles(arch, n_layers, remat="dots")
    toks = tokens(jcfg, seed, Sn=Sn)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}

    def residual_bytes(remat):
        b = jreg.build(jcfg, parallel=jmake_parallel("pjit", remat=remat))
        return sum(a.size * a.dtype.itemsize for a, _ in saved_residuals(b.loss, jparams, jbatch))

    blocks = []  # per checkpointed block: the bytes of each saved product

    def counting_context():
        saved = []
        blocks.append(saved)

        def policy(ctx, op, *args, **kwargs):
            decision = tremat.dots_policy(ctx, op, *args, **kwargs)
            if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                x, w = args[:2]
                saved.append(x.shape[0] * w.shape[1] * x.element_size())
            return decision

        return create_selective_checkpoint_contexts(policy)

    real = tremat.dots_context
    tremat.dots_context = counting_context
    try:
        torch_value_and_grad(tb.loss, tparams, {"tokens": torch.from_numpy(toks),
                                                "labels": torch.from_numpy(toks)})
    finally:
        tremat.dots_context = real
    assert blocks and all(blocks)
    return (sum(map(sum, blocks)), sum(b[-1] for b in blocks),
            residual_bytes("dots") - residual_bytes("full"))


# ---------------------------------------------------------------------------
# the GSPMD step in every one-card placement
# ---------------------------------------------------------------------------

def reference_run(arch, mesh, seq=S) -> dict:
    """The reference's ``InfinityExecutor(engine="pjit")`` with every state
    on the device, ``STEPS`` steps of ``B`` x ``seq``. Every placement
    computes the same function (the reference's own cross-tier tests hold
    its placements to ``TIER_TOL`` of each other), so each of the port's
    placements is held against this one run (a module-scoped fixture of
    each test file)."""
    jcfg = jconfigs.smoke(arch)
    jrun = JRun(model=jcfg, parallel=jmake_parallel("pjit", remat="none"),
                offload=jmake_offload(), train=JTrain(lr=3e-3, warmup_steps=2))
    jex = jexec.InfinityExecutor(jrun, mesh)
    jstate = jex.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jstate["params"])
    stream = tpipe.SyntheticStream(
        treg.build(tconfigs.smoke(arch)).input_specs(ShapeConfig("t", seq, B, "train")),
        jcfg.vocab_size, seed=0)
    jstep, jm = jex.make_train_step(), []
    for i in range(STEPS):
        batch = stream.batch_at(i)
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jm.append({k: np.asarray(v) for k, v in m.items()})
    jex.close()
    return {"init": init, "m": jm, "params": jax.tree.map(np.asarray, jstate["params"]),
            "opt": jax.tree.map(np.asarray, tuple(jstate["opt"])), "stream": stream}


def run_placement(arch, placement, nvme_dir, ref):
    """The port's GSPMD executor in ``placement`` for ``STEPS`` steps from
    the weights and batches of ``ref`` (``reference_run``); returns (port
    state, port metrics, reference run, train config)."""
    param, grad, opt, accum, remat = PLACEMENTS[placement]
    trun = RunConfig(model=tconfigs.smoke(arch),
                     parallel=make_parallel("pjit", remat=remat, grad_accum=accum),
                     offload=make_offload(nvme_dir=f"{nvme_dir}/torch", param_tier=param,
                                          grad_tier=grad, opt_tier=opt),
                     train=TrainConfig(lr=3e-3, warmup_steps=2))
    tex = texec.InfinityExecutor(trun, "cpu")
    tstate = tex.reseed(tex.engine.adopt_params(bridge.params_from_numpy(ref["init"])))
    tstep, tm = tex.make_train_step(), []
    for i in range(STEPS):
        batch = ref["stream"].batch_at(i)
        tstate, m = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        tm.append(m)
    tex.close()
    return tstate, tm, ref, trun


def check_step(placed, step):
    tstate, tm, ref, _ = placed
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[step][key]), float(ref["m"][step][key]),
                                   **TIER_TOL, err_msg=key)


def check_params(placed):
    """Params after the last step to the drift bound (AdamW's bounded
    update, plus each side's bf16 rounding of its master) and, in the
    mean, 2^-5 of the summed learning rates."""
    tstate, _, ref, trun = placed
    lrs = [float(m["lr"]) for m in ref["m"]]
    drift = tadam.parity_bound(trun.train, lrs)
    for path in tpt.tree_paths(tstate["params"]):
        got, want = np_(tpt.tree_get(tstate["params"], path)), np_(tpt.tree_get(ref["params"], path))
        diff = np.abs(got - want)
        assert (diff <= drift + 2**-8 * (np.abs(want) + np.abs(got))).all(), (path, diff.max())
        assert diff.mean() <= 2**-5 * sum(lrs), (path, diff.mean())


def check_optimizer(placed, offgraph):
    """In-graph: the step count exact, masters to the drift bound, m and v
    to ``MOMENT_REL`` in norm; off-graph: no optimizer in the state."""
    tstate, _, ref, trun = placed
    if offgraph:
        assert "opt" not in tstate
        return
    step, master, m, v = ref["opt"]
    to = tstate["opt"]
    assert int(to.step) == int(step) == STEPS
    drift = tadam.parity_bound(trun.train, [float(x["lr"]) for x in ref["m"]])
    for path in tpt.tree_paths(to.master):
        diff = np.abs(np_(tpt.tree_get(to.master, path)) - np_(tpt.tree_get(master, path)))
        assert diff.max() <= drift, (path, diff.max())
        for name, want_tree in (("m", m), ("v", v)):
            got = np_(tpt.tree_get(getattr(to, name), path))
            want = np_(tpt.tree_get(want_tree, path))
            rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
            assert rel <= MOMENT_REL, (path, name, rel)


# ---------------------------------------------------------------------------
# checkpoints: the reference's files, byte for byte
# ---------------------------------------------------------------------------


def _same_files(a: str, b: str) -> None:
    ma = json.load(open(os.path.join(a, "manifest.json")))
    mb = json.load(open(os.path.join(b, "manifest.json")))
    assert list(ma["leaves"]) == list(mb["leaves"])
    for key, la in ma["leaves"].items():
        assert la == mb["leaves"][key], key  # file, shape, dtype, bytes, md5
        assert open(os.path.join(a, la["file"]), "rb").read() == \
            open(os.path.join(b, mb["leaves"][key]["file"]), "rb").read(), key
    assert ma["step"] == mb["step"] and ma["extra"] == mb["extra"]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def checkpoint_both_ways(arch, n_layers, tmp_path, mesh):
    """The GSPMD engine's in-graph state (nested ``params``, the Adam
    state) as the reference's engine draws it: the same files from both
    packages, and each restores the other's bit for bit."""
    jcfg, _ = cfgs(arch, n_layers)
    jeng = jexec.make_engine(JRun(model=jcfg, parallel=jmake_parallel("pjit"),
                                  offload=jmake_offload()), mesh)
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jstate)
    step, master, m, v = init["opt"]
    tstate = {"params": bridge.params_from_numpy(init["params"]),
              "opt": AdamState(bridge.tensor_from_numpy(step), bridge.params_from_numpy(master),
                               bridge.params_from_numpy(m), bridge.params_from_numpy(v))}
    jman.CheckpointManager(str(tmp_path / "j"), async_save=False).save(1, jstate, {"next_step": 1})
    tman.CheckpointManager(str(tmp_path / "t"), async_save=False).save(1, tstate, {"next_step": 1})
    _same_files(str(tmp_path / "j" / "step-00000001"), str(tmp_path / "t" / "step-00000001"))
    got, _ = tman.CheckpointManager(str(tmp_path / "j")).restore(tstate)
    want = tman.flatten_with_keys(tstate)
    for key, leaf in tman.flatten_with_keys(got).items():
        assert torch.equal(_bits(leaf), _bits(want[key])), key
    jgot, _ = jman.CheckpointManager(str(tmp_path / "t")).restore(jstate)
    jflat = jman._flatten_with_keys(jgot)
    for key, leaf in jman._flatten_with_keys(jstate).items():
        assert jflat[key].tobytes() == np.asarray(leaf).tobytes(), key
    return list(want)
