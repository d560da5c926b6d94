"""The reference's side of ``tests/test_torch_dp.py``,
``tests/test_torch_gspmd_mesh.py``, ``tests/test_torch_dp_moe.py`` and
``tests/test_torch_serve_mesh.py``, run
as a script in a subprocess of its own with four host devices (the test
process keeps one). Job ``dp``: the JAX package's
``InfinityExecutor(engine="zero3")`` on a mesh of dp devices for every
case of ``torch_dp_worker.CASES``, and its ``psum_compressed`` under
``shard_map`` on 2 devices; job ``gspmd``: its
``InfinityExecutor(engine="pjit")`` on a mesh of dp devices for every case
of ``torch_dp_worker.GSPMD_CASES``, from the initial params the test saved;
job ``dp_moe``: the explicit engine's layered epoch for every case of
``torch_dp_worker.LAYERED_CASES`` and the pjit executor for every case of
``torch_dp_worker.MOE_GSPMD_CASES``, from the initial states the test
saved; job ``serve``: its ``launch.serve`` on a mesh of dp devices for
every case of ``torch_dp_worker.SERVE_CASES``, from the params the test
saved; jobs ``tp`` and ``tp_serve`` (``tests/test_torch_tp.py``,
``tests/test_torch_tp_serve.py``): the pjit executor and ``launch.serve``
on a ``data x model`` mesh for every case of ``torch_dp_worker.TP_CASES``
and ``TP_SERVE_CASES``; job ``cp_serve`` (``tests/test_torch_cp_serve.py``):
``launch.serve`` for every case of ``CP_SERVE_CASES``; job ``moe_tp``
(``tests/test_torch_moe_tp.py``): the pjit executor for every case of
``MOE_TP_CASES`` (their one-device baselines among them) and
``launch.serve`` for every case of ``MOE_SERVE_CASES``; job
``recurrent_tp`` (``tests/test_torch_recurrent_tp.py``): the same for
``RECURRENT_TP_CASES`` and ``RECURRENT_SERVE_CASES`` (a case's forced
strategy set in the serving config's ``ParallelConfig``); job
``encdec_tp`` (``tests/test_torch_encdec_tp.py``): the same for
``ENCDEC_TP_CASES`` and ``ENCDEC_SERVE_CASES``. Writes the numbers to one
``.npz`` (pytest does not collect this file).

  python tests/torch_dp_reference.py <scratch dir> <out.npz> [dp|gspmd|dp_moe|serve|tp|tp_serve|cp_serve|moe_tp|recurrent_tp|encdec_tp]
"""
from __future__ import annotations

import dataclasses
import functools
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(HERE, "..", "src")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_dp_worker as W  # noqa: E402
from repro import compat  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.config import RunConfig, ShapeConfig, TrainConfig, make_offload, make_parallel  # noqa: E402
from repro.core import executor as jexec  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402


def _f32(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32)


def run_case(case: str, tmp: str, out: dict) -> None:
    dp, d_model, param, grad, opt, compress, mode = W.CASES[case]
    wide = {} if d_model is None else {"d_model": d_model}
    cfg = dataclasses.replace(jconfigs.smoke("smollm-135m"), n_layers=2, **wide)
    run = RunConfig(model=cfg,
                    parallel=make_parallel("zero3", remat="none", grad_compression=compress,
                                           partition_mode=mode),
                    offload=make_offload(param_tier=param, grad_tier=grad, opt_tier=opt,
                                         nvme_dir=os.path.join(tmp, case, "jax")),
                    train=TrainConfig(lr=W.LR, warmup_steps=W.WARMUP))
    mesh = make_local_mesh(dp, 1)
    ex = jexec.InfinityExecutor(run, mesh)
    state = ex.engine.init_state(jax.random.PRNGKey(0))
    out[f"{case}/init_flat"] = _f32(state["flat"])
    state = ex.reseed(state)
    shape = ShapeConfig("t", W.S, W.B, "train")
    stream = jpipe.SyntheticStream(ex.input_specs(shape), cfg.vocab_size, seed=0)
    shardings = ex.batch_shardings(shape)
    step = ex.make_train_step()
    metrics = []
    with compat.set_mesh(mesh):
        for i in range(W.STEPS):
            batch = {k: jax.device_put(v, shardings[k]) for k, v in stream.batch_at(i).items()}
            state, m = step(state, batch)
            metrics.append(m)
    for key in ("loss", "grad_norm", "lr"):
        out[f"{case}/{key}"] = np.array([float(m[key]) for m in metrics])
    for key in metrics[0]:
        if key.endswith("_bytes") and "pinned" not in key:
            out[f"{case}/ctr/{key}"] = np.array([int(m[key]) for m in metrics])
    full = ex.checkpoint_state(state)
    out[f"{case}/flat"] = _f32(full["flat"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(full["other"])[0]:
        out[f"{case}/other/{jax.tree_util.keystr(path)}"] = _f32(leaf)
    out[f"{case}/step"] = np.array(int(full["step"]))
    for key in ("master", "m", "v"):
        if key in full:
            out[f"{case}/{key}"] = _f32(full[key])
    if "g_err" in full:
        for path, leaf in jax.tree_util.tree_flatten_with_path(full["g_err"])[0]:
            out[f"{case}/g_err/{jax.tree_util.keystr(path)}"] = _f32(leaf)
    if ex.opt_store is not None:
        out[f"{case}/opt_keys"] = np.array(sorted(ex.opt_store.keys()))
    ex.close()


def _save_metrics(case: str, metrics: list, out: dict) -> None:
    """Per step: loss, grad norm, lr, MoE's routing statistics where the
    step reports them, and every tier counter (``*_bytes``)."""
    for key in ("loss", "grad_norm", "lr", "moe_dropped_token_fraction"):
        if key in metrics[0]:
            out[f"{case}/{key}"] = np.array([float(m[key]) for m in metrics])
    if "moe_expert_load" in metrics[0]:
        out[f"{case}/moe_expert_load"] = np.stack([_f32(m["moe_expert_load"])
                                                   for m in metrics])
    for key in metrics[0]:
        if key.endswith("_bytes") and "pinned" not in key:
            out[f"{case}/ctr/{key}"] = np.array([int(m[key]) for m in metrics])


def run_layered_case(case: str, tmp: str, out: dict) -> None:
    """``STEPS`` steps of the layered ``case`` (every state class on NVMe)
    on a mesh of its dp devices from the engine's own initial state (the
    rows the test hands the ranks: its draw at one device, padded for dp):
    the initial rows, per step metrics; after, the global rows from the
    param store, 'other', each opt-store key's master, m and v, and the opt
    store's keys."""
    dp, _, _, quant = W.LAYERED_CASES[case]
    run = RunConfig(model=W.layered_cfg(case, jconfigs),
                    parallel=make_parallel("zero3", remat="none"),
                    offload=make_offload(param_tier="nvme", grad_tier="nvme", opt_tier="nvme",
                                         nvme_dir=os.path.join(tmp, case, "jax"),
                                         param_quant=quant),
                    train=TrainConfig(lr=W.LR, warmup_steps=W.WARMUP))
    mesh = make_local_mesh(dp, 1)
    ex = jexec.InfinityExecutor(run, mesh)
    state = ex.engine.init_state(jax.random.PRNGKey(0))
    for key in ("flat", "eflat"):
        if key in state:
            out[f"{case}/init_{key}"] = _f32(state[key])
    state = ex.reseed(state)
    shape = ShapeConfig("t", W.S, W.B, "train")
    stream = jpipe.SyntheticStream(ex.input_specs(shape), run.model.vocab_size, seed=0)
    shardings = ex.batch_shardings(shape)
    step = ex.make_train_step()
    metrics = []
    # outside a context mesh: the expert waves index single-device shards
    for i in range(W.STEPS):
        batch = {k: jax.device_put(v, shardings[k]) for k, v in stream.batch_at(i).items()}
        state, m = step(state, batch)
        metrics.append(m)
    _save_metrics(case, metrics, out)
    flat, eflat = ex._materialize_rows()
    out[f"{case}/flat"] = _f32(flat)
    if eflat is not None:
        out[f"{case}/eflat"] = _f32(eflat)
    for path, leaf in jax.tree_util.tree_flatten_with_path(state["other"])[0]:
        out[f"{case}/other/{jax.tree_util.keystr(path)}"] = _f32(leaf)
    off = ex.offload
    off.store.flush()
    for key, _, n in off.layout:
        for what in ("master", "m", "v"):
            out[f"{case}/opt/{key}/{what}"] = np.concatenate([
                np.asarray(off.store.read(f"{key}.{what}.{ci}").result()).reshape(-1)
                for ci in range(-(-n // off.chunk))]).astype(np.float32)
    out[f"{case}/opt_keys"] = np.array(sorted(ex.opt_store.keys()))
    ex.close()


def run_psum(out: dict) -> None:
    """``psum_compressed`` on 2 devices, each rank its row of
    ``psum_inputs``, three steps of error feedback per case."""
    mesh = jax.make_mesh((2,), ("data",), devices=jax.devices()[:2])

    def f(x, e):
        r, ne = jcomp.psum_compressed(x[0], "data", e[0])
        return r[None], ne[None]

    fn = jax.jit(compat.shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                                  out_specs=(P("data"), P("data")), check_vma=False))
    for shape, dtype in W.PSUM_CASES:
        err = jnp.zeros((2,) + tuple(shape), jnp.float32)
        for i in range(3):
            x = jnp.asarray(W.psum_inputs(shape, i, 2)).astype(getattr(jnp, dtype))
            red, err = fn(x, err)
            out[f"psum/{shape}/{dtype}/{i}/red"] = _f32(red)
            out[f"psum/{shape}/{dtype}/{i}/err"] = _f32(err)


def _keyed(tree) -> dict:
    return {jax.tree_util.keystr(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def run_gspmd_case(case: str, tmp: str, out: dict) -> None:
    """``GSPMD_STEPS`` steps of ``case`` on a mesh of its dp devices from
    the params the test saved (laid out by the engine's shardings, Adam's
    state from them as its ``init_state`` builds it), the global batches
    placed by ``batch_shardings``: per step loss, grad norm, lr and the
    tier counters; after, the global params and in-graph optimizer states
    and each device's addressable shard of the params and masters, and
    the opt store's keys."""
    import torch

    from repro.config import make_offload as jmake_offload
    from repro.core import partition as jpt
    from repro.optim import adam as jadam

    _, _, _, stage, param, grad, opt, accum, B = W.ALL_GSPMD_CASES[case]
    data, model, strategy = W.gspmd_mesh(case)
    run = RunConfig(model=W.gspmd_cfg(case, jconfigs),
                    parallel=make_parallel("pjit", remat="none", zero_stage=stage,
                                           grad_accum=accum, attn_strategy=strategy),
                    offload=jmake_offload(param_tier=param, grad_tier=grad, opt_tier=opt,
                                          nvme_dir=os.path.join(tmp, case, "jax"),
                                          param_quant=W.GSPMD_QUANT.get(case, "none")),
                    train=TrainConfig(lr=W.LR, warmup_steps=W.WARMUP))
    mesh = make_local_mesh(data, model)
    ex = jexec.InfinityExecutor(run, mesh)
    eng = ex.engine
    init = torch.load(W.gspmd_init_path(tmp, case), weights_only=False)
    like = jax.tree.map(lambda d: d, eng.bundle.defs,
                        is_leaf=lambda x: isinstance(x, jpt.ParamDef))
    flat = {k: np.asarray(v.float().numpy()) for k, v in _torch_keyed(init).items()}
    with compat.set_mesh(mesh):
        params = jax.tree_util.tree_map_with_path(
            lambda p, d: jnp.asarray(flat[jax.tree_util.keystr(p)]).astype(d.dtype),
            like, is_leaf=lambda x: isinstance(x, jpt.ParamDef))
        params = jax.device_put(params, eng.param_shardings())
        state = {"params": params}
        if not run.opt_offgraph:
            state["opt"] = jax.jit(jadam.init_state,
                                   out_shardings=eng._opt_state_from(eng.opt_shardings()))(params)
    state = ex.reseed(state)
    if ex.param_nvme:  # the leaves as the store decodes them, before a step
        for k, leaf in _keyed(ex.checkpoint_state(state)["params"]).items():
            out[f"{case}/init_decoded/{k}"] = _f32(leaf)
        ex.param_store.flush()
        inner = getattr(ex.param_store, "inner", ex.param_store)
        out[f"{case}/param_store_keys"] = np.array(sorted(ex.param_store.keys()))
        out[f"{case}/param_store_bytes"] = np.array(
            [np.asarray(inner.read(k).result()).nbytes for k in sorted(ex.param_store.keys())])
    shape = ShapeConfig("t", W.gspmd_seq(case), B, "train")
    stream = jpipe.SyntheticStream(ex.input_specs(shape), run.model.vocab_size, seed=0)
    shardings = ex.batch_shardings(shape)
    step = ex.make_train_step()
    metrics = []
    with compat.set_mesh(mesh):
        for i in range(W.GSPMD_STEPS):
            batch = {k: jax.device_put(v, shardings[k]) for k, v in stream.batch_at(i).items()}
            state, m = step(state, batch)
            metrics.append(m)
    _save_metrics(case, metrics, out)
    # laid out by the engine's shardings (the off-graph step hands back
    # plain arrays that its next step would lay out so)
    if ex.param_nvme:  # the placeholders' leaves from the param store
        state = dict(state, params=ex.checkpoint_state(state)["params"])
    trees = {"params": jax.device_put(state["params"], eng.param_shardings())}
    if "opt" in state:
        opt_sh = eng.opt_shardings()
        trees.update(master=jax.device_put(state["opt"].master, opt_sh["master"]),
                     m=state["opt"].m, v=state["opt"].v)
        out[f"{case}/step"] = np.array(int(state["opt"].step))
    for name, tree in trees.items():
        for k, leaf in _keyed(tree).items():
            out[f"{case}/{name}/{k}"] = _f32(leaf)
            if name in ("params", "master"):  # each device's shard, in mesh order
                by_dev = {s.device: s.data for s in leaf.addressable_shards}
                for r, d in enumerate(np.asarray(mesh.devices).flat):
                    out[f"{case}/{name}_shard{r}/{k}"] = _f32(by_dev[d])
    if ex.opt_store is not None:
        out[f"{case}/opt_keys"] = np.array(sorted(ex.opt_store.keys()))
    ex.close()


def _torch_keyed(tree, prefix="") -> dict:
    """A nested dict of torch tensors by ``keystr`` name."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_torch_keyed(tree[k], prefix + f"[{k!r}]"))
    return out


SERVE_KV = ("resident_bytes", "in_bytes", "out_bytes", "in_wire_bytes", "out_wire_bytes")


def _cache_replicated(decode_step, mesh):
    """``decode_step`` with its new cache laid out replicated. On a model
    axis ``launch.serve``'s compiled decode step gets back from XLA a cache
    laid out otherwise than its input (the KV heads split, or the batch),
    which the compiled step then refuses as its next input; with the slot
    cache replicated going in (``grow_replicated``) and coming out, every
    call sees the layout it was compiled for. The same computation, its
    layouts pinned (test-side wrappers: the reference is not edited)."""
    from jax.sharding import NamedSharding

    whole = NamedSharding(mesh, P())

    def step(params, cache, batch):
        logits, new = decode_step(params, cache, batch)
        return logits, jax.tree.map(lambda x: jax.lax.with_sharding_constraint(x, whole), new)

    return step


def run_serve_case(case: str, tmp: str, out: dict) -> None:
    """The reference's ``launch.serve`` with ``case``'s flags on a mesh of
    its dp devices (``--data-mesh``), from the params the test saved,
    laid out by the engine's param shardings: the generated tokens, the
    admissions and steps, the ``kv`` byte counters and the plan."""
    import json

    import torch

    from repro.core import partition as jpt
    from repro.launch import serve as jserve

    cfg = W.serve_cfg(case, jconfigs)
    init = torch.load(W.serve_init_path(tmp, case), weights_only=False)
    flat = {k: np.asarray(v.float().numpy()) for k, v in _torch_keyed(init).items()}

    def init_state(self, rng):
        params = jax.tree_util.tree_map_with_path(
            lambda p, d: jnp.asarray(flat[jax.tree_util.keystr(p)]).astype(d.dtype),
            self.bundle.defs, is_leaf=lambda x: isinstance(x, jpt.ParamDef))
        if case in W.MODEL_SERVE_CASES:
            meshes.append(self.mesh)
            self.bundle.decode_step = _cache_replicated(self.bundle.decode_step, self.mesh)
        return {"params": jax.device_put(params, self.param_shardings())}

    meshes: list = []
    grow = jserve.kvcache.grow_cache

    def grow_replicated(cache, extra, family):
        """The slot cache the decode step is compiled for, replicated."""
        from jax.sharding import NamedSharding

        return jax.device_put(grow(cache, extra, family), NamedSharding(meshes[0], P()))

    real = jserve.configs.smoke, jserve.ZeroInfinityEngine.init_state, jserve.ParallelConfig
    jserve.configs.smoke = lambda name: cfg
    jserve.ZeroInfinityEngine.init_state = init_state
    if case in W.MODEL_SERVE_CASES:
        jserve.kvcache.grow_cache = grow_replicated
    if W.serve_strategy(case) != "auto":  # the strategy in the run's config, as the port's
        jserve.ParallelConfig = functools.partial(real[2], attn_strategy=W.serve_strategy(case))
    try:
        argv = W.serve_argv(case, "jax", tmp)
        res = jserve.run_serve(jserve._parse(argv), argv)
    finally:
        jserve.configs.smoke, jserve.ZeroInfinityEngine.init_state, jserve.ParallelConfig = real
        jserve.kvcache.grow_cache = grow
    out[f"{case}/generated"] = np.array(json.dumps(res["generated"]))
    for key in ("admissions", "steps", "slots"):
        out[f"{case}/{key}"] = np.array(int(res[key]))
    for key in SERVE_KV:
        out[f"{case}/kv/{key}"] = np.array(int(res["kv"][key]))
    if res["plan"] is not None:
        out[f"{case}/plan"] = np.array(res["plan"].to_json())


def _ckpt_run(case: str, nvme_dir: str):
    engine, _, _, _, param, grad, opt, compress = W.CKPT_CASES[case]
    return RunConfig(model=W.ckpt_cfg(case, jconfigs),
                     parallel=make_parallel(engine, remat="none", grad_compression=compress),
                     offload=make_offload(param_tier=param, grad_tier=grad, opt_tier=opt,
                                          nvme_dir=nvme_dir),
                     train=TrainConfig(lr=W.LR, warmup_steps=W.WARMUP))


def run_ckpt_case(case: str, tmp: str) -> None:
    """``case``'s initial state on a mesh of its devices (the explicit
    engine's own draw, which the test saved for the port; the GSPMD
    engine's state around the saved params, as ``run_gspmd_case`` builds
    it), reseeded, checkpointed through ``checkpoint_state`` into
    ``W.ckpt_path(..., "jax")``."""
    import torch

    from repro.checkpoint.manager import CheckpointManager
    from repro.core import partition as jpt
    from repro.optim import adam as jadam

    engine, D, M = W.CKPT_CASES[case][:3]
    mesh = make_local_mesh(D, M)
    ex = jexec.InfinityExecutor(_ckpt_run(case, os.path.join(tmp, "nv", case, "jax")), mesh)
    eng = ex.engine
    with compat.set_mesh(mesh):
        if engine == "zero3":
            state = eng.init_state(jax.random.PRNGKey(0))
        else:
            init = torch.load(W.ckpt_init_path(tmp, case), weights_only=False)
            flat = {k: np.asarray(v.float().numpy()) for k, v in _torch_keyed(init).items()}
            params = jax.tree_util.tree_map_with_path(
                lambda p, d: jnp.asarray(flat[jax.tree_util.keystr(p)]).astype(d.dtype),
                eng.bundle.defs, is_leaf=lambda x: isinstance(x, jpt.ParamDef))
            params = jax.device_put(params, eng.param_shardings())
            state = {"params": params}
            if not ex.run.opt_offgraph:
                state["opt"] = jax.jit(jadam.init_state, out_shardings=eng._opt_state_from(
                    eng.opt_shardings()))(params)
    state = ex.reseed(state)
    CheckpointManager(W.ckpt_path(tmp, case, "jax"), async_save=False).save(
        0, ex.checkpoint_state(state), {"next_step": 0})
    ex.close()


def run_ckpt_cli(tmp: str, name: str, steps: int, every: int, out: dict, extra=()) -> None:
    """The reference's ``launch.train`` with ``W.CKPT_ARGV`` on its (2, 1)
    mesh: its losses under ``cli/<name>``."""
    from repro.launch import train as jtrain

    argv = W.CKPT_ARGV + ["--steps", str(steps), "--ckpt-every", str(every),
                          "--ckpt-dir", os.path.join(tmp, "cli", name),
                          "--nvme-dir", os.path.join(tmp, "nv", "cli", name), *extra]
    hist = jtrain.train(jtrain.build_argparser().parse_args(argv))
    out[f"cli/{name}/losses"] = np.array(hist["losses"])


def main() -> None:
    tmp, path = sys.argv[1], sys.argv[2]
    job = sys.argv[3] if len(sys.argv) > 3 else "dp"
    assert len(jax.devices()) == 4
    out: dict = {}
    if job == "dp":
        for case in W.CASES:
            run_case(case, tmp, out)
        run_psum(out)
    elif job == "dp_moe":
        for case in W.LAYERED_CASES:
            run_layered_case(case, tmp, out)
        for case in W.MOE_GSPMD_CASES:
            run_gspmd_case(case, tmp, out)
    elif job == "serve":
        for case in W.SERVE_CASES:
            run_serve_case(case, tmp, out)
    elif job == "tp":
        for case in W.TP_CASES:
            run_gspmd_case(case, tmp, out)
    elif job == "tp_serve":
        for case in W.TP_SERVE_CASES:
            run_serve_case(case, tmp, out)
    elif job == "cp_serve":
        for case in W.CP_SERVE_CASES:
            run_serve_case(case, tmp, out)
    elif job == "moe_tp":
        for case in W.MOE_TP_CASES:
            run_gspmd_case(case, tmp, out)
        for case in W.MOE_SERVE_CASES:
            run_serve_case(case, tmp, out)
    elif job == "recurrent_tp":
        for case in W.RECURRENT_TP_CASES:
            run_gspmd_case(case, tmp, out)
        for case in W.RECURRENT_SERVE_CASES:
            run_serve_case(case, tmp, out)
    elif job == "nvme_mesh":
        for case in W.NVME_MESH_CASES:
            run_gspmd_case(case, tmp, out)
    elif job == "ckpt_mesh":
        for case in W.CKPT_CASES:
            run_ckpt_case(case, tmp)
        run_ckpt_cli(tmp, "jax", 3, 2, out)
    elif job == "ckpt_restore":
        run_ckpt_cli(tmp, "torch_into_jax", 3, 0, out, ["--resume", "auto"])
    elif job == "encdec_tp":
        for case in W.ENCDEC_TP_CASES:
            run_gspmd_case(case, tmp, out)
        for case in W.ENCDEC_SERVE_CASES:
            run_serve_case(case, tmp, out)
    else:
        for case in W.GSPMD_CASES:
            run_gspmd_case(case, tmp, out)
    np.savez(path, **out)


if __name__ == "__main__":
    main()
