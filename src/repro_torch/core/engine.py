"""ZeroInfinityEngine on one device: RunConfig -> the family's bundle, its
state, and the GSPMD engine's train step (``repro/core/engine.py``).

On one device every sharding of the reference is the identity, so what is
left of its step (``repro/core/engine.py:139-235``) is the loss's value and
gradient over the nested param tree, accumulated over microbatches when
``parallel.grad_accum > 1``, then AdamW over every leaf through the
fused-Adam kernel (``optim/adam.py``), with the host tier's streaming
around both. ``make_train_step(grads_only=True)`` stops at the gradients:
the executor's off-graph optimizer consumes them (``core/executor.py``).
A family with step statistics (MoE: ``moe_dropped_token_fraction``, the
(E,) ``moe_expert_load``) returns them beside loss and grad norm, from the
bundle's ``loss_stats`` in the same gradient pass.

Gradients are bf16, the params' dtype, as the reference's
(``jax.value_and_grad`` over bf16 leaves); a leaf used twice (the tied
embedding) sums its two cotangents in bf16, as autograd accumulates in the
leaf's dtype. Only the accumulation over microbatches and the global norm
run in f32. (The explicit engine's layered epoch carries its row
gradients in f32: its convention, ``core/zero.py``.)

Host tier (``offload.param_tier="host"``, and ``opt_tier="host"`` while
the optimizer is in-graph): on the card those tensors live in page-locked
CPU memory (``PinnedHostTier``, shared with the explicit engine). A step
copies them to the device non-blocking on the current stream before use
and copies the updated values back, non-blocking, into the same pinned
tensors. Every copy rides that one stream, so a pinned tensor is never
written while its read is in flight; a host reader waits for
``host_ready()`` first. On the CPU (``device="cpu"``) the host tier is
the device, as the reference's host tier is on a CPU backend.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import RunConfig, ShapeConfig
from repro_torch.core import partition as pt
from repro_torch.models import registry
from repro_torch.models.transformer import TensorSpec
from repro_torch.optim import adam


def global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sum of squares over every leaf (tree order)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in pt.tree_leaves(tree)))


class PinnedHostTier:
    """The host tier's copies on the card, shared by both engines: ``pin``
    a tree (or one tensor) into page-locked CPU memory, ``to_device`` it
    non-blocking on the current stream ahead of its use, ``write_back``
    updated values non-blocking into the same pinned tensors, and
    ``ready`` waits for the last write-back before a host reader. Every
    copy rides the one stream, so a pinned tensor is never written while
    its read is in flight."""

    def __init__(self, device: torch.device):
        self.device = device
        self._written: Optional[torch.cuda.Event] = None

    @staticmethod
    def pin(tree):
        return pt.tree_map(lambda t: t.to("cpu").pin_memory(), tree)

    def to_device(self, tree):
        return pt.tree_map(lambda t: t.to(self.device, non_blocking=True), tree)

    def write_back(self, host, dev):
        """Copy ``dev``'s leaves into the pinned ``host`` tensors; returns
        ``host``."""
        for path in pt.tree_paths(host):
            pt.tree_get(host, path).copy_(pt.tree_get(dev, path), non_blocking=True)
        self._written = torch.cuda.Event()
        self._written.record()
        return host

    def ready(self) -> None:
        """Wait for the last write-back (a no-op where nothing was written
        back)."""
        if self._written is not None:
            self._written.synchronize()


class ZeroInfinityEngine:
    def __init__(self, run: RunConfig, device="cuda"):
        self.run = run
        self.device = torch.device(device)
        self.bundle = registry.build(run.model, run.parallel)
        # the host tier is page-locked CPU memory on the card, the device
        # itself on the CPU
        pinned = self.device.type == "cuda"
        self.param_host = run.offload.param_tier == "host" and pinned
        self.opt_host = (run.offload.opt_tier == "host" and pinned
                         and not run.opt_offgraph)
        self.host = PinnedHostTier(self.device)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def init_params(self, generator: torch.Generator) -> dict:
        """The params alone on the engine's device, drawn from
        ``generator`` (which must live there) with the reference's
        distributions: what serving needs."""
        return self.bundle.init(generator, self.device)

    def init_state(self, generator: torch.Generator) -> dict:
        """``{"params"}`` plus ``{"opt"}`` (an ``AdamState``) unless the
        optimizer is off-graph (``run.opt_offgraph``: its states live in
        the executor's store), params drawn as ``init_params`` does."""
        return self.adopt_params(self.init_params(generator))

    def adopt_params(self, params: dict, step: int = 0) -> dict:
        """This engine's state around ``params`` (any device): Adam masters
        the params' f32 copies, zero moments, the Adam step count ``step``
        (a checkpoint's, on a tier migration)."""
        params = pt.tree_map(lambda t: t.to(self.device), params)
        state = {"params": params}
        if not self.run.opt_offgraph:
            opt = adam.init_state(params)
            state["opt"] = opt._replace(step=torch.full_like(opt.step, step))
        return self.place_state(state)

    def place_state(self, state: dict) -> dict:
        """``state``'s leaves where this engine keeps them: host-tier
        params, masters and moments in pinned CPU memory on the card,
        everything else (the Adam step count too) on the device."""
        out = {"params": (self.host.pin(state["params"]) if self.param_host
                          else pt.tree_map(lambda t: t.to(self.device), state["params"]))}
        if "opt" in state:
            opt = state["opt"]
            move = self.host.pin if self.opt_host else (
                lambda tree: pt.tree_map(lambda t: t.to(self.device), tree))
            out["opt"] = adam.AdamState(opt.step.to(self.device), *(move(t) for t in opt[1:]))
        return out

    def param_specs(self) -> dict:
        """The params' tree of ``TensorSpec`` (shape, dtype): what stands
        in the state for leaves that live in the executor's param store
        (``param_tier="nvme"``), and what their bytes are counted from."""
        return pt.tree_map(lambda d: TensorSpec(tuple(d.shape), d.torch_dtype),
                           self.bundle.defs)

    def host_ready(self) -> None:
        """Wait for the last step's write-backs into the pinned host tier."""
        self.host.ready()

    def input_specs(self, shape: ShapeConfig) -> dict:
        return self.bundle.input_specs(shape)

    def n_params_active(self) -> int:
        """The bundle's count: every parameter, MoE experts discounted by
        top_k / E."""
        return self.bundle.n_params_active()

    # ------------------------------------------------------------------
    # train step
    # ------------------------------------------------------------------

    def make_train_step(self, *, grads_only: bool = False):
        """``step(state, batch)``: with ``grads_only`` ->
        ``(grads, {loss, grad_norm})``; otherwise the Adam update ->
        ``(new_state, {loss, grad_norm, lr})``, ``lr`` the step's own
        (``adam.lr_at`` of the new step count). Metrics are 0-d device
        tensors."""
        tc = self.run.train
        accum = self.run.parallel.grad_accum
        # families with step statistics (moe) expose loss_stats: its aux
        # (the routing's drop fraction and expert load) rides out of the
        # gradient pass into the step metrics without a second forward
        loss_stats = self.bundle.loss_stats
        if loss_stats is None:
            loss_f = self.bundle.loss
            loss_stats = lambda params, batch: (loss_f(params, batch), {})
        param_host = self.param_host
        opt_host = self.opt_host and not grads_only

        def value_and_grad(params, batch):
            paths = pt.tree_paths(params)
            leaves = [pt.tree_get(params, p).detach().requires_grad_() for p in paths]
            live: dict = {}
            for p, leaf in zip(paths, leaves):
                pt.tree_set(live, p, leaf)
            loss, aux = loss_stats(live, batch)
            grads: dict = {}
            for p, g in zip(paths, torch.autograd.grad(loss, leaves)):
                pt.tree_set(grads, p, g)
            return loss.detach(), grads, aux

        def grads_of(params, batch):
            if accum <= 1:
                return value_and_grad(params, batch)
            # microbatches along the leading batch dim, summed in f32; the
            # aux of each microbatch averaged, as the reference's scan
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                     for k, v in batch.items()}
            loss_acc = torch.zeros((), dtype=torch.float32, device=self.device)
            g_acc = pt.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                      device=self.device), params)
            auxs = []
            for i in range(accum):
                loss, g, aux = value_and_grad(params, {k: v[i] for k, v in micro.items()})
                loss_acc = loss_acc + loss
                g_acc = _tree_add_f32(g_acc, g)
                auxs.append(aux)
            inv = 1.0 / accum
            aux = {k: torch.stack([a[k] for a in auxs]).mean(dim=0) for k in auxs[0]}
            return loss_acc * inv, pt.tree_map(lambda g: g * inv, g_acc), aux

        def train_step(state, batch):
            params, opt = state["params"], state.get("opt")
            if param_host:  # pinned host -> the device, ahead of the forward
                params = self.host.to_device(params)
            if opt_host:  # pinned host -> the device for the update
                opt = adam.AdamState(opt.step, *(self.host.to_device(t) for t in opt[1:]))
            loss, grads, aux = grads_of(params, batch)
            if grads_only:
                return grads, {"loss": loss, "grad_norm": global_norm(grads), **aux}
            new_params, new_opt = adam.apply_updates(grads, opt, tc, params_prev=params)
            if param_host:  # updated bf16 params back to their pinned tensors
                new_params = self.host.write_back(state["params"], new_params)
            if opt_host:  # updated masters and moments back likewise
                host = state["opt"]
                new_opt = adam.AdamState(new_opt.step, *(
                    self.host.write_back(h, d) for h, d in zip(host[1:], new_opt[1:])))
            metrics = {"loss": loss, "grad_norm": global_norm(grads),
                       "lr": adam.lr_at(tc, new_opt.step), **aux}
            return {"params": new_params, "opt": new_opt}, metrics

        return train_step


def _tree_add_f32(acc: dict, g: dict) -> dict:
    return {k: _tree_add_f32(acc[k], g[k]) if isinstance(acc[k], dict)
            else acc[k] + g[k].float() for k in acc}
