"""Explicit ZeRO-3 engine, dense family, one device — the layered-epoch
subset of ``repro/core/zero.py``.

Each layer's parameters flatten into one row (``core/partition.py``
``FlatLayout``, the reference's byte order). With one data-parallel rank
the row's all-gather and its reduce-scatter transpose are the identity, so
a row is used as it is read. ``make_layer_fns`` exposes the training step
as the pieces the executor's scheduler drives over rows streamed through
the prefetch window (``core/executor.py``): ``embed_fwd``, ``layer_fwd``,
``layer_vjp`` (the layer's forward recomputed under autograd: the paper's
"parameters loaded one additional time"), ``head``, ``accum_sumsq``,
``embed_vjp`` and ``finish`` (Adam on the small device-resident states).

Under q8 transport (``offload.param_quant="q8"``) a row reaches
``layer_fwd`` and ``layer_vjp`` as its wire operands ``(q, s)``: the MLP
weights in ``quantized_leaves`` (a static plan per layout) go into the
quantized-matmul kernel as they are, every other leaf is dequantized on
the device.

Not ported: dp > 1 (ROADMAP Queue 1 item 8), the MoE rows (item 6), int8
gradient compression (items 8 and 10: the reference has it only in the
cross-rank reduce and the monolithic step), and the monolithic in-graph
step (``make_train_step``) with its device/host tiers (item 10).
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import RunConfig, ShapeConfig
from repro_torch.core import partition as pt
from repro_torch.models import common as cm
from repro_torch.models import transformer
from repro_torch.models.transformer import TensorSpec
from repro_torch.optim import adam as adam_mod
from repro_torch.runtime import trace


def _trace_wrap_fns(fns: dict) -> dict:
    """Each piece in a compute span. On the card the span covers the
    host's launches; the executor's ``device_sync`` span is where the
    device work lands on the critical path."""
    return {name: trace.wrap(name, fn, sys="compute", attr="compute")
            for name, fn in fns.items()}


class ExplicitZero3Engine:
    """Layered-epoch ZeRO-3 on one device. The optimizer states of the rows
    never live here (``opt_offgraph``): the executor streams them through
    ``ChunkedAdamOffload``; the small 'other' states (embedding, final
    norm) stay on the device with their Adam state."""

    def __init__(self, run: RunConfig, device="cuda"):
        cfg = run.model
        if cfg.family != "dense":
            raise NotImplementedError(
                f"explicit engine: family {cfg.family!r} is not ported "
                "(ROADMAP.md Queue 1 item 6: MoE rows)")
        if run.parallel.partition_mode != "allgather":
            raise ValueError(
                "the layered epoch needs the bandwidth-centric (allgather) "
                "row layout; the broadcast baseline stores whole layers per "
                "owner rank")
        if run.parallel.grad_compression != "none":
            raise NotImplementedError(
                "grad_compression='int8' is not ported: the reference runs it "
                "only in the cross-rank reduce and the monolithic step "
                "(ROADMAP.md Queue 1 items 8 and 10)")
        if not run.opt_offgraph:
            raise NotImplementedError(
                "the explicit engine's in-graph step (device/host optimizer "
                "tiers without NVMe params) is not ported (ROADMAP.md Queue "
                "1 item 10)")
        self.run = run
        self.device = torch.device(device)
        self.dp = 1  # one device: the row's gather and reduce are the identity
        self.block_fn = transformer.make_block_fn(cfg, run.parallel)
        self.defs = transformer.param_defs(cfg)
        self.n_layers = cfg.n_layers
        self._build_layout()
        # the MLP weights whose products read the q8 wire row in place;
        # fixed by the layout, the same for every row and step
        self.quantized_leaves = (pt.quantized_leaf_plan(self.layout)
                                 if run.offload.param_quant == "q8" else ())

    def _build_layout(self) -> None:
        self.layout = pt.build_layout(self.defs["blocks"], self.dp)

    def _other_defs(self) -> dict:
        return {"embed": self.defs["embed"], "ln_f": self.defs["ln_f"]}

    # ------------------------------------------------------------------
    # state and data interface
    # ------------------------------------------------------------------

    def init_state(self, generator: torch.Generator) -> dict:
        """``{"flat": (L, P) bf16 rows, "other", "other_opt", "step"}`` on
        the engine's device, drawn from ``generator`` (on that device)."""
        params = pt.init_tree(self.defs, generator, self.device)
        other = {"embed": params["embed"], "ln_f": params["ln_f"]}
        return {
            "flat": pt.flatten_blocks(params["blocks"], self.layout, torch.bfloat16),
            "other": other,
            "other_opt": adam_mod.init_state(other),
            "step": torch.zeros((), dtype=torch.int32, device=self.device),
        }

    def input_specs(self, shape: ShapeConfig) -> dict:
        B, S = shape.global_batch, shape.seq_len
        return {"tokens": TensorSpec((B, S), torch.int32),
                "labels": TensorSpec((B, S), torch.int32)}

    def n_params_active(self) -> int:
        other = sum(math.prod(d.shape) for d in pt.tree_leaves(self._other_defs()))
        return sum(self.layout.sizes) * self.n_layers + other

    def layer_row_device(self) -> torch.device:
        """Where one materialized layer row lives: with one rank, its slice
        is the whole row, on the engine's device."""
        return self.device

    # ------------------------------------------------------------------
    # per-layer pieces for the scheduler-driven layered epoch
    # ------------------------------------------------------------------

    def make_layer_fns(self) -> dict:
        """The layered step's pieces (``repro/core/zero.py:599``). Forward
        pieces run without autograd; ``layer_vjp`` and ``head`` record only
        their own graph and return gradients (``torch.autograd.grad``)."""
        cfg, tc, dp = self.run.model, self.run.train, self.dp
        block_fn, layout, plan = self.block_fn, self.layout, self.quantized_leaves

        def _block(x, row, anchor_row=None):
            """``row``: a bf16 row, or a q8 wire row ``(q, s)`` whose
            gradient ``anchor_row`` carries."""
            if isinstance(row, tuple):
                blk = pt.unflatten_wire_row(*row, anchor_row, layout, plan)
            else:
                blk = pt.unflatten_row(row, layout, torch.bfloat16)
            B, S = x.shape[0], x.shape[1]
            positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
            return block_fn(x, blk, positions)

        def _grad_leaves(tree):
            return pt.tree_map(lambda t: t.detach().requires_grad_(), tree)

        def _as_tree(paths, grads, like):
            out: dict = {}
            for path, g in zip(paths, grads):
                pt.tree_set(out, path, g if g is not None
                            else torch.zeros_like(pt.tree_get(like, path)))
            return out

        @torch.no_grad()
        def _embed_fwd(other, tokens):
            return cm.embed(other["embed"], tokens, cfg)

        @torch.no_grad()
        def _layer_fwd(x, row):
            return _block(x, row)

        def _layer_vjp(x, row, dy):
            with torch.enable_grad():
                x_ = x.detach().requires_grad_()
                if isinstance(row, tuple):
                    # a wire row takes no gradient itself: a zero row stands
                    # in for it (``unflatten_wire_row``)
                    row_ = torch.zeros(layout.padded, dtype=torch.bfloat16,
                                       device=x.device, requires_grad=True)
                    y = _block(x_, row, row_)
                else:
                    row_ = row.detach().requires_grad_()
                    y = _block(x_, row_)
                dx, drow = torch.autograd.grad(y, (x_, row_), dy)
            # the bf16 row's cotangent, carried in f32 to the grad tier
            return dx, drow.float()

        def _head(x, other, labels):
            with torch.enable_grad():
                x_ = x.detach().requires_grad_()
                o = _grad_leaves(other)
                h = cm.norm(x_, o["ln_f"], cfg.norm_kind)
                lg = cm.logits(o["embed"], h, cfg)
                # scaled by 1/dp before the cross-rank sum (identity at dp=1)
                loss_s = cm.lm_loss(lg[:, :-1], labels[:, 1:], cfg.vocab_size) / dp
                paths = pt.tree_paths(o)
                grads = torch.autograd.grad(loss_s, [x_] + pt.tree_leaves(o),
                                            allow_unused=True)
            return loss_s.detach(), grads[0], _as_tree(paths, grads[1:], other)

        @torch.no_grad()
        def _accum_sumsq(acc, g_row):
            return acc + torch.sum(g_row.float() ** 2)

        def _embed_vjp(other, tokens, dx0):
            with torch.enable_grad():
                o = _grad_leaves(other)
                x = cm.embed(o["embed"], tokens, cfg)
                paths = pt.tree_paths(o)
                grads = torch.autograd.grad(x, pt.tree_leaves(o), dx0,
                                            allow_unused=True)
            return _as_tree(paths, grads, other)

        @torch.no_grad()
        def _finish(other, other_opt, step, g_head, g_emb, sumsq_flat):
            paths = pt.tree_paths(g_head)
            g_other: dict = {}
            for path in paths:
                pt.tree_set(g_other, path, pt.tree_get(g_head, path)
                            + pt.tree_get(g_emb, path))
            new_step = step + 1
            lr = adam_mod.lr_at(tc, new_step)
            gnorm = torch.sqrt(sumsq_flat + sum(
                torch.sum(g.float() ** 2) for g in pt.tree_leaves(g_other)))
            new_other, new_other_opt = adam_mod.apply_updates(
                g_other, other_opt, tc, params_prev=other)
            return new_other, new_other_opt, new_step, {"grad_norm": gnorm, "lr": lr}

        return _trace_wrap_fns({
            "embed_fwd": _embed_fwd, "layer_fwd": _layer_fwd,
            "layer_vjp": _layer_vjp, "head": _head,
            "accum_sumsq": _accum_sumsq, "embed_vjp": _embed_vjp,
            "finish": _finish,
        })
