"""Mixture-of-Experts transformer (the ``moe`` family of
``repro/models/moe.py``: granite 32e top-8, llama4-scout 16e top-1).

Dispatch is sort-based, as in the reference: each group's tokens are
argsorted (stably) by expert id and gathered into (G, E, capacity, d)
buffers, the experts run as two or three batched products
(``gecd,edf->gecf``; plain ``torch.einsum``, as the reference leaves them
to XLA outside Pallas), and each token's outputs come back weighted by its
renormalized gates. Capacity overflow drops assignments; ``routing_stats``
counts the dropped fraction and the per-expert load, the
``moe_dropped_token_fraction`` / ``moe_expert_load`` step metrics. Routing
and capacity are local to a group of ``min(group, S)`` tokens of one
sequence, so a rank holding whole sequences routes as the global batch
does; the statistics are sums over every group of the global batch, so a
mesh sums the data ranks' ``routing_counts`` before the ratios are taken
(the model ranks of a data row route the same tokens).

On a model axis (``mp``; the reference puts ``experts`` on ``model``,
``repro/core/partition.py:213``, and falls back to ``mlp`` where they do
not divide) each rank holds its experts, runs their slots alone and joins
its partial output over the model ranks in the combine dtype: the
reference's "cross-expert reduction lowers to the model-axis psum"
(``moe_ffn``). The attention, embedding and logits are the dense
transformer's under the same strategy (``make_fns``).

Where the reference scatter-adds the combine, the port gathers: every
non-dropped (token, choice) assignment knows its slot (``inv``, the
inverse of the slot -> token map ``tok_slot``), and a token sums its k
slot outputs in a fixed order (``_GatherSum``). The dispatch is the
transpose, so its backward is the same gather-sum. Neither direction
scatters with atomics, so a step repeats to the bit on the card.

``route_tokens`` (the slot plan) and ``expert_mix`` (the per-expert MLP)
are shared with ``moe_ffn_selected``, which runs the same computation over
a selected subset of expert rows: an expert with no routed tokens gives
zero output and zero gradient, so the explicit engine's layered epoch
pages in only the router-selected rows (``core/zero.py``).

Precision is the reference's: the router product takes bf16 inputs and
accumulates in f32 (the router is rounded to bf16, then both operands
multiply in f32), top-k breaks ties to the lower expert index (a stable
descending sort, as ``jax.lax.top_k``), the combine sums in
``cfg.moe_combine_dtype``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.core import partition as pt
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf

DEFAULT_GROUP = 1024  # tokens per routing group (the reference's default)


def moe_defs(cfg: ModelConfig) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    defs = {
        "router": pt.ParamDef((d, E), ("embed", None), "float32"),
        "w_in": pt.ParamDef((E, d, f), ("experts", "embed_e", "mlp")),
        "w_out": pt.ParamDef((E, f, d), ("experts", "mlp", "embed_e")),
    }
    if cfg.mlp_kind in ("swiglu", "geglu"):
        defs["w_gate"] = pt.ParamDef((E, d, f), ("experts", "embed_e", "mlp"))
    return defs


def expert_leaf_names(cfg: ModelConfig) -> tuple:
    """Canonical order of the per-expert weight leaves in a paged expert row."""
    gated = cfg.mlp_kind in ("swiglu", "geglu")
    return ("w_in", "w_gate", "w_out") if gated else ("w_in", "w_out")


def expert_row_defs(cfg: ModelConfig) -> dict:
    """ParamDefs of ONE expert's weights (the leading E axis stripped): the
    schedule unit the layered epoch pages on its own."""
    defs = moe_defs(cfg)
    return {name: pt.ParamDef(defs[name].shape[1:], defs[name].axes[1:],
                              defs[name].dtype, defs[name].init,
                              defs[name].init_scale)
            for name in expert_leaf_names(cfg)}


def block_defs(cfg: ModelConfig) -> dict:
    L = cfg.n_layers

    def stack(defs):
        if isinstance(defs, pt.ParamDef):
            return pt.ParamDef((L,) + defs.shape, ("layers",) + defs.axes,
                               defs.dtype, defs.init, defs.init_scale)
        return {k: stack(v) for k, v in defs.items()}

    return stack({
        "ln1": cm.norm_defs(cfg.d_model, cfg.norm_kind),
        "attn": cm.attn_defs(cfg),
        "ln2": cm.norm_defs(cfg.d_model, cfg.norm_kind),
        "moe": moe_defs(cfg),
    })


def param_defs(cfg: ModelConfig) -> dict:
    return {"embed": cm.embed_defs(cfg), "blocks": block_defs(cfg),
            "ln_f": cm.norm_defs(cfg.d_model, cfg.norm_kind)}


def _capacity(cfg: ModelConfig, T: int) -> int:
    cap = max(int(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts), 1)
    return min(cap, T * cfg.top_k)


# ---------------------------------------------------------------------------
# the deterministic dispatch / combine
# ---------------------------------------------------------------------------


def _gather_sum(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[g, n] = sum_j ext[g, idx[g, n, j]]`` over j in order, where
    ``ext`` is ``src`` (G, M, d) with one zero row appended: the index M
    reads zeros."""
    G, M, d = src.shape
    N, J = idx.shape[1], idx.shape[2]
    ext = torch.cat([src, src.new_zeros(G, 1, d)], dim=1)
    out = torch.gather(ext, 1, idx.reshape(G, N * J, 1).expand(G, N * J, d))
    out = out.view(G, N, J, d)
    return out[:, :, 0] if J == 1 else out.sum(dim=2)


class _GatherSum(torch.autograd.Function):
    """``_gather_sum(src, fwd)`` whose backward is ``_gather_sum(dout,
    bwd)``: ``bwd`` is ``fwd``'s transpose (the slot -> token map against
    the token -> slots map), so neither pass scatters."""

    @staticmethod
    def forward(ctx, src, fwd, bwd):
        ctx.save_for_backward(bwd)
        return _gather_sum(src, fwd)

    @staticmethod
    def backward(ctx, dout):
        (bwd,) = ctx.saved_tensors
        return _gather_sum(dout.contiguous(), bwd), None, None


def dispatch(xg: torch.Tensor, tok_slot: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """(G, T, d) tokens -> (G, S, d) slot inputs, zero in empty slots
    (``tok_slot`` == T)."""
    return _GatherSum.apply(xg, tok_slot[..., None], inv)


def combine(out: torch.Tensor, tok_slot: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """(G, S, d) slot outputs -> (G, T, d): each token's k slots summed in
    choice order; dropped choices (``inv`` == S) add nothing."""
    return _GatherSum.apply(out, inv, tok_slot[..., None])


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def route_tokens(router: torch.Tensor, xg: torch.Tensor, cfg: ModelConfig) -> dict:
    """Sorted-dispatch routing plan. xg: (G, T, d) grouped tokens.

    The reference's (G, E, C) slot plan: ``tok_ec`` (token index per
    slot), ``valid_ec`` (slot occupied), ``w_ec`` (renormalized gate
    weight, zero on invalid slots), ``counts`` (G, E) routed-token counts
    per expert, ``cap``; plus the port's ``inv`` (G, T, k): the flat slot
    ``e * C + c`` of each token's choices, ``E * C`` where dropped."""
    G, T, _ = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cfg, T)
    dev = xg.device

    # bf16 operands, f32 accumulation: the router rounds to the tokens'
    # dtype first (a bf16 product would flip near-tied top-k choices)
    logits = torch.matmul(xg.float(), router.to(xg.dtype).float())
    gates = torch.softmax(logits, dim=-1)
    # a stable descending sort breaks ties to the lower index (lax.top_k)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    topg, topi = vals[..., :k], idx[..., :k]
    topg = topg / torch.sum(topg, dim=-1, keepdim=True)

    flat_e = topi.reshape(G, T * k)
    flat_w = topg.reshape(G, T * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    tok_of_slot = order // k  # token index of each sorted slot

    counts = torch.zeros(G, E, dtype=torch.long, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))  # (G, E); integer adds are exact
    starts = torch.cumsum(counts, dim=1) - counts  # exclusive prefix
    ar = torch.arange(cap, device=dev)
    slot_ec = starts[:, :, None] + ar[None, None, :]  # (G, E, C)
    valid_ec = ar[None, None, :] < counts[:, :, None]
    slot_ec = torch.clamp(slot_ec, 0, T * k - 1).reshape(G, -1)

    tok_ec = torch.gather(tok_of_slot, 1, slot_ec).reshape(G, E, cap)
    w_sorted = torch.gather(flat_w, 1, order)
    w_ec = torch.gather(w_sorted, 1, slot_ec).reshape(G, E, cap)
    w_ec = torch.where(valid_ec, w_ec, torch.zeros_like(w_ec))

    # each assignment's sorted position, hence its slot within its expert
    pos = torch.empty_like(order).scatter_(
        1, order, torch.arange(T * k, device=dev).expand(G, T * k))
    c = pos - torch.gather(starts, 1, flat_e)
    inv = torch.where(c < cap, flat_e * cap + c, torch.full_like(c, E * cap))
    return {"tok_ec": tok_ec, "valid_ec": valid_ec, "w_ec": w_ec,
            "counts": counts, "cap": cap, "inv": inv.reshape(G, T, k)}


def routing_counts(counts: torch.Tensor, cap: int) -> torch.Tensor:
    """counts (G, E) -> (E + 2,) int64: each expert's routed assignments
    summed over the groups, then the dropped and the routed totals. Sums,
    so a mesh adds the ranks' (one all-reduce) before a ratio is taken."""
    counts = counts.long()
    return torch.cat([torch.sum(counts, dim=0),
                      torch.sum(torch.clamp(counts - cap, min=0))[None],
                      torch.sum(counts)[None]])


def stats_from_counts(raw: torch.Tensor) -> dict:
    """(L, E + 2) ``routing_counts`` of L layers -> the mean over the
    layers of each layer's ``moe_dropped_token_fraction`` (the share of
    routed assignments lost to capacity overflow) and (E,)
    ``moe_expert_load`` (the share landing on each expert)."""
    E = raw.shape[-1] - 2
    routed = torch.clamp(raw[:, E + 1], min=1)
    return {"moe_dropped_token_fraction": (raw[:, E] / routed).float().mean(),
            "moe_expert_load": (raw[:, :E] / routed[:, None]).float().mean(dim=0)}


def routing_stats(counts: torch.Tensor, cap: int, k: int) -> dict:
    """counts (G, E) of one layer -> its ``stats_from_counts``."""
    return stats_from_counts(routing_counts(counts, cap)[None])


def expert_mix(xin: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
               w_gate, mlp_kind: str) -> torch.Tensor:
    """(G, E', C, d) x per-expert weights (E', d, f) / (E', f, d) ->
    (G, E', C, d); E' the full expert axis or a selected subset."""
    h = torch.einsum("gecd,edf->gecf", xin, w_in.to(xin.dtype))
    if mlp_kind == "swiglu":
        h = F.silu(torch.einsum("gecd,edf->gecf", xin, w_gate.to(xin.dtype))) * h
    elif mlp_kind == "geglu":
        h = F.gelu(torch.einsum("gecd,edf->gecf", xin, w_gate.to(xin.dtype)),
                   approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("gecf,efd->gecd", h, w_out.to(h.dtype))


def _groups(x: torch.Tensor, group: int) -> torch.Tensor:
    B, S, d = x.shape
    T = min(group, S)
    return x.reshape(B * (S // T), T, d)


def _mix_and_combine(xg, rows, tok_e, valid_e, w_e, inv, cfg):
    """The experts' MLP over the slots of (G, E', C) and the combine back
    to (G, T, d) in ``moe_combine_dtype``."""
    G, T, d = xg.shape
    Ep, C = tok_e.shape[1], tok_e.shape[2]
    tok_slot = torch.where(valid_e, tok_e, torch.full_like(tok_e, T)).reshape(G, Ep * C)
    xin = dispatch(xg, tok_slot, inv).view(G, Ep, C, d)
    out = expert_mix(xin, rows["w_in"], rows["w_out"], rows.get("w_gate"), cfg.mlp_kind)
    out = out * w_e[..., None].to(out.dtype)
    cdt = getattr(torch, cfg.moe_combine_dtype)
    return combine(out.to(cdt).reshape(G, Ep * C, d), tok_slot, inv)


def model_split(p: dict, cfg: ModelConfig) -> bool:
    """Whether a model rank holds a part of the expert leaves in ``p``
    (its ``E / M`` experts, or every expert's ``d_ff / M`` columns where
    the experts do not split)."""
    return p["w_in"].shape[0] < cfg.n_experts or p["w_in"].shape[-1] < cfg.d_ff


def _local_experts(r: dict, lo: int, n: int) -> tuple:
    """The slot plan of experts ``[lo, lo + n)`` alone: their (G, n, C)
    slots and the token -> slot map re-aimed at them (``n * C`` where a
    choice went to another rank's expert or was dropped)."""
    cap, inv = r["cap"], r["inv"]
    e = torch.div(inv, cap, rounding_mode="floor")
    mine = (e >= lo) & (e < lo + n)
    inv = torch.where(mine, inv - lo * cap, torch.full_like(inv, n * cap))
    return (r["tok_ec"][:, lo:lo + n], r["valid_ec"][:, lo:lo + n],
            r["w_ec"][:, lo:lo + n], inv)


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig,
            group: int = DEFAULT_GROUP, with_stats: bool = False,
            with_counts: bool = False, mp=None):
    """x (B, S, d) -> (B, S, d): sorted-dispatch MoE over all E experts;
    ``with_stats`` also returns ``routing_stats``, ``with_counts`` the
    ``routing_counts`` they are taken from.

    With ``mp`` (a model rank's ``ModelAxis``) the expert leaves may be the
    rank's part (``model_split``). Every model rank routes the same whole
    groups with the whole router: under context parallelism with ``x``
    the rank's chunk (``mp.seq``) the chunks are gathered along the
    sequence first (backward: the reduce-scatter), else ``x`` is the same
    on every rank and enters through ``mp.enter`` (backward: the
    all-reduce, in ``x``'s bf16). The rank runs its experts' slots alone
    (or every expert's MLP on its columns), and its partial ``y``, in
    ``cfg.moe_combine_dtype``, is summed over the model ranks in that
    dtype before the cast: an all-reduce (``mp.join``), or under ``mp.seq``
    a reduce-scatter back to the rank's chunk (``mp.scatter``), which
    gathers no expert leaf. Where nothing splits every rank computes the
    whole ``y`` (a chunk keeps its part)."""
    B, S, d = x.shape
    dt = x.dtype
    split = mp is not None and model_split(p, cfg)
    seq = mp is not None and mp.seq
    if seq:
        x = mp.gather(x, 1)
    elif split:
        x = mp.enter(x)
    xg = _groups(x, group)
    r = route_tokens(p["router"], xg, cfg)
    plan = r["tok_ec"], r["valid_ec"], r["w_ec"], r["inv"]
    n = p["w_in"].shape[0]
    if n < cfg.n_experts:  # this rank's experts [m * n, (m+1) * n)
        plan = _local_experts(r, mp.rank * n, n)
    y = _mix_and_combine(xg, p, *plan, cfg).reshape(B, -1, d)
    if split:
        y = mp.scatter(y, 1) if seq else mp.join(y)
    elif seq:
        y = y[:, mp.rank * S:(mp.rank + 1) * S]
    y = y.to(dt)
    if with_stats:
        return y, routing_stats(r["counts"], r["cap"], cfg.top_k)
    if with_counts:
        return y, routing_counts(r["counts"], r["cap"])
    return y


def moe_counts(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
               group: int = DEFAULT_GROUP) -> torch.Tensor:
    """Routing counts only: (B, S, d) -> (G, E). The layered epoch runs
    this ahead of the expert waves to pick which rows to page in."""
    return route_tokens(router, _groups(x, group), cfg)["counts"]


def moe_ffn_selected(router: torch.Tensor, rows: dict, x: torch.Tensor,
                     sel_ids: torch.Tensor, sel_mask: torch.Tensor,
                     cfg: ModelConfig, group: int = DEFAULT_GROUP) -> torch.Tensor:
    """The MoE output from a selected set of expert rows.

    rows: per-expert weights stacked over the selection, w_in (W, d, f),
    w_out (W, f, d), optionally w_gate (W, d, f); sel_ids (W,) expert ids;
    sel_mask (W,) zero on padding slots (a padded id repeats a real one
    and adds nothing). Summed over a partition of the experts with tokens
    this is ``moe_ffn``: an unselected expert's slots are empty."""
    B, S, d = x.shape
    xg = _groups(x, group)
    r = route_tokens(router, xg, cfg)
    G, T, _ = xg.shape
    E, W, cap = cfg.n_experts, sel_ids.shape[0], r["cap"]
    sel_ids = sel_ids.to(device=x.device, dtype=torch.long)
    sel_mask = sel_mask.to(device=x.device, dtype=torch.float32)
    live = sel_mask > 0
    tok_sel = r["tok_ec"][:, sel_ids]
    valid_sel = r["valid_ec"][:, sel_ids] & live[None, :, None]
    w_sel = r["w_ec"][:, sel_ids] * sel_mask[None, :, None]
    # expert -> its (first live) position in the selection, W where absent
    hit = (sel_ids[None, :] == torch.arange(E, device=x.device)[:, None]) & live[None, :]
    first = torch.where(hit, torch.arange(W, device=x.device)[None, :],
                        torch.full((E, W), W, device=x.device))
    wpos = torch.amin(first, dim=1)  # (E,)
    # re-aim the token -> slot map at the selection's slots
    inv = r["inv"]
    e_of = torch.div(inv, cap, rounding_mode="floor").clamp(max=E - 1)
    w_of = wpos[e_of]
    keep = (inv < E * cap) & (w_of < W)
    inv_sel = torch.where(keep, w_of * cap + inv % cap, torch.full_like(inv, W * cap))
    y = _mix_and_combine(xg, rows, tok_sel, valid_sel, w_sel, inv_sel, cfg)
    return y.to(x.dtype).reshape(B, S, d)


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------


def make_fns(cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig(), mp=None):
    """The dense transformer's functions (``transformer.make_fns``, the
    reference's ``dense`` scaffolding) with ``moe_ffn`` in each block's
    MLP place, ``loss_stats`` returning the routing statistics; with
    ``mp`` a model rank's part (module docstring)."""
    if cfg.window:
        raise NotImplementedError(
            "a local attention window on this family is not wired: none of "
            "its configs sets one (the flash kernels take it; the hybrid "
            "family's attention passes it)")

    def ffn(blk, h, bmp, counts=False):
        return moe_ffn(blk["moe"], h, cfg, with_counts=counts, mp=bmp)

    return tf.make_fns(cfg, parallel, mp, ffn=ffn, stats=stats_from_counts)
