"""RecurrentGemma / Griffin (RG-LRU + local attention, 2:1; the ``hybrid``
family of ``repro/models/rglru.py``).

The block pattern (rec, rec, attn), each temporal block followed by a
GeGLU MLP, repeats over ``groups``; layers past the last whole group are
``tail`` recurrent blocks (38 layers: 12 groups + 2 tail blocks). The
RG-LRU's linear recurrence trains with the reference's log-depth
``lax.associative_scan``, written out here as the same odd/even recursion
(``associative_scan``), so its roundings follow the reference's and the
card runs ~2 log2(S) elementwise passes, not S. Its gate products run in
f32 (TF32 stays off: nothing here turns it on). The local attention goes
through the flash kernel with the config's ``window`` (head_dim 256:
the CUDA-core route), the MLPs through the tiled-matmul kernel
(``cm.mlp_block``), as the dense family's do.

Decode state is fixed-size: per recurrent block the width-4 conv tail and
the (R,) f32 LRU state, per attention block a K/V ring of ``window`` slots.
Prefill lays the prompt's last ``window`` keys out at slot t % window
(rolled when the prompt reaches the window, zero-padded below it); decode
writes slot ``len % window`` and attends over ``min(len + 1, window)``
slots, per row for continuous batching. The reference's ``lax.scan`` over
groups and tail blocks is a Python loop; each group and each tail block
runs under ``parallel.remat`` (``models/remat.py``). Decode writes the
stacked cache IN PLACE.

With a model-parallel context (``mp``, ``models/common.py``) a rank holds
``r/M`` channels of the RG-LRU's ``inner`` leaves (``w_gate``, ``w_in``,
``conv``, ``lam``, ``b_a``, ``b_i``; ``w_out``'s matching rows) where
``lru_width`` divides, under either strategy. The gate products ``w_a`` /
``w_i`` are ``(r, r)`` on ``("embed", "inner")``: the rank holds their
output columns, so the whole ``uf`` is gathered over the model ranks along
its channels before them (backward: the reduce-scatter, which sums the
ranks' partial cotangents). The recurrence is elementwise per channel and
runs on the rank's alone, over the whole sequence: ``cm.inner_enter``
gathers a context-parallel rank's chunks and ``cm.inner_exit``
reduce-scatters (or joins) ``w_out``'s partial sums. Where ``lru_width``
does not divide the block runs whole (under context parallelism on the
gathered sequence, its chunk kept). The attention sub-block and the GeGLU
MLPs are the dense family's under ``mp``; the window rings stay whole on
every model rank (a context-parallel prefill's K/V gathered over the
sequence before the ring is laid out), the conv tails and LRU states hold
the rank's channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.core import partition as pt
from repro_torch.models import common as cm
from repro_torch.models import remat as remat_mod
from repro_torch.models import mamba2
from repro_torch.models import transformer as tf

_stack = mamba2._stack


def rec_defs(cfg: ModelConfig) -> dict:
    d, r, w = cfg.d_model, cfg.lru_width, cfg.conv_width
    return {
        "ln": cm.norm_defs(d, cfg.norm_kind),
        "w_gate": pt.ParamDef((d, r), ("embed", "inner")),
        "w_in": pt.ParamDef((d, r), ("embed", "inner")),
        "conv": pt.ParamDef((w, r), ("conv", "inner"), "float32", "fan_in"),
        "w_a": pt.ParamDef((r, r), ("embed", "inner")),  # recurrence gate
        "b_a": pt.ParamDef((r,), ("inner",), "float32", "zeros"),
        "w_i": pt.ParamDef((r, r), ("embed", "inner")),  # input gate
        "b_i": pt.ParamDef((r,), ("inner",), "float32", "zeros"),
        "lam": pt.ParamDef((r,), ("inner",), "float32", "lru_lambda"),
        "w_out": pt.ParamDef((r, d), ("inner", "embed")),
    }


def attn_sub_defs(cfg: ModelConfig) -> dict:
    return {"ln": cm.norm_defs(cfg.d_model, cfg.norm_kind), "attn": cm.attn_defs(cfg)}


def mlp_sub_defs(cfg: ModelConfig) -> dict:
    return {"ln": cm.norm_defs(cfg.d_model, cfg.norm_kind), "mlp": cm.mlp_defs(cfg)}


def _layout(cfg: ModelConfig):
    """38 layers @ (rec, rec, attn) -> 12 full groups + 2 tail rec blocks."""
    pat = len(cfg.block_pattern)
    n_groups = cfg.n_layers // pat
    return n_groups, cfg.n_layers - n_groups * pat


def param_defs(cfg: ModelConfig) -> dict:
    n_groups, n_tail = _layout(cfg)
    group = {
        "rec1": rec_defs(cfg), "mlp1": mlp_sub_defs(cfg),
        "rec2": rec_defs(cfg), "mlp2": mlp_sub_defs(cfg),
        "attn": attn_sub_defs(cfg), "mlp3": mlp_sub_defs(cfg),
    }
    defs = {
        "embed": cm.embed_defs(cfg),
        "groups": _stack(group, n_groups),
        "ln_f": cm.norm_defs(cfg.d_model, cfg.norm_kind),
    }
    if n_tail:
        defs["tail"] = _stack({"rec": rec_defs(cfg), "mlp": mlp_sub_defs(cfg)}, n_tail)
    return defs


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along dim 1 (``even`` as long as
    ``odd`` or one longer)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n:]], dim=1) if even.shape[1] > n else pairs


def associative_scan(combine, elems: tuple) -> tuple:
    """Inclusive scan of ``elems`` (a tuple of tensors) along dim 1 under
    the associative ``combine(earlier, later)``: ``jax.lax.associative_scan``'s
    recursion (combine adjacent pairs, scan the half, fill in the even
    positions, interleave), so each element is combined in the same order."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = combine(tuple(e[:, 0:n - 1:2] for e in elems),
                      tuple(e[:, 1::2] for e in elems))
    odd = associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine(tuple(e[:, :-1] for e in odd), tuple(e[:, 2::2] for e in elems))
    else:
        even = combine(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def _combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def rg_lru(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
           lam: torch.Tensor, h0=None, c: float = 8.0):
    """x, gates: (B, S, R) f32. Returns (y, h_last); log a = -c *
    softplus(lam) * r, h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)."""
    log_a = -c * F.softplus(lam)[None, None, :] * r_gate
    a = torch.exp(log_a)
    gated_x = x * i_gate
    # multiplier sqrt(1 - a^2) computed stably in log space
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * gated_x

    if x.shape[1] == 1 and h0 is not None:  # decode fast path
        h = a[:, 0] * h0 + b[:, 0]
        return h[:, None], h

    aa, hh = associative_scan(_combine, (a, b))
    if h0 is not None:
        hh = hh + aa * h0[:, None, :]
    return hh, hh[:, -1]


def _causal_conv_silu_free(x, w, state=None):
    """Depthwise causal conv WITHOUT activation (Griffin applies none)."""
    return mamba2._conv(x, w, state)


def rec_block(p, x, cfg: ModelConfig, cache=None, collect_state=False, mp=None):
    """Griffin recurrent block. cache: {"conv": (B,W-1,R), "h": (B,R)}.
    Returns (out, new_cache or None). With ``mp`` (module docstring) the
    channels and the cache are the rank's; under context parallelism ``x``
    and the output are its chunk."""
    W = cfg.conv_width
    split = mp is not None and mp.inner
    xn = cm.inner_enter(cm.norm(x, p["ln"], cfg.norm_kind), mp, split)
    gate = F.gelu(xn @ p["w_gate"].to(xn.dtype), approximate="tanh")
    u = xn @ p["w_in"].to(xn.dtype)

    new_cache = {}
    if cache is None:
        if collect_state:
            new_cache["conv"] = u[:, -(W - 1):].to(torch.bfloat16)
        uc, _ = _causal_conv_silu_free(u, p["conv"])
    else:
        uc, new_cache["conv"] = _causal_conv_silu_free(u, p["conv"], cache["conv"])

    uf = uc.float()
    ua = mp.gather(uf, 2) if split else uf  # the gates read every channel
    r_gate = torch.sigmoid(ua @ p["w_a"].float() + p["b_a"])
    i_gate = torch.sigmoid(ua @ p["w_i"].float() + p["b_i"])
    h0 = cache["h"].float() if cache is not None else None
    y, h_last = rg_lru(uf, r_gate, i_gate, p["lam"], h0=h0)
    if cache is not None or collect_state:
        new_cache["h"] = h_last
    out = (y.to(x.dtype) * gate) @ p["w_out"].to(x.dtype)
    return cm.inner_exit(out, mp, split), (new_cache or None)


def _mlp(p, x, cfg, tiles, mp=None):
    return cm.mlp_block(p["mlp"], cm.norm(x, p["ln"], cfg.norm_kind), cfg, tiles, mp=mp)


def _ring(k: torch.Tensor, window: int) -> torch.Tensor:
    """A prompt's (B, S, KV, D) keys as the decode ring: the last
    ``window`` tokens at slot t % window (zero-padded when S < window)."""
    S = k.shape[1]
    if S >= window:
        return torch.roll(k[:, S - window:], (S - window) % window, dims=1)
    return F.pad(k, (0, 0, 0, 0, 0, window - S))


def make_fns(cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig(), mp=None):
    """The family's functions; with ``mp`` a model rank's part (module
    docstring)."""
    remat = parallel.remat
    tiles = parallel.tiling_factor
    n_groups, n_tail = _layout(cfg)
    window = cfg.window
    cp = mp is not None and not mp.tp

    def attn_sub(p, x, positions, cache=None, collect_kv=False, bmp=mp):
        a, nc = cm.attention_block(
            p["attn"], cm.norm(x, p["ln"], cfg.norm_kind), positions, cfg,
            causal=True, window=window, cache=cache, collect_kv=collect_kv, mp=bmp)
        return x + a, nc

    def group_fwd(x, g, positions, caches=None, collect=False, bmp=mp):
        """One (rec, mlp, rec, mlp, attn, mlp) group."""
        c = caches or {}
        r1, c1 = rec_block(g["rec1"], x, cfg, c.get("rec1"), collect, mp=bmp)
        x = x + r1
        x = x + _mlp(g["mlp1"], x, cfg, tiles, bmp)
        r2, c2 = rec_block(g["rec2"], x, cfg, c.get("rec2"), collect, mp=bmp)
        x = x + r2
        x = x + _mlp(g["mlp2"], x, cfg, tiles, bmp)
        x, ca = attn_sub(g["attn"], x, positions, c.get("attn"), collect, bmp)
        x = x + _mlp(g["mlp3"], x, cfg, tiles, bmp)
        return x, {"rec1": c1, "rec2": c2, "attn": ca}

    def tail_fwd(x, t, caches=None, collect=False, bmp=mp):
        c = caches or {}
        r, cr = rec_block(t["rec"], x, cfg, c.get("rec"), collect, mp=bmp)
        x = x + r
        x = x + _mlp(t["mlp"], x, cfg, tiles, bmp)
        return x, {"rec": cr}

    def positions_of(x):
        B, S, _ = x.shape
        return torch.arange(S, device=x.device)[None, :].expand(B, S)

    def inputs(params, batch, chunked):
        """The embedded tokens and their absolute positions: a
        context-parallel rank's chunk where ``chunked``
        (``tf.chunk_embed``), else the whole sequence."""
        if chunked:
            return tf.chunk_embed(params, batch, cfg, mp)
        x = cm.embed(params["embed"], batch["tokens"], cfg, mp)
        return x, positions_of(x), None

    # ------------------------------ train ---------------------------------

    def train_group(h, g, positions):
        return group_fwd(h, g, positions)[0]

    def train_tail(h, t):
        return tail_fwd(h, t)[0]

    def loss_fn(params, batch):
        """Mean next-token cross-entropy; each stacked leaf is unbound once
        (one stack of the groups' gradients, as in the dense family).
        Context parallel: the rank's chunk's share (``tf.chunk_loss``)."""
        x, positions, chunk = inputs(params, batch, cp)
        groups = pt.tree_map(lambda t: t.unbind(0), params["groups"])
        for l in range(n_groups):
            g = pt.tree_map(lambda ts: ts[l], groups)
            x = remat_mod.remat(remat, train_group, x, g, positions)
        if n_tail:
            tails = pt.tree_map(lambda t: t.unbind(0), params["tail"])
            for l in range(n_tail):
                t = pt.tree_map(lambda ts: ts[l], tails)
                x = remat_mod.remat(remat, train_tail, x, t)
        x = cm.norm(x, params["ln_f"], cfg.norm_kind)
        if cp:
            return tf.chunk_loss(params, x, batch["labels"], chunk, cfg)
        lg = cm.logits(params["embed"], x, cfg, mp)
        return cm.lm_loss(lg[:, :-1], batch["labels"][:, 1:], cfg.vocab_size,
                          mp if cm.vocab_sharded(params["embed"], cfg, mp) else None)

    # ----------------------------- serving --------------------------------

    def cache_defs(batch: int, cache_len: int) -> dict:
        r, w, D = cfg.lru_width, cfg.conv_width, cfg.resolved_head_dim
        KV = tf.local_kv_heads(cfg, mp)
        if mp is not None and mp.inner:
            r //= mp.size  # the rank's channels

        def rec_cache(n):
            return {
                "conv": pt.ParamDef((n, batch, w - 1, r), ("layers", "batch", None, "inner")),
                "h": pt.ParamDef((n, batch, r), ("layers", "batch", "inner"), "float32"),
            }

        ring = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
        defs = {
            "groups": {
                "rec1": rec_cache(n_groups),
                "rec2": rec_cache(n_groups),
                "attn": {"k": pt.ParamDef((n_groups, batch, window, KV, D), ring),
                         "v": pt.ParamDef((n_groups, batch, window, KV, D), ring)},
            },
            "len": pt.ParamDef((), (), "int32", "zeros"),
        }
        if n_tail:
            defs["tail"] = {"rec": rec_cache(n_tail)}
        return defs

    @torch.no_grad()
    def prefill(params, batch):
        """Forward over the prompt, keeping the recurrent states and each
        attention block's K/V ring; returns the last position's logits and
        the cache. Context parallel: where the prompt splits over the model
        ranks each runs its chunk (every recurrent block gathers the
        sequence) and the chunks' K/V are gathered over the model ranks
        before the ring is laid out, else every rank runs the whole
        prompt."""
        tokens = batch["tokens"]
        chunked = cp and tokens.shape[1] % mp.size == 0
        x, positions, _ = inputs(params, batch, chunked)
        bmp = mp.whole() if cp and not chunked else mp
        outs = {"rec1": {"conv": [], "h": []}, "rec2": {"conv": [], "h": []},
                "attn": {"k": [], "v": []}}
        for l in range(n_groups):
            x, c = group_fwd(x, tf.layer_params(params["groups"], l), positions, collect=True,
                             bmp=bmp)
            for sub in ("rec1", "rec2"):
                for k in ("conv", "h"):
                    outs[sub][k].append(c[sub][k])
            kv = [c["attn"]["k"], c["attn"]["v"]]
            if chunked:  # the prompt's K/V from the ranks' chunks
                kv = mp.mesh.all_gather_leaves([(t, 1) for t in kv], "model")
            for k, t in zip(("k", "v"), kv):
                outs["attn"][k].append(_ring(t, window))
        caches = {"groups": pt.tree_map(torch.stack, outs),
                  "len": torch.tensor(tokens.shape[1], dtype=torch.int32, device=x.device)}
        if n_tail:
            tail = {"conv": [], "h": []}
            for l in range(n_tail):
                x, c = tail_fwd(x, tf.layer_params(params["tail"], l), collect=True, bmp=bmp)
                for k in ("conv", "h"):
                    tail[k].append(c["rec"][k])
            caches["tail"] = {"rec": pt.tree_map(torch.stack, tail)}
        x = cm.norm(x, params["ln_f"], cfg.norm_kind)
        last = mp.stack(x[:, -1:])[-1] if chunked else x[:, -1:]
        lg = cm.logits(params["embed"], last, cfg, mp)
        return lg, caches

    @torch.no_grad()
    def decode_step(params, cache, batch):
        """One token per row: ``len`` is a scalar (lockstep) or (B,) per-slot
        lengths; each row writes its ring slot ``len % window`` and attends
        over ``min(len + 1, window)`` slots. States update IN PLACE."""
        x = cm.embed(params["embed"], batch["tokens"], cfg, mp)
        bmp = mp.whole() if cp else mp
        B = x.shape[0]
        clen = cache["len"]
        positions = clen.reshape(-1, 1).expand(B, 1)
        g = cache["groups"]
        win = g["attn"]["k"].shape[2]
        write_pos = torch.remainder(clen, win)  # ring slot for the new token
        valid_len = torch.clamp(clen + 1, max=win)
        for l in range(n_groups):
            caches = {
                "rec1": {k: g["rec1"][k][l] for k in ("conv", "h")},
                "rec2": {k: g["rec2"][k][l] for k in ("conv", "h")},
                "attn": {"k": g["attn"]["k"][l], "v": g["attn"]["v"][l], "len": clen,
                         "write_pos": write_pos, "valid_len": valid_len},
            }
            x, c = group_fwd(x, tf.layer_params(params["groups"], l), positions, caches=caches,
                             bmp=bmp)
            for sub in ("rec1", "rec2"):
                for k in ("conv", "h"):
                    caches[sub][k].copy_(c[sub][k])
        new = {"groups": g, "len": clen + 1}
        if n_tail:
            t = cache["tail"]["rec"]
            for l in range(n_tail):
                rc = {k: t[k][l] for k in ("conv", "h")}
                x, c = tail_fwd(x, tf.layer_params(params["tail"], l), caches={"rec": rc},
                                bmp=bmp)
                for k in ("conv", "h"):
                    rc[k].copy_(c["rec"][k])
            new["tail"] = cache["tail"]
        x = cm.norm(x, params["ln_f"], cfg.norm_kind)
        lg = cm.logits(params["embed"], x, cfg, mp)
        return lg, new

    return {
        "loss": loss_fn,
        "prefill": prefill,
        "decode_step": decode_step,
        "cache_defs": cache_defs,
        "input_specs": tf.make_input_specs(cfg),
    }
