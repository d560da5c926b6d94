"""Mamba2 (SSD, state-space duality; the ``ssm`` family of
``repro/models/mamba2.py``).

Training and prefill run the chunked SSD algorithm: attention-like
products *within* chunks of ``ssm_chunk`` tokens and a linear recurrence
*across* the chunks' states. Decode is the O(1) recurrent update against
a fixed-size state (``conv_x``/``conv_B``/``conv_C`` conv tails and the
(H, P, N) f32 ``state`` per layer), so the cache does not grow with the
context. The reference writes every product as a jnp einsum outside
Pallas; here they are ``torch.einsum`` / ``torch.matmul`` with f32
accumulation (cuBLAS on the card): this family has no hand-written kernel
on its path, and training reaches the card's kernels through the fused
Adam update alone.

The reference's roundings are kept: the intra-chunk decay ``L`` and the
state decays cast to the input dtype before the f32-accumulating products,
and the last chunk zero-padded (exact: decay exp(0) = 1, contribution
B * xbar = 0). The four-operand intra-chunk contraction is ordered so that
no intermediate is larger than (B, nc, H, Q, Q). The reference's
``lax.scan`` over layers is a Python loop over layer slices; each block
runs under ``parallel.remat`` (``models/remat.py``), as the reference's
``jax.checkpoint`` of the scanned body: under ``dots`` the projections'
products are saved and the SSD's batched einsums recomputed. Decode writes the stacked cache IN PLACE.

With a model-parallel context (``mp``, ``models/common.py``) a rank holds
``H/M`` SSD heads and ``d_in/M`` channels of the ``inner`` leaves (``w_z``,
``w_x``, ``w_dt``, ``conv_x``, ``A_log``, ``D``, ``dt_bias``, ``gn`` and
``w_out``'s rows) where both divide, under either strategy; ``w_B``,
``w_C``, ``conv_B`` and ``conv_C`` are on ``state`` and whole, so every
rank computes ``Bm`` and ``Cm`` whole. Each block runs the rank's heads
over the whole sequence (the SSD scan is per head): ``cm.inner_enter``
gathers a context-parallel rank's chunks, the gated RMS norm sums its
squares over the model ranks (``cm.rms_norm_split``), and ``w_out``'s
partial sums leave by ``cm.inner_exit``. The embedding, logits and loss
are the dense family's (vocab-parallel under tensor parallelism, the
rank's chunk under context parallelism); the decode cache's ``conv_x`` and
``state`` hold the rank's channels and heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.core import partition as pt
from repro_torch.models import common as cm
from repro_torch.models import remat as remat_mod
from repro_torch.models import transformer as tf

NEG_INF = -1e30


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    return d_in, H, cfg.ssm_head_dim, cfg.ssm_state


def _stack(defs, n: int):
    if isinstance(defs, pt.ParamDef):
        return pt.ParamDef((n,) + defs.shape, ("layers",) + defs.axes,
                           defs.dtype, defs.init, defs.init_scale)
    return {k: _stack(v, n) for k, v in defs.items()}


def block_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_in, H, P, N = _dims(cfg)
    w = cfg.conv_width
    return _stack({
        "ln": cm.norm_defs(d, cfg.norm_kind),
        "w_z": pt.ParamDef((d, d_in), ("embed", "inner")),
        "w_x": pt.ParamDef((d, d_in), ("embed", "inner")),
        "w_B": pt.ParamDef((d, N), ("embed", "state")),
        "w_C": pt.ParamDef((d, N), ("embed", "state")),
        "w_dt": pt.ParamDef((d, H), ("embed", "inner")),
        "conv_x": pt.ParamDef((w, d_in), ("conv", "inner"), "float32", "fan_in"),
        "conv_B": pt.ParamDef((w, N), ("conv", "state"), "float32", "fan_in"),
        "conv_C": pt.ParamDef((w, N), ("conv", "state"), "float32", "fan_in"),
        "A_log": pt.ParamDef((H,), ("inner",), "float32", "zeros"),
        "D": pt.ParamDef((H,), ("inner",), "float32", "ones"),
        "dt_bias": pt.ParamDef((H,), ("inner",), "float32", "zeros"),
        "gn": pt.ParamDef((d_in,), ("inner",), "float32", "zeros"),
        "w_out": pt.ParamDef((d_in, d), ("inner", "embed")),
    }, cfg.n_layers)


def param_defs(cfg: ModelConfig) -> dict:
    return {"embed": cm.embed_defs(cfg), "blocks": block_defs(cfg),
            "ln_f": cm.norm_defs(cfg.d_model, cfg.norm_kind)}


def _conv(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv as width shifted adds, x: (B,S,C), w: (W,C);
    with ``state`` (B, W-1, C) (decode) also the new state, the last W-1
    inputs in x's dtype. Shared with ``models/rglru.py``."""
    W = w.shape[0]
    if state is not None:
        full = torch.cat([state.to(x.dtype), x], dim=1)
        y = sum(full[:, W - 1 - i: full.shape[1] - i] * w[W - 1 - i][None, None, :]
                for i in range(W))
        return y, full[:, -(W - 1):]
    pad = F.pad(x, (0, 0, W - 1, 0))
    y = sum(pad[:, W - 1 - i: W - 1 - i + x.shape[1]] * w[W - 1 - i][None, None, :]
            for i in range(W))
    return y, None


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state=None):
    """The conv followed by SiLU; returns ``(y, new_state_or_None)``."""
    y, new_state = _conv(x, w, state)
    return F.silu(y), new_state


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) -> (..., T, T) with out[i,j] = sum_{k=j+1..i} x_k (i>=j),
    -1e30 above the diagonal."""
    T = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    d = c[..., :, None] - c[..., None, :]
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, d, torch.full_like(d, NEG_INF))


def ssd_chunked(xbar, dA, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD scan. xbar: (B,S,H,P) discretized inputs; dA: (B,S,H)
    log-decays (<= 0); Bm/Cm: (B,S,N). Returns (y (B,S,H,P) f32, final
    state (B,H,P,N) f32)."""
    Bsz, S, H, P = xbar.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:  # zero padding is exact: decay exp(0)=1, contribution B*xbar=0
        xbar = F.pad(xbar, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    S_out = S
    S = S + pad
    nc = S // Q
    in_dt = Cm.dtype  # the decays round to the input dtype, as the reference's

    x = xbar.reshape(Bsz, nc, Q, H, P)
    a = dA.reshape(Bsz, nc, Q, H).permute(0, 1, 3, 2).float()  # (B,nc,H,Q)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    cum = torch.cumsum(a, dim=-1)  # (B,nc,H,Q)
    L = torch.exp(_segsum(a)).to(in_dt)  # (B,nc,H,Q,Q)

    # intra-chunk "bcln,bcsn,bchls,bcshp->bclhp", contracted pairwise in
    # f32 so that no intermediate outgrows (B,nc,H,Q,Q)
    CB = torch.einsum("bcln,bcsn->bcls", Cc.float(), Bc.float())
    y_diag = torch.einsum("bchls,bcshp->bclhp", CB[:, :, None] * L.float(), x.float())

    # chunk state contributions: decay from each position to the chunk end
    decay_states = torch.exp(cum[..., -1:] - cum).to(Bc.dtype)  # (B,nc,H,Q)
    xd = x.float() * decay_states.float().permute(0, 1, 3, 2)[..., None]
    states = torch.einsum("bcsn,bcshp->bchpn", Bc.float(), xd)

    # inter-chunk recurrence over nc, emitting the state entering each chunk
    chunk_decay = torch.exp(cum[..., -1])  # (B,nc,H)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xbar.device)
         if h0 is None else h0.float())
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1).to(in_dt)  # (B,nc,H,P,N)

    state_decay_in = torch.exp(cum).to(in_dt)  # decay chunk start -> pos (inclusive)
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc.float(), h_prev.float())
    y_off = y_off * state_decay_in.float().permute(0, 1, 3, 2)[..., None]

    y = (y_diag + y_off).reshape(Bsz, S, H, P)[:, :S_out]
    return y, h


def mamba_block(p, x, cfg: ModelConfig, cache=None, collect_state=False, mp=None):
    """x: (B,S,d) -> (out, new_cache). ``cache`` {"conv_x","conv_B",
    "conv_C","state"} for decode; ``collect_state`` (prefill) returns the
    equivalent cache in one pass; otherwise the cache is None. With ``mp``
    (module docstring) the heads, channels and cache are the rank's; under
    context parallelism ``x`` and the output are its chunk."""
    _, _, P, _ = _dims(cfg)
    W = cfg.conv_width
    split = mp is not None and mp.inner
    H, d_in = p["A_log"].shape[-1], p["w_x"].shape[-1]  # the rank's
    x = cm.norm(x, p["ln"], cfg.norm_kind)  # pre-norm (residual added by caller)
    x = cm.inner_enter(x, mp, split)
    z = x @ p["w_z"].to(x.dtype)
    xs = x @ p["w_x"].to(x.dtype)
    Bm = x @ p["w_B"].to(x.dtype)
    Cm = x @ p["w_C"].to(x.dtype)
    dt = x.float() @ p["w_dt"].float()
    dt = F.softplus(dt + p["dt_bias"])  # (B,S,H)
    A = -torch.exp(p["A_log"])  # (H,)

    new_cache = {}
    if cache is None:
        if collect_state:  # pre-conv tails are the decode conv state
            new_cache["conv_x"] = xs[:, -(W - 1):].to(torch.bfloat16)
            new_cache["conv_B"] = Bm[:, -(W - 1):].to(torch.bfloat16)
            new_cache["conv_C"] = Cm[:, -(W - 1):].to(torch.bfloat16)
        xs, _ = _causal_conv(xs, p["conv_x"])
        Bm, _ = _causal_conv(Bm, p["conv_B"])
        Cm, _ = _causal_conv(Cm, p["conv_C"])
    else:
        xs, new_cache["conv_x"] = _causal_conv(xs, p["conv_x"], cache["conv_x"])
        Bm, new_cache["conv_B"] = _causal_conv(Bm, p["conv_B"], cache["conv_B"])
        Cm, new_cache["conv_C"] = _causal_conv(Cm, p["conv_C"], cache["conv_C"])

    xh = xs.reshape(*xs.shape[:2], H, P)
    xbar = xh * dt[..., None].to(xh.dtype)
    dA = dt * A  # (B,S,H) log decay

    if cache is None:
        y, last_state = ssd_chunked(xbar, dA, Bm, Cm, cfg.ssm_chunk)
        if collect_state:
            new_cache["state"] = last_state
    else:
        # O(1) recurrent decode: h = exp(dA) h + xbar (outer) B ; y = <h, C>
        h = cache["state"].float()  # (B,H,P,N)
        dec = torch.exp(dA[:, 0].float())  # (B,H)
        h = h * dec[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", xbar[:, 0].float(), Bm[:, 0].float())
        y = torch.einsum("bhpn,bn->bhp", h, Cm[:, 0].float())[:, None]
        new_cache["state"] = h

    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(*y.shape[:2], d_in)
    y = (y * F.silu(z.float())).to(x.dtype)
    y = cm.rms_norm_split(y, p["gn"], mp) if split else cm.rms_norm(y, p["gn"])
    out = cm.inner_exit(y @ p["w_out"].to(y.dtype), mp, split)
    return out, (new_cache if (cache is not None or collect_state) else None)


CACHE_KEYS = ("conv_x", "conv_B", "conv_C", "state")


def cache_defs_fn(cfg: ModelConfig, mp=None):
    """The decode cache's defs; with ``mp`` the rank's channels and heads
    where they split over the model ranks."""
    d_in, H, P, N = _dims(cfg)
    if mp is not None and mp.inner:
        d_in, H = d_in // mp.size, H // mp.size
    w = cfg.conv_width
    L = cfg.n_layers

    def cache_defs(batch: int, cache_len: int) -> dict:
        return {
            "conv_x": pt.ParamDef((L, batch, w - 1, d_in), ("layers", "batch", None, "inner")),
            "conv_B": pt.ParamDef((L, batch, w - 1, N), ("layers", "batch", None, "state")),
            "conv_C": pt.ParamDef((L, batch, w - 1, N), ("layers", "batch", None, "state")),
            "state": pt.ParamDef((L, batch, H, P, N), ("layers", "batch", "inner", None, "state"),
                                 "float32"),
            "len": pt.ParamDef((), (), "int32", "zeros"),
        }

    return cache_defs


def make_fns(cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig(), mp=None):
    """The family's functions; with ``mp`` a model rank's part (module
    docstring)."""
    remat = parallel.remat
    cp = mp is not None and not mp.tp

    def train_block(h, blk):
        return h + mamba_block(blk, h, cfg, mp=mp)[0]

    def loss_fn(params, batch):
        """Mean next-token cross-entropy (labels shifted by one inside);
        each stacked block leaf is unbound once, as in the dense family.
        Context parallel: the rank's chunk's share (``tf.chunk_loss``)."""
        if cp:
            x, _, chunk = tf.chunk_embed(params, batch, cfg, mp)
        else:
            x = cm.embed(params["embed"], batch["tokens"], cfg, mp)
        layers = pt.tree_map(lambda t: t.unbind(0), params["blocks"])
        for l in range(cfg.n_layers):
            blk = pt.tree_map(lambda ts: ts[l], layers)
            x = remat_mod.remat(remat, train_block, x, blk)
        x = cm.norm(x, params["ln_f"], cfg.norm_kind)
        if cp:
            return tf.chunk_loss(params, x, batch["labels"], chunk, cfg)
        lg = cm.logits(params["embed"], x, cfg, mp)
        return cm.lm_loss(lg[:, :-1], batch["labels"][:, 1:], cfg.vocab_size,
                          mp if cm.vocab_sharded(params["embed"], cfg, mp) else None)

    @torch.no_grad()
    def prefill(params, batch):
        """The chunked scan over the prompt, keeping each layer's conv tails
        and final state; returns the last position's logits and the cache.
        Context parallel: where the prompt splits over the model ranks each
        embeds its chunk (every block gathers the sequence), else every
        rank runs the whole prompt; the cache is the rank's channels of the
        whole prompt's either way."""
        tokens = batch["tokens"]
        chunked = cp and tokens.shape[1] % mp.size == 0
        if chunked:
            x, _, _ = tf.chunk_embed(params, batch, cfg, mp)
        else:
            x = cm.embed(params["embed"], tokens, cfg, mp)
        bmp = mp.whole() if cp and not chunked else mp
        outs = {k: [] for k in CACHE_KEYS}
        for l in range(cfg.n_layers):
            out, nc = mamba_block(tf.layer_params(params["blocks"], l), x, cfg,
                                  collect_state=True, mp=bmp)
            x = x + out
            for k in CACHE_KEYS:
                outs[k].append(nc[k])
        x = cm.norm(x, params["ln_f"], cfg.norm_kind)
        last = mp.stack(x[:, -1:])[-1] if chunked else x[:, -1:]
        lg = cm.logits(params["embed"], last, cfg, mp)
        cache = {k: torch.stack(v) for k, v in outs.items()}
        cache["len"] = torch.tensor(tokens.shape[1], dtype=torch.int32, device=x.device)
        return lg, cache

    @torch.no_grad()
    def decode_step(params, cache, batch):
        """One token per row against the fixed-size state; the conv tails
        and states are updated IN PLACE. ``len`` (scalar or per row) only
        counts."""
        x = cm.embed(params["embed"], batch["tokens"], cfg, mp)
        bmp = mp.whole() if cp else mp
        for l in range(cfg.n_layers):
            layer = {k: cache[k][l] for k in CACHE_KEYS}
            out, nc = mamba_block(tf.layer_params(params["blocks"], l), x, cfg, cache=layer,
                                  mp=bmp)
            x = x + out
            for k in CACHE_KEYS:
                layer[k].copy_(nc[k])
        x = cm.norm(x, params["ln_f"], cfg.norm_kind)
        lg = cm.logits(params["embed"], x, cfg, mp)
        return lg, {**{k: cache[k] for k in CACHE_KEYS}, "len": cache["len"] + 1}

    return {
        "loss": loss_fn,
        "prefill": prefill,
        "decode_step": decode_step,
        "cache_defs": cache_defs_fn(cfg, mp),
        "input_specs": tf.make_input_specs(cfg),
    }
