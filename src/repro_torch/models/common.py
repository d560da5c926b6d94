"""Shared model layers: norms, RoPE, attention, MLP, embeddings, logits.

The PyTorch counterpart of ``repro/models/common.py`` for one device. The
layouts at every public function are the JAX package's: activations
``(B, S, d)``, attention heads ``(B, S, H, D)``, caches ``(B, S, KV, D)``.
Prefill attention goes through ``kernels.ops.flash_attention`` (the CUDA
kernel on the card) and the MLP projections through
``core.tiling.tiled_matmul``; the QKV/O projections, the tied logits and
one-token decode attention are plain torch, as the reference leaves them
to XLA outside Pallas.

The reference's sharding annotations (``constrain``, ``repro/models/
common.py:256-268,322-324,344``) leave XLA to partition the math over the
``model`` axis; here a rank holds what the reference's spec gives one
device and the functions take ``mp``, the rank's ``core/zero.ModelAxis``
(None at one model rank: the code above unchanged). Whether a leaf is
split over the model ranks is read from its shape (the rules' divisibility
guard may leave it whole). Under tensor parallelism (``mp.tp``):

  * attention: ``wq`` / ``wo`` hold the rank's ``H/M`` heads; ``wk`` /
    ``wv`` its ``KV/M`` where the KV heads split, else whole, and the rank
    projects only the KV heads its query heads map to (``tp_kv_heads``);
    the input enters through ``mp.enter`` (backward: the all-reduce) and
    ``wo``'s row-parallel partial sums leave through ``mp.join``; a
    cross-attention's memory (``kv_source``) is taken as it comes: the
    caller enters it once (``models/encdec.py``: one all-reduce of every
    layer's partial cotangent);
  * the MLP: ``w_in`` / ``w_gate`` column-parallel, ``w_out`` row-parallel
    with the all-reduce after;
  * the embedding is vocab-parallel: each rank looks up the tokens in its
    rows, zeros the rest, and the ranks' rows are summed (exact: one
    nonzero a position); ``logits`` stay vocab-sharded and ``lm_loss`` is
    the vocab-parallel cross-entropy (max, sum of exponentials, the gold
    logit from its owner, each an all-reduce, the padding masked on global
    vocab ids).

Under context parallelism (``mp.strategy == "cp"``) a rank's activations
are its chunk of the sequence at absolute positions (``mp.seq``; a
prompt that does not split over the ranks runs whole on each,
``mp.whole()``); attention all-gathers K and V along the sequence
(backward: the reduce-scatter). Causal self-attention attends with the
keys cut to the chunk's end, so the flash kernel's end-aligned causal
mask is exactly causal for the chunk; an encoder's (not causal) and a
cross-attention's (``kv_source``: the memory's chunks) attend every
gathered key. The leaves split over model are gathered whole by
the engine before the loss (MoE's experts stay split, ``models/moe.py``).
A decode step's cache may hold the rank's range of positions alone (the
reference's ``cache_seq`` on ``model``): its layer cache then carries
``seq_lo``, the range's first position; the new token's K/V is written by
the rank that owns its position, and each rank's partial softmax over its
valid positions (``decode_partial``) is combined over the model ranks
(``combine_partials``), the reference's flash-decode pattern.

The SSM's and the hybrid's recurrent blocks hold the rank's ``inner``
channels under both strategies (the reference's ``inner`` on ``model``):
the rank's slice computes over the whole sequence and no ``inner`` leaf
moves. ``inner_enter`` gathers a context-parallel rank's chunks into the
sequence (or enters the column-parallel product), ``inner_exit``
reduce-scatters (or joins) the row-parallel output, and
``rms_norm_split`` normalises over the split channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core import partition as pt
from repro_torch.core.tiling import tiled_matmul
from repro_torch.kernels import ops

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm scaled by ``(1 + scale)`` (scale is initialized to zeros)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def rms_norm_split(x: torch.Tensor, scale: torch.Tensor, mp, eps: float = 1e-6) -> torch.Tensor:
    """``rms_norm`` over a last dim split over the model ranks, ``x`` and
    ``scale`` the rank's part of it: the mean of squares is the ranks'
    sums of squares summed (``mp.sum``, whose backward sums the ranks'
    cotangents of it: each rank normalises its own part) over the whole
    dim's length."""
    dt = x.dtype
    x = x.float()
    var = mp.sum(torch.sum(x * x, dim=-1, keepdim=True)) / (x.shape[-1] * mp.size)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(dt)


def norm(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def norm_defs(d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": pt.ParamDef((d,), ("embed",), "float32", "zeros")}
    return {
        "scale": pt.ParamDef((d,), ("embed",), "float32", "ones"),
        "bias": pt.ParamDef((d,), ("embed",), "float32", "zeros"),
    }


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Rotates the
    split halves ``[:half]`` / ``[half:]``, not interleaved pairs."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., :, None].float() * freq  # (..., seq, half)
    angles = angles[..., :, None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attn_defs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "wq": pt.ParamDef((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": pt.ParamDef((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": pt.ParamDef((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": pt.ParamDef((h, hd, d), ("heads", "head_dim", "embed")),
    }


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """One-token attention against a cache: q (B,1,H,D), caches (B,S,KV,D),
    ``cache_len`` the valid prefix length (scalar or per row). Plain torch:
    the reference computes it outside Pallas too."""
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    n_rep = H // KV
    scale = D ** -0.5
    qh = q[:, 0].reshape(B, KV, n_rep, D)
    s = torch.einsum("bknd,bskd->bkns", qh.float(), k_cache.float()) * scale
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1, 1, 1)
    valid = torch.arange(S, device=q.device)[None, None, None, :] < clen
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkns,bskd->bknd", (p / l).to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


def decode_partial(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                   valid) -> tuple:
    """Flash-decode's partial softmax of one-token attention over the
    first ``valid`` positions of a cache (scalar or per row; 0 leaves a
    row empty): the row max ``m``, the sum ``l`` and the unnormalised
    output ``o``, all f32, shapes (B, KV, H/KV, 1) twice and (B, KV, H/KV,
    D). An empty row's ``m`` is ``NEG_INF`` and its ``l`` and ``o`` zero."""
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    qh = q[:, 0].reshape(B, KV, H // KV, D)
    s = torch.einsum("bknd,bskd->bkns", qh.float(), k_cache.float()) * D ** -0.5
    n = torch.as_tensor(valid, device=q.device).reshape(-1, 1, 1, 1)
    mask = torch.arange(S, device=q.device)[None, None, None, :] < n
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkns,bskd->bknd", p, v_cache.float())
    return m, l, o


def combine_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Partials stacked over a leading rank dim -> the normalised output:
    ``m = max m_r``, ``l = sum l_r e^(m_r - m)``, ``o = sum o_r e^(m_r -
    m) / l`` in f32, summed in rank order. An empty rank's weight
    ``e^(NEG_INF - m)`` underflows to zero, so it adds exactly nothing."""
    top = torch.amax(m, dim=0)
    w = torch.exp(m - top)
    return torch.sum(o * w, dim=0) / torch.clamp(torch.sum(l * w, dim=0), min=1e-30)


def decode_attention_split(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           valid, mp) -> torch.Tensor:
    """One-token attention over a cache whose positions are split over the
    model ranks: this rank's ``decode_partial`` over its ``valid`` ones,
    the ranks' partials gathered in one collective and combined on each
    (the same bits on every rank). Plain torch, as the reference's
    combine is XLA's outside Pallas."""
    B, _, H, D = q.shape
    m, l, o = decode_partial(q, k_cache, v_cache, valid)
    parts = mp.stack(torch.cat([m, l, o], dim=-1))
    out = combine_partials(parts[..., :1], parts[..., 1:2], parts[..., 2:])
    return out.reshape(B, 1, H, D).to(q.dtype)


def _scatter_cache(cache: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Write ``new`` (B, S_new, KV, D) at offset ``pos`` (scalar or per row)
    along the seq dim of ``cache`` (B, S, KV, D), IN PLACE, and return it.

    The reference's one-hot form becomes an index write; as there, a
    position at or past capacity is dropped (an idle serving slot keeps
    decoding past its end). No host sync: a dropped row writes back the
    value it would have overwritten.
    """
    B, S = cache.shape[0], cache.shape[1]
    rows = torch.arange(B, device=cache.device)
    pos = torch.as_tensor(pos, device=cache.device).reshape(-1).expand(B)
    new = new.to(cache.dtype)
    for i in range(new.shape[1]):
        idx = pos + i
        keep = (idx < S).view(B, 1, 1)
        idx = idx.clamp(max=S - 1)
        cache[rows, idx] = torch.where(keep, new[:, i], cache[rows, idx])
    return cache


def tp_kv_heads(n_heads: int, n_kv: int, size: int, rank: int) -> tuple:
    """``(lo, hi)``: the KV heads that model rank ``rank``'s ``n_heads /
    size`` query heads map to (query head h reads KV head h // (n_heads /
    n_kv)), where the KV heads do not split over the ``size`` ranks. The
    rank projects and keeps those alone; they must group its query heads
    evenly, as the flash kernel's GQA does (every config here does)."""
    local, rep = n_heads // size, n_heads // n_kv
    lo = rank * local // rep
    reads = [(rank * local + j) // rep - lo for j in range(local)]
    n = reads[-1] + 1
    if local % n or reads != [j // (local // n) for j in range(local)]:
        raise ValueError(f"{n_heads} query heads over {size} model ranks do not group "
                         f"evenly onto {n_kv} KV heads (rank {rank} reads {reads})")
    return lo, lo + n


def attention_block(p: dict, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, *, causal: bool = True, window: int = 0,
                    cache: dict | None = None,
                    kv_source: torch.Tensor | None = None,
                    collect_kv: bool = False, mp=None):
    """qkv proj -> rope -> attention -> out proj.

    With ``kv_source`` (B, Sk, d) — cross-attention to an encoder's memory —
    K and V are projected from it, neither q nor k is rotated, and the
    call is never causal (the reference's ``causal and kv_source is
    None``); Sq may differ from Sk.

    Prefill (``cache`` None) runs ``ops.flash_attention`` over the prompt,
    with the local ``window`` (0: global); with ``collect_kv`` it also
    returns this block's bf16 ``{"k", "v"}``. Decode (``cache`` =
    ``{"k","v","len"}`` with (B, S_cache, KV, D) leaves) writes the new K/V
    into the cache in place and attends with ``decode_attention``. A
    window-bounded ring cache passes the reference's ``write_pos`` (the
    ring slot, ``len % window``) and ``valid_len`` (``min(len + 1,
    window)``), scalars or one per row; otherwise the write lands at
    ``len`` and the first ``len + S`` slots are attended. A cache split
    over the model ranks passes ``seq_lo`` (module docstring): the write
    lands at ``len - seq_lo`` where that is one of the rank's slots and is
    dropped elsewhere, and attention is ``decode_attention_split``.
    Returns ``(out, new_cache_or_collected_kv)``. With ``mp`` (module
    docstring) the heads, the collected K/V and the cache are the rank's.
    """
    B, S, d = x.shape
    D = cfg.resolved_head_dim
    wq, wk, wv, wo = p["wq"], p["wk"], p["wv"], p["wo"]
    tp = mp is not None and mp.tp and wq.shape[1] < cfg.n_heads  # the rank's heads
    cp = mp is not None and mp.seq
    if tp:
        x = mp.enter(x)
        if wk.shape[1] == cfg.n_kv_heads:  # the KV heads do not split: the rank's own
            lo, hi = tp_kv_heads(cfg.n_heads, cfg.n_kv_heads, mp.size, mp.rank)
            wk, wv = wk[:, lo:hi], wv[:, lo:hi]
    H, KV = wq.shape[1], wk.shape[1]
    xs = x if kv_source is None else kv_source
    Sk = xs.shape[1]
    q = (x @ wq.to(x.dtype).reshape(d, H * D)).reshape(B, S, H, D)
    kx = (xs @ wk.to(x.dtype).reshape(d, KV * D)).reshape(B, Sk, KV, D)
    vx = (xs @ wv.to(x.dtype).reshape(d, KV * D)).reshape(B, Sk, KV, D)
    if kv_source is None:  # self-attention: rope at absolute positions
        q = rope(q, positions, cfg.rope_theta)
        kx = rope(kx, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        k_cache, v_cache, clen = cache["k"], cache["v"], cache["len"]
        lo = cache.get("seq_lo")
        if lo is not None:  # the rank's positions [lo, lo + n) of a split cache
            n = k_cache.shape[1]
            local = torch.as_tensor(clen, device=x.device) - lo
            write_pos = torch.where((local >= 0) & (local < n), local, torch.full_like(local, n))
            valid_len = torch.clamp(local + S, 0, n)
        else:
            write_pos = cache.get("write_pos", clen)
            valid_len = cache.get("valid_len", clen + S)
        _scatter_cache(k_cache, kx, write_pos)
        _scatter_cache(v_cache, vx, write_pos)
        new_cache = {"k": k_cache, "v": v_cache, "len": clen + S}
        if lo is not None:
            out = decode_attention_split(q, k_cache, v_cache, valid_len, mp)
        else:
            out = decode_attention(q, k_cache, v_cache, valid_len)
    else:
        ka, va = kx, vx
        if cp:
            # context parallel: every chunk's K/V; causal self-attention cuts
            # them to this chunk's end, an encoder's or a cross-attention's
            # queries attend every gathered key
            ka, va = (mp.gather(t, 1) for t in (kx, vx))
            if causal and kv_source is None:
                end = (mp.rank + 1) * S
                ka, va = ka[:, :end], va[:, :end]
        # (B,S,H,D) storage seen as (B,H,S,D): the kernel takes the strides
        out = ops.flash_attention(q.transpose(1, 2), ka.transpose(1, 2),
                                  va.transpose(1, 2), causal=causal and kv_source is None,
                                  window=window)
        out = out.transpose(1, 2)
        if collect_kv:
            new_cache = {"k": kx.to(torch.bfloat16), "v": vx.to(torch.bfloat16)}
    out = out.to(x.dtype).reshape(B, S, H * D) @ wo.to(x.dtype).reshape(H * D, d)
    if tp:
        out = mp.join(out)
    return out, new_cache


# ---------------------------------------------------------------------------
# Recurrent blocks' inner channels on the model axis
# ---------------------------------------------------------------------------


def inner_enter(x: torch.Tensor, mp, split: bool) -> torch.Tensor:
    """A recurrent block's (normed) input over the whole sequence, the
    block's ``inner`` channels the rank's where ``split``: under context
    parallelism with chunked activations the model ranks' chunks gathered
    along the sequence (backward: the reduce-scatter), whether or not the
    channels split; elsewhere ``mp.enter`` where they split (backward: the
    all-reduce), else ``x`` (the block runs whole)."""
    if mp is None:
        return x
    if mp.seq:
        return mp.gather(x, 1)
    return mp.enter(x) if split else x


def inner_exit(out: torch.Tensor, mp, split: bool) -> torch.Tensor:
    """The block's output from ``inner_enter``'s input: where ``split``,
    the row-parallel partial sums joined (``mp.scatter`` to the rank's
    chunk under context parallelism, else ``mp.join``); a whole block's
    output is every rank's, and under context parallelism its chunk is
    sliced out with no sum."""
    if mp is None:
        return out
    if mp.seq:
        if split:
            return mp.scatter(out, 1)
        n = out.shape[1] // mp.size
        return out[:, mp.rank * n:(mp.rank + 1) * n]
    return mp.join(out) if split else out


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_defs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    defs = {
        "w_in": pt.ParamDef((d, f), ("embed", "mlp")),
        "w_out": pt.ParamDef((f, d), ("mlp", "embed")),
    }
    if cfg.mlp_kind in ("swiglu", "geglu"):
        defs["w_gate"] = pt.ParamDef((d, f), ("embed", "mlp"))
    return defs


def mlp_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
              tiling_factor: int = 1, mp=None) -> torch.Tensor:
    """Every projection goes through the tiled-matmul kernel; a weight
    that arrived in the q8 wire layout (``pt.QWeight``) goes through the
    quantized-matmul kernel as it is, without a cast. Under tensor
    parallelism with the MLP's columns split, ``w_in`` / ``w_gate`` take
    the rank's columns and ``w_out``'s partial sums are all-reduced."""
    kind = cfg.mlp_kind
    split = mp is not None and mp.tp and p["w_in"].shape[-1] < cfg.d_ff
    if split:
        x = mp.enter(x)

    def as_operand(w):
        return w if isinstance(w, pt.QWeight) else w.to(x.dtype)

    def up(w):
        return tiled_matmul(x, as_operand(w), tiling_factor)

    h = up(p["w_in"])
    if kind == "swiglu":
        h = F.silu(up(p["w_gate"])) * h
    elif kind == "geglu":
        h = F.gelu(up(p["w_gate"]), approximate="tanh") * h
    elif kind == "relu2":
        h = torch.square(F.relu(h))
    elif kind == "gelu":
        h = F.gelu(h, approximate="tanh")
    out = tiled_matmul(h, as_operand(p["w_out"]), tiling_factor)
    return mp.join(out) if split else out


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def embed_defs(cfg: ModelConfig) -> dict:
    v = cfg.padded_vocab()
    defs = {"tok": pt.ParamDef((v, cfg.d_model), ("vocab", "embed"), init="normal")}
    if not cfg.tie_embeddings:
        defs["unembed"] = pt.ParamDef((cfg.d_model, v), ("embed", "vocab"))
    return defs


def _vocab_split(table: torch.Tensor, dim: int, cfg: ModelConfig, mp) -> bool:
    """Whether ``table``'s vocab ``dim`` holds the rank's rows alone."""
    return mp is not None and mp.tp and table.shape[dim] < cfg.padded_vocab()


def embed(p: dict, tokens: torch.Tensor, cfg: ModelConfig, mp=None) -> torch.Tensor:
    """The table is cast to bf16 before the gather (gemma scales by √d).
    Vocab-parallel under tensor parallelism: the rank's rows
    ``[rank * V/M, (rank+1) * V/M)`` looked up, zeros elsewhere, summed
    over the model ranks."""
    tok = p["tok"]
    if _vocab_split(tok, 0, cfg, mp):
        n = tok.shape[0]
        ids = tokens.long() - mp.rank * n
        mine = (ids >= 0) & (ids < n)
        x = tok.to(torch.bfloat16)[ids.clamp(0, n - 1)] * mine[..., None].to(torch.bfloat16)
        x = mp.join(x)
    else:
        x = tok.to(torch.bfloat16)[tokens]
    if cfg.arch.startswith("gemma") or cfg.arch.startswith("recurrentgemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def logits(p: dict, x: torch.Tensor, cfg: ModelConfig, mp=None) -> torch.Tensor:
    """Logits over the PADDED vocab (serving's argmax runs over it too);
    under tensor parallelism with the vocab split, the rank's columns
    ``[rank * V/M, (rank+1) * V/M)`` of them."""
    w = p["tok"] if cfg.tie_embeddings else p["unembed"]
    if _vocab_split(w, 0 if cfg.tie_embeddings else 1, cfg, mp):
        x = mp.enter(x)
    if cfg.tie_embeddings:
        out = x @ w.to(x.dtype).T
    else:
        out = x @ w.to(x.dtype)
    if cfg.logit_softcap > 0.0:
        out = torch.tanh(out / cfg.logit_softcap) * cfg.logit_softcap
    return out


def vocab_sharded(p: dict, cfg: ModelConfig, mp) -> bool:
    """Whether ``logits(p, ..., mp)`` gives the rank's vocab columns alone
    (tensor parallelism with the vocab split over the model ranks)."""
    tied = cfg.tie_embeddings
    return _vocab_split(p["tok"] if tied else p["unembed"], 0 if tied else 1, cfg, mp)


def lm_loss(lg: torch.Tensor, labels: torch.Tensor, vocab_size: int, mp=None) -> torch.Tensor:
    """Cross-entropy over the (possibly padded) vocab; labels (B, S) int.
    With ``mp`` the logits are the model rank's vocab columns
    (``vocab_sharded``) and the loss the vocab-parallel form: the max, the
    sum of exponentials and the gold logit each reduced over the model
    ranks, the padding masked on global vocab ids; the same value on every
    model rank."""
    lg = lg.float()
    n = lg.shape[-1]
    lo = 0 if mp is None else mp.rank * n
    if lo + n > vocab_size:
        ids = lo + torch.arange(n, device=lg.device)
        lg = torch.where(ids < vocab_size, lg, torch.full_like(lg, NEG_INF))
    if mp is None:
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
        return torch.mean(logz - gold)
    m = mp.max(torch.amax(lg, dim=-1, keepdim=True))
    logz = torch.log(mp.join(torch.sum(torch.exp(lg - m), dim=-1))) + m[..., 0]
    local = labels.long() - lo
    mine = (local >= 0) & (local < n)
    gold = torch.gather(lg, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = mp.join(torch.where(mine, gold, torch.zeros_like(gold)))
    return torch.mean(logz - gold)
