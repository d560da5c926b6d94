"""Shared model layers: norms, RoPE, attention, MLP, embeddings, logits.

The PyTorch counterpart of ``repro/models/common.py`` for one device. The
layouts at every public function are the JAX package's: activations
``(B, S, d)``, attention heads ``(B, S, H, D)``, caches ``(B, S, KV, D)``.
Prefill attention goes through ``kernels.ops.flash_attention`` (the CUDA
kernel on the card) and the MLP projections through
``core.tiling.tiled_matmul``; the QKV/O projections, the tied logits and
one-token decode attention are plain torch, as the reference leaves them
to XLA outside Pallas. Sharding annotations have no counterpart here.
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


def attention_block(p: dict, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, *, causal: bool = True, window: int = 0,
                    cache: dict | None = None,
                    kv_source: torch.Tensor | None = None,
                    collect_kv: bool = False):
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
    ``len`` and the first ``len + S`` slots are attended. Returns ``(out,
    new_cache_or_collected_kv)``.
    """
    B, S, d = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    xs = x if kv_source is None else kv_source
    Sk = xs.shape[1]
    q = (x @ p["wq"].to(x.dtype).reshape(d, H * D)).reshape(B, S, H, D)
    kx = (xs @ p["wk"].to(x.dtype).reshape(d, KV * D)).reshape(B, Sk, KV, D)
    vx = (xs @ p["wv"].to(x.dtype).reshape(d, KV * D)).reshape(B, Sk, KV, D)
    if kv_source is None:  # self-attention: rope at absolute positions
        q = rope(q, positions, cfg.rope_theta)
        kx = rope(kx, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        k_cache, v_cache, clen = cache["k"], cache["v"], cache["len"]
        write_pos = cache.get("write_pos", clen)
        valid_len = cache.get("valid_len", clen + S)
        _scatter_cache(k_cache, kx, write_pos)
        _scatter_cache(v_cache, vx, write_pos)
        new_cache = {"k": k_cache, "v": v_cache, "len": clen + S}
        out = decode_attention(q, k_cache, v_cache, valid_len)
    else:
        # (B,S,H,D) storage seen as (B,H,S,D): the kernel takes the strides
        out = ops.flash_attention(q.transpose(1, 2), kx.transpose(1, 2),
                                  vx.transpose(1, 2), causal=causal and kv_source is None,
                                  window=window)
        out = out.transpose(1, 2)
        if collect_kv:
            new_cache = {"k": kx.to(torch.bfloat16), "v": vx.to(torch.bfloat16)}
    out = out.to(x.dtype).reshape(B, S, H * D) @ p["wo"].to(x.dtype).reshape(H * D, d)
    return out, new_cache


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
              tiling_factor: int = 1) -> torch.Tensor:
    """Every projection goes through the tiled-matmul kernel; a weight
    that arrived in the q8 wire layout (``pt.QWeight``) goes through the
    quantized-matmul kernel as it is, without a cast."""
    kind = cfg.mlp_kind

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
    return tiled_matmul(h, as_operand(p["w_out"]), tiling_factor)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def embed_defs(cfg: ModelConfig) -> dict:
    v = cfg.padded_vocab()
    defs = {"tok": pt.ParamDef((v, cfg.d_model), ("vocab", "embed"), init="normal")}
    if not cfg.tie_embeddings:
        defs["unembed"] = pt.ParamDef((cfg.d_model, v), ("embed", "vocab"))
    return defs


def embed(p: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The table is cast to bf16 before the gather (gemma scales by √d)."""
    x = p["tok"].to(torch.bfloat16)[tokens]
    if cfg.arch.startswith("gemma") or cfg.arch.startswith("recurrentgemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def logits(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits over the PADDED vocab (serving's argmax runs over it too)."""
    if cfg.tie_embeddings:
        out = x @ p["tok"].to(x.dtype).T
    else:
        out = x @ p["unembed"].to(x.dtype)
    if cfg.logit_softcap > 0.0:
        out = torch.tanh(out / cfg.logit_softcap) * cfg.logit_softcap
    return out


def lm_loss(lg: torch.Tensor, labels: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Cross-entropy over the (possibly padded) vocab; labels (B, S) int."""
    lg = lg.float()
    pad = lg.shape[-1] - vocab_size
    if pad > 0:
        mask = torch.arange(lg.shape[-1], device=lg.device) < vocab_size
        lg = torch.where(mask, lg, torch.full_like(lg, NEG_INF))
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)
