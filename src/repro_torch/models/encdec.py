"""Seamless-M4T-medium backbone: an encoder-decoder transformer (the
``encdec`` family of ``repro/models/encdec.py``).

The speech frontend is a stub, as in the reference: ``input_specs`` gives
precomputed frame embeddings (B, S_enc, d_model). 12 encoder layers
(bidirectional self-attention) and 12 decoder layers (causal
self-attention, then cross-attention to the encoder's memory). A train or
prefill shape of ``seq_len`` gives the encoder ``seq_len`` frames and the
decoder ``seq_len // 4`` tokens (``dec_lens``).

Attention goes through ``cm.attention_block``: the encoder's not causal
(flash with Sq = Sk), the cross-attention with ``kv_source`` (no RoPE, not
causal, flash with Sq = Sk / 4 on the card), the decoder's self-attention
causal; the MLPs through the tiled-matmul kernel. The reference's
``lax.scan`` over each stack is a Python loop over layer slices; each
encoder and each decoder block runs under ``parallel.remat``
(``models/remat.py``).

Serving: ``prefill`` returns the decoder's self-attention ``k``/``v`` and
the cross-attention keys and values ``xk``/``xv`` projected from the
memory (no norm, no RoPE); ``decode_step`` projects the new token's query
with ``wq`` only and attends the cached ``xk``/``xv`` over their whole
length, writing ``k``/``v`` IN PLACE. ``cache_defs`` is the reference's,
``xk``/``xv`` sized at ``cache_len // 4`` (a property of the reference:
serving holds them at the encoder's length).
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.core import partition as pt
from repro_torch.models import common as cm
from repro_torch.models import remat as remat_mod
from repro_torch.models.mamba2 import _stack
from repro_torch.models.transformer import TensorSpec, layer_params


def param_defs(cfg: ModelConfig) -> dict:
    norm = lambda: cm.norm_defs(cfg.d_model, cfg.norm_kind)  # noqa: E731
    enc_block = {"ln1": norm(), "attn": cm.attn_defs(cfg), "ln2": norm(),
                 "mlp": cm.mlp_defs(cfg)}
    dec_block = {"ln1": norm(), "self_attn": cm.attn_defs(cfg), "ln_x": norm(),
                 "cross_attn": cm.attn_defs(cfg), "ln2": norm(), "mlp": cm.mlp_defs(cfg)}
    return {
        "embed": cm.embed_defs(cfg),
        "enc": _stack(enc_block, cfg.n_enc_layers),
        "dec": _stack(dec_block, cfg.n_dec_layers),
        "ln_enc": norm(),
        "ln_f": norm(),
    }


def dec_lens(shape: ShapeConfig) -> tuple[int, int]:
    """(enc_len, dec_len) of a shape."""
    if shape.kind == "decode":
        return shape.seq_len // 4, shape.seq_len
    return shape.seq_len, max(shape.seq_len // 4, 1)


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    return torch.arange(S, device=x.device)[None, :].expand(B, S)


def make_fns(cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig()):
    remat = parallel.remat
    tiles = parallel.tiling_factor
    kind = cfg.norm_kind

    def enc_block(h, blk, positions):
        a, _ = cm.attention_block(blk["attn"], cm.norm(h, blk["ln1"], kind), positions, cfg,
                                  causal=False)
        h = h + a
        return h + cm.mlp_block(blk["mlp"], cm.norm(h, blk["ln2"], kind), cfg, tiles)

    def enc_forward(params, frames, serving=False):
        """The encoder stack; training unbinds each stacked leaf once (as
        the decoder's loss), serving reads a layer through
        ``layer_params`` (a mesh's per-layer gather)."""
        x = frames.to(torch.bfloat16)
        positions = _positions(x)
        layers = None if serving else pt.tree_map(lambda t: t.unbind(0), params["enc"])
        for l in range(cfg.n_enc_layers):
            blk = (layer_params(params["enc"], l) if serving
                   else pt.tree_map(lambda ts: ts[l], layers))
            x = remat_mod.remat(remat, enc_block, x, blk, positions)
        return cm.norm(x, params["ln_enc"], kind)

    def dec_block(h, blk, positions, memory, self_cache=None, cross_kv=None,
                  collect_kv=False):
        """One decoder block; returns (h, self-attention cache or collected
        k/v, collected cross k/v). ``cross_kv`` (decode) holds the cached
        memory keys and values; otherwise ``memory`` is attended through
        ``attention_block(kv_source=...)``."""
        a, new_self = cm.attention_block(
            blk["self_attn"], cm.norm(h, blk["ln1"], kind), positions, cfg, causal=True,
            cache=self_cache, collect_kv=collect_kv)
        h = h + a
        xn = cm.norm(h, blk["ln_x"], kind)
        cross = None
        if cross_kv is not None:  # decode: attend to the cached memory K/V
            B, S, d = xn.shape
            H, D = cfg.n_heads, cfg.resolved_head_dim
            p = blk["cross_attn"]
            q = (xn @ p["wq"].to(xn.dtype).reshape(d, H * D)).reshape(B, S, H, D)
            o = cm.decode_attention(q, cross_kv["k"], cross_kv["v"], cross_kv["k"].shape[1])
            c = o.to(xn.dtype).reshape(B, S, H * D) @ p["wo"].to(xn.dtype).reshape(H * D, d)
        else:
            # prefill collects the memory's K/V here: the reference's separate
            # projection of the memory by wk/wv, cast to bf16
            c, cross = cm.attention_block(blk["cross_attn"], xn, positions, cfg,
                                          causal=False, kv_source=memory,
                                          collect_kv=collect_kv)
        h = h + c
        h = h + cm.mlp_block(blk["mlp"], cm.norm(h, blk["ln2"], kind), cfg, tiles)
        return h, new_self, cross

    # ------------------------------ train ---------------------------------

    def train_dec_block(h, blk, positions, memory):
        return dec_block(h, blk, positions, memory)[0]

    def loss_fn(params, batch):
        """Mean next-token cross-entropy of the decoder over the encoded
        frames; differentiable. Each stacked leaf is unbound once, as in
        the dense family."""
        memory = enc_forward(params, batch["frames"])
        x = cm.embed(params["embed"], batch["tokens"], cfg)
        positions = _positions(x)
        layers = pt.tree_map(lambda t: t.unbind(0), params["dec"])
        for l in range(cfg.n_dec_layers):
            blk = pt.tree_map(lambda ts: ts[l], layers)
            x = remat_mod.remat(remat, train_dec_block, x, blk, positions, memory)
        x = cm.norm(x, params["ln_f"], kind)
        lg = cm.logits(params["embed"], x, cfg)
        return cm.lm_loss(lg[:, :-1], batch["labels"][:, 1:], cfg.vocab_size)

    # ----------------------------- serving --------------------------------

    def cache_defs(batch: int, cache_len: int) -> dict:
        L, KV, D = cfg.n_dec_layers, cfg.n_kv_heads, cfg.resolved_head_dim
        enc_len = max(cache_len // 4, 1)
        axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
        return {
            "k": pt.ParamDef((L, batch, cache_len, KV, D), axes),
            "v": pt.ParamDef((L, batch, cache_len, KV, D), axes),
            "xk": pt.ParamDef((L, batch, enc_len, KV, D), axes),
            "xv": pt.ParamDef((L, batch, enc_len, KV, D), axes),
            "len": pt.ParamDef((), (), "int32", "zeros"),
        }

    @torch.no_grad()
    def prefill(params, batch):
        """Encode the frames, run the decoder over its prompt; returns the
        last position's logits (B, 1, V_padded) and the cache: ``k``/``v``
        (L, B, S_dec, KV, D), ``xk``/``xv`` (L, B, S_enc, KV, D), ``len``
        = S_dec."""
        memory = enc_forward(params, batch["frames"], serving=True)
        x = cm.embed(params["embed"], batch["tokens"], cfg)
        positions = _positions(x)
        kv = {"k": [], "v": [], "xk": [], "xv": []}
        for l in range(cfg.n_dec_layers):
            x, own, cross = dec_block(x, layer_params(params["dec"], l), positions, memory,
                                      collect_kv=True)
            for name, t in (("k", own["k"]), ("v", own["v"]),
                            ("xk", cross["k"]), ("xv", cross["v"])):
                kv[name].append(t)
        x = cm.norm(x, params["ln_f"], kind)
        lg = cm.logits(params["embed"], x[:, -1:], cfg)
        cache = {name: torch.stack(ts) for name, ts in kv.items()}
        cache["len"] = torch.tensor(x.shape[1], dtype=torch.int32, device=x.device)
        return lg, cache

    @torch.no_grad()
    def decode_step(params, cache, batch):
        """One new token per row; ``len`` a scalar or one per row. The
        self-attention cache is written in place."""
        x = cm.embed(params["embed"], batch["tokens"], cfg)
        B = x.shape[0]
        clen = cache["len"]
        positions = clen.reshape(-1, 1).expand(B, 1)
        for l in range(cfg.n_dec_layers):
            x, _, _ = dec_block(
                x, layer_params(params["dec"], l), positions, None,
                self_cache={"k": cache["k"][l], "v": cache["v"][l], "len": clen},
                cross_kv={"k": cache["xk"][l], "v": cache["xv"][l]})
        x = cm.norm(x, params["ln_f"], kind)
        lg = cm.logits(params["embed"], x, cfg)
        return lg, {"k": cache["k"], "v": cache["v"], "xk": cache["xk"],
                    "xv": cache["xv"], "len": clen + 1}

    def input_specs(shape: ShapeConfig) -> dict:
        B = shape.global_batch
        enc_len, dec_len = dec_lens(shape)
        if shape.kind == "decode":
            return {"tokens": TensorSpec((B, 1), torch.int32)}
        specs = {"frames": TensorSpec((B, enc_len, cfg.d_model), torch.bfloat16),
                 "tokens": TensorSpec((B, dec_len), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = TensorSpec((B, dec_len), torch.int32)
        return specs

    return {
        "loss": loss_fn,
        "prefill": prefill,
        "decode_step": decode_step,
        "cache_defs": cache_defs,
        "input_specs": input_specs,
    }
