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

With a model-parallel context (``mp``, a ``core/zero.ModelAxis``;
``models/common.py``) the bundle computes a model rank's part. Tensor
parallelism: every attention and MLP on the rank's heads and columns,
the memory entered into the model axis once after ``ln_enc`` (its
cotangent summed over the model ranks in one all-reduce, for all the
cross-attentions), the embedding, logits and loss vocab-parallel, the
cache the rank's KV heads (``xk``/``xv`` too). Context parallelism: the
rank takes its chunk of the frames and of the decoder tokens (both must
split over the model ranks; a prompt where either does not runs whole on
every rank, ``mp.whole()``) at absolute positions (RoPE in both stacks);
the encoder's and the cross-attention's keys are every rank's chunks
gathered, uncut; ``loss`` returns the chunk's share of the mean. A
decode cache split over the model ranks (``kvcache.decode_positions``)
holds the rank's range of the decoder's positions and of the memory's,
and both attentions combine the ranks' partial softmaxes.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.config import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.core import partition as pt
from repro_torch.models import common as cm
from repro_torch.models import remat as remat_mod
from repro_torch.models.mamba2 import _stack
from repro_torch.models.transformer import (TensorSpec, chunk_loss, layer_params,
                                            local_kv_heads)


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


def _positions(x: torch.Tensor, lo: int = 0) -> torch.Tensor:
    """Absolute positions ``[lo, lo + S)`` of every row of ``x`` (B, S, d):
    a context-parallel rank's chunk starts at ``lo``."""
    B, S, _ = x.shape
    return torch.arange(lo, lo + S, device=x.device)[None, :].expand(B, S)


def _chunks(n_frames: int, n_tokens: int, mp) -> tuple:
    """Context parallel: this model rank's ``(frame lo, frame hi)`` and
    ``(token lo, token hi)`` of a sequence of ``n_frames`` frames and
    ``n_tokens`` decoder tokens, or None where either length does not
    split over the model ranks."""
    M = mp.size
    if n_frames % M or n_tokens % M:
        return None
    fe, ft = n_frames // M, n_tokens // M
    return (mp.rank * fe, (mp.rank + 1) * fe), (mp.rank * ft, (mp.rank + 1) * ft)


def make_fns(cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig(), mp=None):
    remat = parallel.remat
    tiles = parallel.tiling_factor
    kind = cfg.norm_kind
    cp = mp is not None and not mp.tp

    def enc_block(h, blk, positions, bmp=mp):
        a, _ = cm.attention_block(blk["attn"], cm.norm(h, blk["ln1"], kind), positions, cfg,
                                  causal=False, mp=bmp)
        h = h + a
        return h + cm.mlp_block(blk["mlp"], cm.norm(h, blk["ln2"], kind), cfg, tiles, mp=bmp)

    def enc_forward(params, frames, serving=False, lo=0, bmp=mp):
        """The encoder stack over ``frames`` (a context-parallel rank's
        chunk from position ``lo``); training unbinds each stacked leaf
        once (as the decoder's loss), serving reads a layer through
        ``layer_params`` (a mesh's per-layer gather). Under tensor
        parallelism the memory enters the model axis here, once: every
        cross-attention projects its rank's heads of K/V from it, and the
        backward's one all-reduce sums their partial cotangents."""
        x = frames.to(torch.bfloat16)
        positions = _positions(x, lo)
        block = functools.partial(enc_block, bmp=bmp)
        layers = None if serving else pt.tree_map(lambda t: t.unbind(0), params["enc"])
        for l in range(cfg.n_enc_layers):
            blk = (layer_params(params["enc"], l) if serving
                   else pt.tree_map(lambda ts: ts[l], layers))
            x = remat_mod.remat(remat, block, x, blk, positions)
        memory = cm.norm(x, params["ln_enc"], kind)
        return bmp.enter(memory) if bmp is not None and bmp.tp else memory

    def dec_block(h, blk, positions, memory, self_cache=None, cross_kv=None,
                  collect_kv=False, bmp=mp):
        """One decoder block; returns (h, self-attention cache or collected
        k/v, collected cross k/v). ``cross_kv`` (decode) holds the cached
        memory keys and values (with ``split``, the rank's range of the
        memory's positions: flash-decode's combine over the model ranks);
        otherwise ``memory`` is attended through
        ``attention_block(kv_source=...)``."""
        a, new_self = cm.attention_block(
            blk["self_attn"], cm.norm(h, blk["ln1"], kind), positions, cfg, causal=True,
            cache=self_cache, collect_kv=collect_kv, mp=bmp)
        h = h + a
        xn = cm.norm(h, blk["ln_x"], kind)
        cross = None
        if cross_kv is not None:  # decode: attend to the cached memory K/V
            B, S, d = xn.shape
            p = blk["cross_attn"]
            H, D = p["wq"].shape[1], cfg.resolved_head_dim  # the rank's heads
            q = (xn @ p["wq"].to(xn.dtype).reshape(d, H * D)).reshape(B, S, H, D)
            k, v = cross_kv["k"], cross_kv["v"]
            if cross_kv.get("split"):
                o = cm.decode_attention_split(q, k, v, k.shape[1], bmp)
            else:
                o = cm.decode_attention(q, k, v, k.shape[1])
            c = o.to(xn.dtype).reshape(B, S, H * D) @ p["wo"].to(xn.dtype).reshape(H * D, d)
            if bmp is not None and bmp.tp and H < cfg.n_heads:
                c = bmp.join(c)
        else:
            # prefill collects the memory's K/V here: the reference's separate
            # projection of the memory by wk/wv, cast to bf16
            c, cross = cm.attention_block(blk["cross_attn"], xn, positions, cfg,
                                          causal=False, kv_source=memory,
                                          collect_kv=collect_kv, mp=bmp)
        h = h + c
        h = h + cm.mlp_block(blk["mlp"], cm.norm(h, blk["ln2"], kind), cfg, tiles, mp=bmp)
        return h, new_self, cross

    # ------------------------------ train ---------------------------------

    def train_dec_block(h, blk, positions, memory):
        return dec_block(h, blk, positions, memory)[0]

    def loss_fn(params, batch):
        """Mean next-token cross-entropy of the decoder over the encoded
        frames; differentiable. Each stacked leaf is unbound once, as in
        the dense family. Tensor parallel: the vocab-parallel loss (the
        same value on every model rank). Context parallel: the rank's
        chunks of the frames and of the tokens at absolute positions, its
        chunk's share of the mean (``transformer.chunk_loss``); both
        lengths must split over the model ranks."""
        frames, tokens = batch["frames"], batch["tokens"]
        flo = lo = 0
        if cp:
            chunks = _chunks(frames.shape[1], tokens.shape[1], mp)
            if chunks is None:
                raise ValueError(
                    f"context parallelism: {frames.shape[1]} frames and {tokens.shape[1]} "
                    f"decoder tokens must both split over {mp.size} model ranks")
            (flo, fhi), (lo, hi) = chunks
            frames, tokens = frames[:, flo:fhi], tokens[:, lo:hi]
        memory = enc_forward(params, frames, lo=flo)
        x = cm.embed(params["embed"], tokens, cfg, mp)
        positions = _positions(x, lo)
        layers = pt.tree_map(lambda t: t.unbind(0), params["dec"])
        for l in range(cfg.n_dec_layers):
            blk = pt.tree_map(lambda ts: ts[l], layers)
            x = remat_mod.remat(remat, train_dec_block, x, blk, positions, memory)
        x = cm.norm(x, params["ln_f"], kind)
        if cp:
            T = batch["tokens"].shape[1]
            return chunk_loss(params, x, batch["labels"], (lo, hi, 0, T), cfg)
        lg = cm.logits(params["embed"], x, cfg, mp)
        return cm.lm_loss(lg[:, :-1], batch["labels"][:, 1:], cfg.vocab_size,
                          mp if cm.vocab_sharded(params["embed"], cfg, mp) else None)

    # ----------------------------- serving --------------------------------

    def cache_defs(batch: int, cache_len: int) -> dict:
        """The reference's, the K/V heads the rank's
        (``transformer.local_kv_heads``)."""
        L, KV, D = cfg.n_dec_layers, local_kv_heads(cfg, mp), cfg.resolved_head_dim
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
        last position's logits (B, 1, V_padded; the rank's vocab columns
        where they are sharded) and the cache: ``k``/``v`` (L, B, S_dec,
        KV, D), ``xk``/``xv`` (L, B, S_enc, KV, D), ``len`` = S_dec.
        Context parallel: where both the frames and the tokens split over
        the model ranks, each rank runs its chunks and keeps their K/V
        (``len / M`` decoder and ``S_enc / M`` memory positions; the last
        position's logits, the last rank's, reach every rank); elsewhere
        every rank runs the whole prompt and keeps all of it."""
        frames, tokens = batch["frames"], batch["tokens"]
        T = tokens.shape[1]
        chunks = _chunks(frames.shape[1], T, mp) if cp else None
        bmp = mp.whole() if cp and chunks is None else mp
        flo = lo = 0
        if chunks is not None:
            (flo, fhi), (lo, hi) = chunks
            frames, tokens = frames[:, flo:fhi], tokens[:, lo:hi]
        memory = enc_forward(params, frames, serving=True, lo=flo, bmp=bmp)
        x = cm.embed(params["embed"], tokens, cfg, mp)
        positions = _positions(x, lo)
        kv = {"k": [], "v": [], "xk": [], "xv": []}
        for l in range(cfg.n_dec_layers):
            x, own, cross = dec_block(x, layer_params(params["dec"], l), positions, memory,
                                      collect_kv=True, bmp=bmp)
            for name, t in (("k", own["k"]), ("v", own["v"]),
                            ("xk", cross["k"]), ("xv", cross["v"])):
                kv[name].append(t)
        x = cm.norm(x, params["ln_f"], kind)
        last = mp.stack(x[:, -1:])[-1] if chunks is not None else x[:, -1:]
        lg = cm.logits(params["embed"], last, cfg, mp)
        cache = {name: torch.stack(ts) for name, ts in kv.items()}
        cache["len"] = torch.tensor(T, dtype=torch.int32, device=x.device)
        return lg, cache

    @torch.no_grad()
    def decode_step(params, cache, batch, seq_split: bool = False):
        """One new token per row; ``len`` a scalar or one per row. The
        self-attention cache is written in place. Context parallel with
        ``seq_split``: the cache holds the rank's range of the decoder's
        positions and of the memory's (``kvcache.decode_positions``)."""
        x = cm.embed(params["embed"], batch["tokens"], cfg, mp)
        B = x.shape[0]
        clen = cache["len"]
        positions = clen.reshape(-1, 1).expand(B, 1)
        bmp = mp.whole() if cp else mp
        for l in range(cfg.n_dec_layers):
            own = {"k": cache["k"][l], "v": cache["v"][l], "len": clen}
            cross = {"k": cache["xk"][l], "v": cache["xv"][l], "split": seq_split}
            if seq_split:
                own["seq_lo"] = mp.rank * cache["k"].shape[2]
            x, _, _ = dec_block(x, layer_params(params["dec"], l), positions, None,
                                self_cache=own, cross_kv=cross, bmp=bmp)
        x = cm.norm(x, params["ln_f"], kind)
        lg = cm.logits(params["embed"], x, cfg, mp)
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
