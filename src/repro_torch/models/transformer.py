"""Dense decoder-only LM and its VLM backbone variant (the ``dense`` and
``vlm`` families of ``repro/models/transformer.py``).

Blocks are stacked over a leading ``layers`` dim, as in the reference; the
reference's ``lax.scan`` over that dim is a Python loop over layer slices
here. Serving entry points: ``prefill`` builds the ``(L, B, S, KV, D)``
cache from a prompt, ``decode_step`` advances every row one token,
writing the cache IN PLACE (the returned cache holds the same ``k``/``v``
tensors). Training: ``loss`` is the next-token loss over the whole stack
and ``make_block_fn`` the standalone train-mode block the explicit ZeRO-3
engine (``core/zero.py``) calls on one layer's row; both differentiate
through the kernels' ``torch.autograd.Function``s.

The ``vlm`` family (llava-next-34b) is the dense model behind a stub
vision frontend: ``vision_embeds`` (B, vision_len, d_model), precomputed
patch embeddings, take the head of the sequence in front of the token
embeddings (``_merge_vision``); the loss covers the text positions only,
and prefill's ``len`` counts the vision positions, so decode continues
after them.

With a model-parallel context (``mp``, a ``core/zero.ModelAxis``;
``models/common.py``) the bundle computes a model rank's part. Tensor
parallelism: every function as above on the rank's heads, MLP columns and
vocab rows, ``logits`` vocab-sharded, ``loss`` the vocab-parallel
cross-entropy (the same value on every model rank), the cache the rank's
KV heads (``make_cache_defs``). Context parallelism: the rank embeds its chunk ``[m * S/M, (m+1) * S/M)`` of the sequence (a
VLM's merged vision + text sequence, chunked after ``_merge_vision``), at
absolute positions, and ``loss`` returns the chunk's share of the batch's
mean (its tokens' cross-entropy summed over the batch's count), which the
model ranks' sum makes the mean; ``prefill`` keeps the chunk's K/V, and
``decode_step`` attends over a cache whose positions may be split over the
model ranks (``models/common.py``; the serving driver lays it out,
``core/kvcache.decode_positions``).

The MoE family (``models/moe.py``) is this model with its routed experts
in each block's MLP place (``make_fns``' ``ffn``), so every strategy above
serves and trains it too.

``parallel.remat`` shapes ``loss`` as the reference's ``jax.checkpoint``
of each scanned block does (``models/remat.py``): ``full`` runs every
block under ``torch.utils.checkpoint`` (non-reentrant), so backward
recomputes the block, kernels included (the recompute's launches count
like any other); ``dots`` saves the projections' and the MLP's products
and recomputes the rest, flash attention included; ``none`` keeps every
block's activations.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.config import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.core import partition as pt
from repro_torch.models import common as cm
from repro_torch.models import remat as remat_mod

# shape + torch dtype of one model input (the port's ShapeDtypeStruct)
TensorSpec = collections.namedtuple("TensorSpec", ["shape", "dtype"])


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
        "mlp": cm.mlp_defs(cfg),
    })


def param_defs(cfg: ModelConfig) -> dict:
    return {"embed": cm.embed_defs(cfg), "blocks": block_defs(cfg),
            "ln_f": cm.norm_defs(cfg.d_model, cfg.norm_kind)}


def layer_params(blocks, layer: int) -> dict:
    """One layer's params of a stacked subtree: every family's prefill and
    decode step read a layer through this hook. At one rank ``blocks`` is
    the whole stacked leaves and this is their slice (views); on a mesh it
    is the engine's ``LayerShards`` and this the layer's gather of the
    rank's shards (``core/engine.py``)."""
    if isinstance(blocks, dict):
        return pt.tree_map(lambda t: t[layer], blocks)
    return blocks.layer(layer)


def _check_ported(cfg: ModelConfig) -> None:
    # registry.FAMILY_MODULES routes only the dense and vlm families here
    if cfg.window:
        raise NotImplementedError(
            "a local attention window on this family is not wired: none of "
            "its configs sets one (the flash kernels take it; the hybrid "
            "family's attention passes it)")


def _merge_vision(x_tok: torch.Tensor, vision: torch.Tensor) -> torch.Tensor:
    """VLM stub frontend: precomputed patch embeddings occupy the sequence
    head."""
    return torch.cat([vision.to(x_tok.dtype), x_tok], dim=1)


def _block(cfg: ModelConfig, tiles: int, x, blk, positions, cache=None,
           collect_kv=False, mp=None):
    a, new_cache = cm.attention_block(
        blk["attn"], cm.norm(x, blk["ln1"], cfg.norm_kind), positions, cfg,
        causal=True, cache=cache, collect_kv=collect_kv, mp=mp)
    x = x + a
    m = cm.mlp_block(blk["mlp"], cm.norm(x, blk["ln2"], cfg.norm_kind), cfg, tiles, mp=mp)
    return x + m, new_cache


def local_kv_heads(cfg: ModelConfig, mp=None) -> int:
    """The KV heads a rank's attention computes and caches: all at one
    model rank or under context parallelism; under tensor parallelism
    ``KV/M`` where they split, else those its query heads map to."""
    KV = cfg.n_kv_heads
    if mp is None or not mp.tp:
        return KV
    if KV % mp.size == 0:
        return KV // mp.size
    lo, hi = cm.tp_kv_heads(cfg.n_heads, KV, mp.size, mp.rank)
    return hi - lo


def make_cache_defs(cfg: ModelConfig, mp=None):
    """``(batch, cache_len) -> {"k", "v", "len"}`` defs of the per-layer
    K/V cache (the rank's KV heads, ``local_kv_heads``); the MoE family
    shares it, as the reference's does."""

    def cache_defs(batch: int, cache_len: int) -> dict:
        L, KV, D = cfg.n_layers, local_kv_heads(cfg, mp), cfg.resolved_head_dim
        axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
        return {
            "k": pt.ParamDef((L, batch, cache_len, KV, D), axes),
            "v": pt.ParamDef((L, batch, cache_len, KV, D), axes),
            "len": pt.ParamDef((), (), "int32", "zeros"),
        }

    return cache_defs


def make_input_specs(cfg: ModelConfig):
    """``ShapeConfig -> {name: TensorSpec}``: the token (and, training,
    label) inputs of a decoder-only LM; a VLM's ``seq_len`` counts its
    vision positions, given as bf16 ``vision_embeds``."""

    def input_specs(shape: ShapeConfig) -> dict:
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": TensorSpec((B, 1), torch.int32)}
        vlm = cfg.family == "vlm"
        text = S - cfg.vision_len if vlm else S
        if text < 1:
            raise ValueError(f"{cfg.arch}: a sequence of {S} positions leaves no text "
                             f"after the {cfg.vision_len} vision positions")
        specs = {"tokens": TensorSpec((B, text), torch.int32)}
        if vlm:
            specs["vision_embeds"] = TensorSpec((B, cfg.vision_len, cfg.d_model),
                                                torch.bfloat16)
        if shape.kind == "train":
            specs["labels"] = TensorSpec((B, text), torch.int32)
        return specs

    return input_specs


def chunk_embed(params, batch, cfg: ModelConfig, mp):
    """Context parallel: this model rank's chunk ``[lo, hi)`` of the
    (merged) sequence, embedded, its absolute positions and ``(lo, hi,
    vision_len, T)`` for ``chunk_loss``. Every decoder-only family's."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    vl = cfg.vision_len if cfg.family == "vlm" else 0
    S = vl + T
    if S % mp.size:
        raise ValueError(f"context parallelism: a sequence of {S} positions does not "
                         f"split over {mp.size} model ranks")
    lo, hi = mp.rank * (S // mp.size), (mp.rank + 1) * (S // mp.size)
    x = cm.embed(params["embed"], tokens[:, max(lo - vl, 0):max(hi - vl, 0)], cfg)
    if vl:
        x = _merge_vision(x, batch["vision_embeds"][:, min(lo, vl):min(hi, vl)])
    positions = torch.arange(lo, hi, device=x.device)[None, :].expand(B, hi - lo)
    return x, positions, (lo, hi, vl, T)


def chunk_loss(params, x, labels, chunk, cfg: ModelConfig):
    """The chunk's positions that predict a text label (merged position p
    predicts label ``p - vision_len + 1``): their cross-entropy summed over
    the batch's count of such positions, ``B * (T - 1)``, so the model
    ranks' sum is the batch's mean."""
    lo, hi, vl, T = chunk
    a, b = max(lo, vl), min(hi, vl + T - 1)  # merged positions with a label
    # a chunk without a label (a VLM's vision positions) takes the head
    # on none of its positions: its zero gradient still reaches every
    # leaf, so every rank runs the same collectives in the backward
    lg = cm.logits(params["embed"], x[:, max(a - lo, 0):max(b - lo, 0)], cfg)
    if b <= a:
        return lg.float().sum()
    mean = cm.lm_loss(lg, labels[:, a - vl + 1:b - vl + 1], cfg.vocab_size)
    return mean * ((b - a) / (T - 1))


def make_block_fn(cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig()):
    """Standalone ``(x, blk_params, positions) -> x`` block (train mode),
    as ``repro/models/transformer.py:make_block_fn``: the explicit ZeRO-3
    engine calls it on the leaves of one layer's gathered row."""
    _check_ported(cfg)
    tiles = parallel.tiling_factor

    def block(x, blk, positions):
        return _block(cfg, tiles, x, blk, positions)[0]

    return block


def make_fns(cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig(), mp=None,
             ffn=None, stats=None):
    """The family's functions. ``ffn`` (the MoE family's, ``models/moe.py``)
    takes the dense MLP's place in every block: ``ffn(blk, h, mp,
    counts)`` on the block's normed input, returning ``(out,
    routing_counts)`` with ``counts``; ``stats`` then turns the layers'
    stacked counts into the step statistics ``loss_stats`` returns."""
    _check_ported(cfg)
    tiles = parallel.tiling_factor
    remat = parallel.remat
    cp = mp is not None and not mp.tp

    if ffn is None:
        def ffn(blk, h, bmp, counts=False):
            return cm.mlp_block(blk["mlp"], h, cfg, tiles, mp=bmp)

    def block(x, blk, positions, cache=None, collect_kv=False, bmp=mp, counts=False):
        a, new_cache = cm.attention_block(
            blk["attn"], cm.norm(x, blk["ln1"], cfg.norm_kind), positions, cfg,
            causal=True, cache=cache, collect_kv=collect_kv, mp=bmp)
        x = x + a
        m = ffn(blk, cm.norm(x, blk["ln2"], cfg.norm_kind), bmp, counts)
        if counts:
            return x + m[0], m[1]
        return x + m, new_cache

    def backbone_inputs(params, batch):
        x = cm.embed(params["embed"], batch["tokens"], cfg, mp)
        if cfg.family == "vlm":
            x = _merge_vision(x, batch["vision_embeds"])
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        return x, positions

    def seq_len(batch) -> int:
        """The (merged) sequence's positions: a VLM's vision ones too."""
        return (cfg.vision_len if cfg.family == "vlm" else 0) + batch["tokens"].shape[1]

    def train_block(x, blk, positions):
        return block(x, blk, positions)[0]

    def counted_block(x, blk, positions):
        """-> (the block's output, its ``routing_counts``)."""
        return block(x, blk, positions, counts=True)

    def loss_stats_fn(params, batch, reduce=None):
        """Mean next-token cross-entropy over the batch (labels shifted by
        one inside, padded vocab masked); differentiable. Each stacked
        block leaf is unbound once, so its gradient is one stack of the
        layers' gradients (indexing a layer would write a full-size zero
        gradient per layer). Context parallel: this rank's chunk's share
        (module docstring). With ``stats``, ``(loss, aux)``: the layers'
        (L, E + 2) routing counts, summed by ``reduce`` (a mesh's
        all-reduce over the data ranks) before ``stats`` takes the ratios,
        so each rank reports the global batch's statistics."""
        if cp:
            x, positions, chunk = chunk_embed(params, batch, cfg, mp)
        else:
            x, positions = backbone_inputs(params, batch)
        layers = pt.tree_map(lambda t: t.unbind(0), params["blocks"])
        raw = []
        for l in range(cfg.n_layers):
            blk = pt.tree_map(lambda ts: ts[l], layers)
            if stats is None:
                x = remat_mod.remat(remat, train_block, x, blk, positions)
            else:
                x, counts = remat_mod.remat(remat, counted_block, x, blk, positions)
                raw.append(counts)
        x = cm.norm(x, params["ln_f"], cfg.norm_kind)
        if cp:
            loss = chunk_loss(params, x, batch["labels"], chunk, cfg)
        else:
            lg = cm.logits(params["embed"], x, cfg, mp)
            if cfg.family == "vlm":  # the loss covers the text positions only
                lg = lg[:, cfg.vision_len:]
            loss = cm.lm_loss(lg[:, :-1], batch["labels"][:, 1:], cfg.vocab_size,
                              mp if cm.vocab_sharded(params["embed"], cfg, mp) else None)
        if stats is None:
            return loss, {}
        raw = torch.stack(raw).detach()
        return loss, stats(raw if reduce is None else reduce(raw))

    def loss_fn(params, batch):
        return loss_stats_fn(params, batch)[0]

    @torch.no_grad()
    def prefill(params, batch):
        """Forward over the prompt, building the KV cache; returns the last
        position's logits (B, 1, V_padded; the rank's vocab columns where
        they are sharded) and the cache. Context parallel: where the
        prompt splits over the model ranks each runs its chunk and keeps
        its positions' K/V (the cache's ``k`` / ``v`` hold ``len / M``
        positions), and the last position's logits, the last rank's, reach
        every rank; elsewhere every rank runs the whole prompt (the
        reference's divisibility guard) and keeps all of it."""
        chunked = cp and seq_len(batch) % mp.size == 0
        if chunked:
            x, positions, _ = chunk_embed(params, batch, cfg, mp)
        else:
            x, positions = backbone_inputs(params, batch)
        bmp = mp.whole() if cp and not chunked else mp
        ks, vs = [], []
        for l in range(cfg.n_layers):
            x, kv = block(x, layer_params(params["blocks"], l), positions,
                          collect_kv=True, bmp=bmp)
            ks.append(kv["k"])
            vs.append(kv["v"])
        x = cm.norm(x, params["ln_f"], cfg.norm_kind)
        last = mp.stack(x[:, -1:])[-1] if chunked else x[:, -1:]
        lg = cm.logits(params["embed"], last, cfg, mp)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "len": torch.tensor(seq_len(batch), dtype=torch.int32, device=x.device)}
        return lg, cache

    @torch.no_grad()
    def decode_step(params, cache, batch, seq_split: bool = False):
        """One new token per row against the cache; tokens (B, 1). ``len``
        is a scalar (lockstep) or a (B,) vector of per-slot lengths; each
        row's position is its own length. Context parallel with
        ``seq_split``: the cache holds the rank's positions ``[m * n, (m+1)
        * n)`` of every slot (``n`` its seq dim; the reference's
        ``cache_seq`` on ``model``); without, every rank holds them all."""
        x = cm.embed(params["embed"], batch["tokens"], cfg, mp)
        B = x.shape[0]
        clen = cache["len"]
        positions = clen.reshape(-1, 1).expand(B, 1)
        bmp = mp.whole() if cp else mp
        for l in range(cfg.n_layers):
            layer = {"k": cache["k"][l], "v": cache["v"][l], "len": clen}
            if seq_split:
                layer["seq_lo"] = mp.rank * cache["k"].shape[2]
            x, _ = block(x, layer_params(params["blocks"], l), positions, cache=layer, bmp=bmp)
        x = cm.norm(x, params["ln_f"], cfg.norm_kind)
        lg = cm.logits(params["embed"], x, cfg, mp)
        return lg, {"k": cache["k"], "v": cache["v"], "len": clen + 1}

    fns = {
        "loss": loss_fn,
        "prefill": prefill,
        "decode_step": decode_step,
        "cache_defs": make_cache_defs(cfg, mp),
        "input_specs": make_input_specs(cfg),
    }
    if stats is not None:
        fns["loss_stats"] = loss_stats_fn
    return fns
