"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP. [arXiv:2402.16819; unverified]

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000, head_dim=192.
LayerNorm, no gated MLP (squared ReLU), untied embeddings, no rope scaling.
96 heads % 16 == 0 -> TP-heads attention. The d_ff=73728 linear is the
memory-centric-tiling showcase (per-TP-shard W ~ 18432x4608 bf16 = 162 MiB).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    head_dim=192,
    mlp_kind="relu2",
    norm_kind="layernorm",
    rope_theta=10000.0,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    arch="nemotron-4-340b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=256,
    head_dim=8,
    mlp_kind="relu2",
    norm_kind="layernorm",
    tie_embeddings=False,
)
