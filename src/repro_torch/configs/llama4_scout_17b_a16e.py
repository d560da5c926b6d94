"""llama4-scout-17b-a16e [moe] — MoE 16 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, head_dim=128.
Every layer MoE (routed top-1 over 16 experts), per assignment spec.
40 heads % 16 != 0 -> context-parallel attention; experts shard 1/chip
over the 16-way model axis (EP).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=500000.0,
    tie_embeddings=False,
    n_experts=16,
    top_k=1,
    capacity_factor=1.25,
)

SMOKE = ModelConfig(
    arch="llama4-scout-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    head_dim=16,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    tie_embeddings=False,
    n_experts=4,
    top_k=1,
    capacity_factor=1.5,
)
