"""llama3.2-3b [dense] — small llama3. [hf:meta-llama/Llama-3.2-1B (3B row); unverified]

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256, head_dim=128,
rope_theta=500k. 24 heads % 16 != 0 -> context-parallel attention.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=128,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=500000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch="llama3.2-3b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    head_dim=16,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=500000.0,
    tie_embeddings=True,
)
