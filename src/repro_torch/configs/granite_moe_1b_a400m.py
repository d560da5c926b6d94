"""granite-moe-1b-a400m [moe] — 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

24L d_model=1024 16H (GQA kv=8) d_ff=512(per expert) vocab=49155,
MoE 32e top-8, head_dim=64. 16 heads % 16 == 0 -> TP-heads.
vocab 49155 is not divisible by 16: padded to a multiple of 2048
(-> 51200) for TP sharding; logits are sliced back to 49155.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    n_experts=32,
    top_k=8,
    capacity_factor=1.25,
)

SMOKE = ModelConfig(
    arch="granite-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab_size=131,  # deliberately non-divisible to exercise vocab padding
    head_dim=16,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    tie_embeddings=True,
    n_experts=8,
    top_k=2,
    capacity_factor=1.5,
)
