"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 rec.
[arXiv:2402.19427 (Griffin); unverified]

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, head_dim=256,
local attention window 2048, lru_width=4096, block pattern (rec, rec, attn).
Sub-quadratic: RG-LRU state is O(1), local-attn KV is window-bounded ->
long_500k runs. RG-LRU trained with a log-depth associative scan.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    window=2048,
    lru_width=4096,
    block_pattern=("rec", "rec", "attn"),
    conv_width=4,
)

SMOKE = ModelConfig(
    arch="recurrentgemma-9b-smoke",
    family="hybrid",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=192,
    vocab_size=256,
    head_dim=16,
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    tie_embeddings=True,
    window=32,
    lru_width=64,
    block_pattern=("rec", "rec", "attn"),
    conv_width=4,
)
