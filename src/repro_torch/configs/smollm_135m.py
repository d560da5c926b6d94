"""smollm-135m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152, head_dim=64.
9 heads % 16 != 0 -> context-parallel attention on the production mesh;
the model axis still tensor-shards d_ff (1536/16=96) and vocab.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    head_dim=64,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch="smollm-135m-smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=3,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=128,
    head_dim=16,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    tie_embeddings=True,
)
