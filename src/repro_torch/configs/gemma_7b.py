"""gemma-7b [dense] — GeGLU, head_dim=256. [arXiv:2403.08295; hf]

28L d_model=3072 16H (kv=16, i.e. MHA at 7B; MQA on the 2b variant)
d_ff=24576 vocab=256000. 16 heads % 16 == 0 -> TP-heads attention.
Gemma details kept: embedding scaled by sqrt(d_model), GeGLU MLP.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch="gemma-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab_size=256,
    head_dim=16,
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    tie_embeddings=True,
)
