"""mamba2-370m [ssm] — SSD (state-space duality). [arXiv:2405.21060; unverified]

48L d_model=1024 (attention-free) vocab=50280, ssm_state=128,
expand=2 (d_inner=2048), ssm head_dim=64 -> 32 SSD heads, conv_width=4.
Chunked SSD algorithm (matmul-dominant, TPU-friendly); decode is O(1)
per token so long_500k runs.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    vocab_size=50280,
    mlp_kind="swiglu",  # unused (no MLP block); kept for dataclass completeness
    norm_kind="rmsnorm",
    tie_embeddings=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=64,
    conv_width=4,
)

SMOKE = ModelConfig(
    arch="mamba2-370m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    vocab_size=256,
    norm_kind="rmsnorm",
    tie_embeddings=True,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=16,
    conv_width=4,
)
