"""seamless-m4t-medium [audio] — enc-dec multimodal backbone.
[arXiv:2308.11596; hf]

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206 — transformer backbone
only; the speech frontend is a stub (``input_specs`` provides precomputed
frame embeddings). Split 12 enc + 12 dec. 16 heads -> TP-heads attention.
vocab 256206 padded to TP-aligned multiple. Per-cell seq split: encoder gets
seq_len frames, decoder seq_len // 4 tokens (speech:text length ratio).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch="seamless-m4t-medium",
    family="encdec",
    n_layers=24,  # 12 enc + 12 dec
    n_enc_layers=12,
    n_dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    mlp_kind="gelu",
    norm_kind="layernorm",
    rope_theta=10000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch="seamless-m4t-smoke",
    family="encdec",
    n_layers=4,
    n_enc_layers=2,
    n_dec_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=250,
    head_dim=16,
    mlp_kind="gelu",
    norm_kind="layernorm",
    tie_embeddings=True,
)
