"""llava-next-34b [vlm] — anyres tiling VLM backbone.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[hf:llava-hf/llava-v1.6-mistral-7b-hf scaled to 34B; unverified]

Backbone only per assignment: the vision frontend is a stub —
``input_specs`` provides precomputed anyres patch embeddings (vision_len
positions of d_model) that replace the head of the token sequence.

56 heads % 16 != 0 -> attention uses context parallelism on the fixed
(data=16, model=16) mesh (see DESIGN.md §3).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    vision_len=2880,  # anyres: 5 tiles x 576 patches
)

SMOKE = ModelConfig(
    arch="llava-next-34b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,  # %16 != 0 in full config; smoke keeps GQA ratio 56:8 -> 4:2? use 4:1
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    tie_embeddings=False,
    vision_len=8,
)
