"""stablelm-3b — dense transformer [hf:stabilityai/stablelm-2-1_6b; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    head_dim=80,
    rope_theta=10_000.0,
    partial_rotary=0.25,     # stablelm rotates a quarter of head_dim
    act="swiglu",
    qkv_bias=False,
    tie_embeddings=False,
    norm_eps=1e-5,
    source="hf:stabilityai/stablelm-2-1_6b (assigned dims; unverified tier)",
)
