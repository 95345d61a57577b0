"""glm4-9b — dense GQA transformer [hf:THUDM/glm-4-9b; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    head_dim=128,
    rope_theta=10_000.0,
    partial_rotary=0.5,      # GLM rotates half the head dim
    act="swiglu",
    qkv_bias=True,           # GLM-4 keeps bias on QKV projections
    tie_embeddings=False,
    norm_eps=1.5625e-7,
    source="hf:THUDM/glm-4-9b",
)
