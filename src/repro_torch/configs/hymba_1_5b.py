"""hymba-1.5b — hybrid: parallel attention + mamba heads [arXiv:2411.13676; hf]."""
from repro_torch.configs.base import ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    rope_theta=10_000.0,
    act="swiglu",
    qkv_bias=False,
    tie_embeddings=True,
    norm_eps=1e-5,
    ssm=SSMSpec(state_dim=16, conv_dim=4, expand=2, chunk=128),
    source="arXiv:2411.13676 (parallel attn+mamba heads; meta-tokens omitted, "
           "learned scalar branch gate — see DESIGN.md §Arch-applicability)",
)
