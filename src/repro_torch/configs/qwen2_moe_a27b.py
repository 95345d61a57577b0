"""qwen2-moe-a2.7b — 60 routed experts top-4 + 4 shared [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""
from repro_torch.configs.base import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,               # fine-grained per-expert hidden size
    vocab_size=151936,
    head_dim=128,
    rope_theta=1_000_000.0,
    act="swiglu",
    qkv_bias=True,
    tie_embeddings=False,
    norm_eps=1e-6,
    moe=MoESpec(n_experts=60, top_k=4, d_ff_expert=1408,
                n_shared=4, d_ff_shared=5632,  # 4 shared experts fused: 4×1408
                capacity_factor=1.25),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
