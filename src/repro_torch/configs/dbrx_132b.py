"""dbrx-132b — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base; unverified]."""
from repro_torch.configs.base import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,              # per-expert hidden size
    vocab_size=100352,
    head_dim=128,
    rope_theta=500_000.0,
    act="swiglu",
    qkv_bias=False,
    tie_embeddings=False,
    norm_eps=1e-5,
    moe=MoESpec(n_experts=16, top_k=4, d_ff_expert=10752,
                n_shared=0, d_ff_shared=0, capacity_factor=1.25),
    source="hf:databricks/dbrx-base (assigned dims; unverified tier)",
)
