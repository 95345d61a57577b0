"""rwkv6-7b (Finch) — attention-free, data-dependent decay [arXiv:2404.05892; hf]."""
from repro_torch.configs.base import ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,              # wkv heads = d_model / head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    head_dim=64,
    act="relu_sq",           # rwkv channel-mix uses squared relu
    tie_embeddings=False,
    norm_eps=1e-5,
    ssm=SSMSpec(state_dim=64, head_dim=64, chunk=128),
    source="arXiv:2404.05892 / hf:RWKV/rwkv-6-world-7b",
)
