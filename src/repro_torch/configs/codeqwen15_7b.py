"""codeqwen1.5-7b — dense MHA transformer, qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,           # assigned: GQA kv=32 (i.e. MHA)
    d_ff=13440,
    vocab_size=92416,
    head_dim=128,
    rope_theta=1_000_000.0,
    act="swiglu",
    qkv_bias=True,           # qwen1.5 uses QKV bias
    tie_embeddings=False,
    norm_eps=1e-6,
    source="hf:Qwen/CodeQwen1.5-7B",
)
