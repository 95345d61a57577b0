"""chameleon-34b — early-fusion VLM backbone; VQ image tokens are ordinary
vocab entries, so the backbone is a dense GQA LM [arXiv:2405.09818; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,        # text + VQ image codes (early fusion)
    head_dim=128,
    rope_theta=10_000.0,
    act="swiglu",
    qkv_bias=False,
    qk_norm=True,            # chameleon stabilizes with QK-norm
    tie_embeddings=False,
    norm_eps=1e-5,
    source="arXiv:2405.09818 (backbone only; VQ frontend is a stub per assignment)",
)
