"""whisper-medium — enc-dec audio transformer; conv frontend is a STUB
(callers pass precomputed frame embeddings) [arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import EncoderSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,             # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    rope_theta=0.0,          # whisper uses learned/sinusoidal positions, not RoPE
    act="gelu",
    qkv_bias=True,
    mlp_bias=True,
    tie_embeddings=True,
    norm_eps=1e-5,
    encoder=EncoderSpec(n_layers=24, n_frames=1500, frame_dim=1024),
    source="arXiv:2212.04356 (assigned dims; decoder seq lens follow the "
           "assigned shape set, beyond the published 448 context — DESIGN.md)",
)
