"""Configuration dataclasses for architectures and input shapes.

A verbatim copy of ``repro.configs.base`` (the port imports nothing of
``repro``).  Every architecture is a frozen ``ModelConfig`` in its own
module under ``repro_torch.configs``; the registry in ``__init__`` maps an
arch id to it.  ``reduced()`` yields the small same-family config used by
the CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoESpec:
    """Mixture-of-experts block specification."""
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared (always-on) experts
    d_ff_shared: int = 0         # hidden size of the fused shared expert
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMSpec:
    """State-space / linear-recurrence specification (Mamba- or RWKV-style)."""
    state_dim: int = 16          # N: per-channel state size (mamba) / head size (rwkv)
    conv_dim: int = 4            # depthwise conv width (mamba)
    expand: int = 2              # inner expansion factor (mamba)
    dt_rank: int = 0             # 0 -> ceil(d_model/16)
    head_dim: int = 64           # rwkv6 wkv head size
    chunk: int = 128             # chunked-scan block length


@dataclass(frozen=True)
class EncoderSpec:
    """Encoder stack for enc-dec models (whisper).  The modality frontend is
    a stub: ``input_specs`` provides precomputed frame embeddings."""
    n_layers: int
    n_frames: int                # encoder sequence length (e.g. 1500 for whisper)
    frame_dim: int               # embedding dim fed by the (stubbed) frontend


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    partial_rotary: float = 1.0  # fraction of head_dim that rotates
    act: str = "swiglu"          # swiglu | gelu
    qkv_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False
    parallel_block: bool = False  # attn and mlp in parallel (command-r style)
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    norm_eps: float = 1e-5
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    encoder: Optional[EncoderSpec] = None
    # numerics
    param_dtype: str = "bfloat16"
    # notes from the public source this config was transcribed from
    source: str = ""

    # ----- derived ---------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic_decode(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid / linear-attention)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch decodes (whisper is enc-dec)

    def padded_vocab(self, multiple: int = 256) -> int:
        v = self.vocab_size
        return ((v + multiple - 1) // multiple) * multiple

    # ----- parameter counting (for MODEL_FLOPS = 6·N·D) --------------------
    def param_counts(self) -> Tuple[int, int]:
        """Returns (total_params, active_params). Embeddings included once."""
        d, f, hd = self.d_model, self.d_ff, self.resolved_head_dim
        attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        n_mat = 3 if self.act == "swiglu" else 2
        dense_mlp = n_mat * d * f
        norms = 2 * d
        total = active = 0
        if self.family == "moe":
            m = self.moe
            expert = (3 if self.act == "swiglu" else 2) * d * m.d_ff_expert
            shared = (3 if self.act == "swiglu" else 2) * d * m.d_ff_shared if m.n_shared else 0
            router = d * m.n_experts
            layer_total = attn + norms + router + m.n_experts * expert + shared
            layer_active = attn + norms + router + m.top_k * expert + shared
            total = self.n_layers * layer_total
            active = self.n_layers * layer_active
        elif self.family == "ssm":
            # rwkv6: time-mix (r,k,v,g,w,o ~ 6 d^2 incl. lora decays) + channel-mix
            layer = 6 * d * d + 2 * d * f + norms
            total = active = self.n_layers * layer
        elif self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            mamba = d * d_in * 2 + d_in * (s.state_dim * 2 + 2) + d_in * d
            layer = attn + dense_mlp + norms + mamba
            total = active = self.n_layers * layer
        elif self.family == "encdec":
            enc = self.encoder
            enc_layer = attn + dense_mlp + norms
            dec_layer = attn + attn + dense_mlp + 3 * d  # self + cross attn
            total = active = enc.n_layers * enc_layer + self.n_layers * dec_layer
        else:  # dense / vlm
            total = active = self.n_layers * (attn + dense_mlp + norms)
        emb = self.padded_vocab() * d
        total += emb if self.tie_embeddings else 2 * emb
        active += emb if self.tie_embeddings else 2 * emb
        return int(total), int(active)

    # ----- smoke-test reduction --------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab_size=512,
            head_dim=16,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff_expert=32,
                d_ff_shared=64 if self.moe.n_shared else 0,
                n_shared=min(self.moe.n_shared, 1))
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, state_dim=4, head_dim=16, chunk=8)
        if self.encoder is not None:
            kw["encoder"] = EncoderSpec(n_layers=2, n_frames=16, frame_dim=64)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode

    @property
    def step_name(self) -> str:
        return {"train": "train_step", "prefill": "prefill_step",
                "decode": "serve_step", "long_decode": "serve_step"}[self.kind]


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    ShapeSpec("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    ShapeSpec("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    ShapeSpec("long_500k", seq_len=524_288, global_batch=1, kind="long_decode"),
)


def get_shape(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in SHAPES]}")


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch × shape) cell runs, and why not if skipped."""
    if shape.kind == "long_decode" and not cfg.subquadratic_decode:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (see DESIGN.md)")
    return True, ""
