"""Architecture registry: arch id → ModelConfig.

Holds the JAX package's ten configs, in its order: dense (glm4-9b,
codeqwen1.5-7b, stablelm-3b, command-r-35b), hybrid (hymba-1.5b), moe
(dbrx-132b, qwen2-moe-a2.7b), vlm (chameleon-34b), encdec
(whisper-medium) and ssm (rwkv6-7b).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    EncoderSpec, ModelConfig, MoESpec, ShapeSpec, SSMSpec,
    SHAPES, cell_applicable, get_shape,
)

from repro_torch.configs import (
    chameleon_34b, codeqwen15_7b, command_r_35b, dbrx_132b, glm4_9b,
    hymba_1_5b, qwen2_moe_a27b, rwkv6_7b, stablelm_3b, whisper_medium,
)

_MODULES = (
    glm4_9b, codeqwen15_7b, stablelm_3b, command_r_35b, hymba_1_5b,
    dbrx_132b, qwen2_moe_a27b, chameleon_34b, whisper_medium, rwkv6_7b,
)

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_config(arch: str) -> ModelConfig:
    try:
        return REGISTRY[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(REGISTRY)}") from None


def smoke_config(arch: str) -> ModelConfig:
    return get_config(arch).reduced()


def list_archs() -> List[str]:
    return list(REGISTRY)
