"""Architecture registry: arch id → ModelConfig.

Holds the configs whose families the port runs so far (dense: glm4-9b;
ssm: rwkv6-7b; hybrid: hymba-1.5b); the others arrive with their families
(ROADMAP queue 1: "The other dense-path configs", "The MoE family",
"Encoder–decoder").
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    EncoderSpec, ModelConfig, MoESpec, ShapeSpec, SSMSpec,
    SHAPES, cell_applicable, get_shape,
)

from repro_torch.configs import glm4_9b, hymba_1_5b, rwkv6_7b

_MODULES = (glm4_9b, rwkv6_7b, hymba_1_5b)

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
