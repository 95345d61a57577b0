"""Model factory: arch config → model instance."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM


def get_model(cfg: ModelConfig, device="cuda", **kw) -> LM:
    """The port's model for ``cfg`` on ``device`` (parameters allocated,
    not initialised: call ``init_params`` or load a state dict).  The
    dense, ssm and hybrid families are ported; ``LM`` names the ROADMAP
    item for the rest."""
    return LM(cfg, device=device, **kw)
