"""Model factory: arch config → model instance."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM


def get_model(cfg: ModelConfig, device="cuda", **kw) -> LM:
    """The port's model for ``cfg`` on ``device`` (parameters allocated,
    not initialised: call ``init_params`` or load a state dict).  Every
    decoder-only family is ported (``kw``: ``kv_quant``); ``LM`` names the
    ROADMAP item for encdec."""
    return LM(cfg, device=device, **kw)
