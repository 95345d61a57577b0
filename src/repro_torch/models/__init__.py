"""Model factory: arch config → model instance."""
from __future__ import annotations

from typing import Union

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM
from repro_torch.models.whisper import EncDecLM

Model = Union[LM, EncDecLM]


def get_model(cfg: ModelConfig, device="cuda", *, ctx=None, **kw) -> Model:
    """The port's model for ``cfg`` on ``device`` (parameters allocated,
    not initialised: call ``init_params`` or load a state dict):
    ``EncDecLM`` for the encdec family, else ``LM`` (``ctx``: a
    ``sharding.ShardCtx`` to run sharded under; ``kw``: ``q_chunk``,
    ``loss_chunk`` and ``remat`` for either, ``kv_quant`` for ``LM``)."""
    if cfg.family == "encdec":
        return EncDecLM(cfg, ctx, device=device, **kw)
    return LM(cfg, ctx, device=device, **kw)
