"""Conversion of the JAX package's parameter tree into the port's state dict.

The JAX tree is ``{"layers": {name: [L, ...]}, "embed", "final_ln",
"lm_head"}`` with every leaf as a numpy array.  The port keeps the same
names and the same ``[in, out]`` weight layout, so conversion only splits
the stacked ``[L, ...]`` layer arrays into ``layers.<i>.<name>``; no weight
needs a transpose.  The same holds for every ported family: rwkv6 layers
carry the time-mix/channel-mix names (``mu_*``, ``w_r`` … ``cm_r``), hybrid
layers the attention and MLP names plus ``mamba_*``, ``attn_out_ln`` and
``mamba_out_ln``; a config with tied embeddings (hymba) has no ``lm_head``
in either tree.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(cfg: ModelConfig, params_np) -> Dict[str, torch.Tensor]:
    """State dict for ``LM(cfg)`` from the JAX parameter tree (numpy leaves)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, stacked in params_np["layers"].items():
        stacked = np.asarray(stacked)
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"layers.{name} stacks {stacked.shape[0]} "
                             f"layers, config has {cfg.n_layers}")
        for i in range(cfg.n_layers):
            sd[f"layers.{i}.{name}"] = _tensor(stacked[i])
    for name, arr in params_np.items():
        if name != "layers":
            sd[f"top.{name}"] = _tensor(arr)
    return sd
