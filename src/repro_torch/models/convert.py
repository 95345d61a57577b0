"""Conversion of the JAX package's parameter tree into the port's state dict.

The JAX tree of a decoder-only model is ``{"layers": {name: [L, ...]},
"embed", "final_ln", "lm_head"}``, an encoder–decoder's ``{"enc_layers":
{name: [L_enc, ...]}, "dec_layers": {name: [L, ...]}, "embed", "dec_pos",
"enc_pos", ...}``, with every leaf as a numpy array.  The port keeps the
same names and the same ``[in, out]`` weight layout, so conversion only
splits each stacked ``[L, ...]`` array into ``<stack>.<i>.<name>`` and puts
the other names under ``top.``; no weight needs a transpose.  The same
holds for every ported family: rwkv6 layers carry the time-mix/channel-mix
names (``mu_*``, ``w_r`` … ``cm_r``), hybrid layers the attention and MLP
names plus ``mamba_*``, ``attn_out_ln`` and ``mamba_out_ln``, whisper's
decoder layers the cross-attention's ``x_*``; a config with tied
embeddings (hymba, whisper) has no ``lm_head`` in either tree.
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
    """State dict for ``get_model(cfg)`` from the JAX parameter tree (numpy
    leaves).  Each stack must hold the config's number of layers."""
    if cfg.family == "encdec":
        stacks = {"enc_layers": cfg.encoder.n_layers,
                  "dec_layers": cfg.n_layers}
    else:
        stacks = {"layers": cfg.n_layers}
    sd: Dict[str, torch.Tensor] = {}
    for stack, n_layers in stacks.items():
        for name, stacked in params_np[stack].items():
            stacked = np.asarray(stacked)
            if stacked.shape[0] != n_layers:
                raise ValueError(f"{stack}.{name} stacks {stacked.shape[0]} "
                                 f"layers, config has {n_layers}")
            for i in range(n_layers):
                sd[f"{stack}.{i}.{name}"] = _tensor(stacked[i])
    for name, arr in params_np.items():
        if name not in stacks:
            sd[f"top.{name}"] = _tensor(arr)
    return sd
