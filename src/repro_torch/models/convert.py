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
``axes_by_name`` keys a model's ``param_axes()`` (the JAX twin's logical
axes over its stacked tree) the same way, for the port's parameter
layouts under a ``ShardCtx``.
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


def _stacks(cfg: ModelConfig) -> Dict[str, int]:
    if cfg.family == "encdec":
        return {"enc_layers": cfg.encoder.n_layers,
                "dec_layers": cfg.n_layers}
    return {"layers": cfg.n_layers}


def by_name(cfg: ModelConfig, tree, per_layer) -> Dict:
    """A JAX-structured tree (``{stack: {name: stacked leaf}, top names}``)
    keyed by the port's state-dict names: ``per_layer(leaf, i)`` for
    ``<stack>.<i>.<name>``, the leaf itself for ``top.<name>``."""
    stacks = _stacks(cfg)
    out: Dict = {}
    for stack, n_layers in stacks.items():
        for name, leaf in tree[stack].items():
            for i in range(n_layers):
                out[f"{stack}.{i}.{name}"] = per_layer(leaf, i)
    for name, leaf in tree.items():
        if name not in stacks:
            out[f"top.{name}"] = leaf
    return out


def params_from_jax(cfg: ModelConfig, params_np) -> Dict[str, torch.Tensor]:
    """State dict for ``get_model(cfg)`` from the JAX parameter tree (numpy
    leaves).  Each stack must hold the config's number of layers."""
    for stack, n_layers in _stacks(cfg).items():
        for name, stacked in params_np[stack].items():
            if np.asarray(stacked).shape[0] != n_layers:
                raise ValueError(f"{stack}.{name} stacks "
                                 f"{np.asarray(stacked).shape[0]} layers, "
                                 f"config has {n_layers}")
    return {n: _tensor(a) for n, a in
            by_name(cfg, params_np, lambda a, i: np.asarray(a)[i]).items()}


def axes_by_name(cfg: ModelConfig, axes_tree) -> Dict[str, tuple]:
    """The logical axes of ``param_axes()`` by state-dict name: a layer's
    without the stacked ``layer`` axis."""
    return by_name(cfg, axes_tree, lambda axes, i: axes[1:])
