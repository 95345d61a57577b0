"""Decoder-only LM, dense family, as an ``nn.Module``.

Port of ``repro.models.lm``.  Layers are an ``nn.ModuleList`` run by an
explicit Python loop (the JAX twin scans stacked layers with remat).
Parameters keep the JAX package's names and ``[in, out]`` layout;
``models.convert.params_from_jax`` turns a JAX parameter tree into this
module's state dict.

Entry points:
  forward(tokens)                     — parallel forward → hidden states
  prefill(tokens, max_len, lengths)   — last-token logits + KV cache
  decode_step(cache, token, pos)      — one token per row; the KV cache is
                                        updated in place
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ParamGroup(nn.Module):
    """A flat group of named parameters (one layer, or the top level's)."""

    def __init__(self, spec: Dict[str, Tuple[int, ...]], dtype, device):
        super().__init__()
        for name, shape in spec.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device),
                requires_grad=False))

    def tensors(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters(recurse=False))


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: the dense family "
                "is; the others come with ROADMAP.md queue 1 item 7")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.param_dtype]
        self.layers = nn.ModuleList(
            ParamGroup(self.layer_spec(), self.dtype, self.device)
            for _ in range(cfg.n_layers))
        self.top = ParamGroup(self.top_spec(), self.dtype, self.device)

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def layer_spec(self) -> Dict[str, Tuple[int, ...]]:
        cfg = self.cfg
        spec = {"ln1": (cfg.d_model,)}
        spec.update(L.attn_param_spec(cfg))
        if not cfg.parallel_block:
            spec["ln2"] = (cfg.d_model,)
        spec.update(L.mlp_param_spec(cfg))
        return spec

    def top_spec(self) -> Dict[str, Tuple[int, ...]]:
        cfg = self.cfg
        vp, d = cfg.padded_vocab(), cfg.d_model
        spec = {"embed": (vp, d), "final_ln": (d,)}
        if not cfg.tie_embeddings:
            spec["lm_head"] = (d, vp)
        return spec

    def init_params(self, generator: torch.Generator) -> None:
        """Fill every parameter in place by the JAX package's init rule
        (``layers.init_rule``), drawing from ``generator``, which must live
        on the model's device."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        for layer in self.layers:
            L.init_from_spec(layer.tensors(), generator)
        L.init_from_spec(self.top.tensors(), generator)

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------
    def _block(self, x, p, positions, cache=None, pos=None):
        """One transformer block.  With ``cache`` (k_cache, v_cache) it
        decodes: writes this step's K/V at ``pos`` in place and attends
        over the cache.  Returns (x, (k, v) of this call)."""
        cfg = self.cfg
        B, S, _ = x.shape
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = L._project_qkv(h, p, cfg, positions)
        if cache is None:
            att = L.attention_chunked(q, k, v, causal=True,
                                      softcap=cfg.logit_softcap)
        else:
            k_cache, v_cache = cache
            L.cache_update(k_cache, k, pos)
            L.cache_update(v_cache, v, pos)
            length = L.decode_lengths(pos, B, x.device)
            att = L.attention_decode(q, k_cache, v_cache, length,
                                     cfg.logit_softcap)
        attn_out = att.reshape(B, S, -1) @ p["wo"]
        if cfg.parallel_block:
            return x + attn_out + L.mlp(h, p, cfg), (k, v)
        x = x + attn_out
        x = x + L.mlp(L.rms_norm(x, p["ln2"], cfg.norm_eps), p, cfg)
        return x, (k, v)

    # ------------------------------------------------------------------
    # forward passes
    # ------------------------------------------------------------------
    def _embed(self, tokens):
        return F.embedding(tokens, self.top.embed).to(self.dtype)

    def forward(self, tokens, *, collect_cache: bool = False):
        """Parallel forward over [B, S].  Returns (hidden, kv) where kv is
        the per-layer list of (k, v) [B, S, KV, hd] with ``collect_cache``,
        else None."""
        x = self._embed(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        kv: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for layer in self.layers:
            x, kv_l = self._block(x, layer.tensors(), positions)
            if collect_cache:
                kv.append(kv_l)
        x = L.rms_norm(x, self.top.final_ln, self.cfg.norm_eps)
        return x, (kv if collect_cache else None)

    def logits_fn(self, hidden):
        cfg = self.cfg
        head = self.top.embed.T if cfg.tie_embeddings else self.top.lm_head
        logits = (hidden @ head).float()
        vp = cfg.padded_vocab()
        if vp != cfg.vocab_size:
            logits[..., cfg.vocab_size:] = L.NEG_INF
        return logits

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def cache_shapes(self, batch: int, max_len: int):
        """name → (shape, dtype) of the KV cache."""
        cfg = self.cfg
        kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
              cfg.resolved_head_dim)
        return {"k": (kv, self.dtype), "v": (kv, self.dtype)}

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        return {name: torch.zeros(shape, dtype=dtype, device=self.device)
                for name, (shape, dtype) in
                self.cache_shapes(batch, max_len).items()}

    def prefill(self, tokens, max_len: Optional[int] = None,
                lengths: Optional[torch.Tensor] = None):
        """Returns (last_token_logits [B,1,V], cache ready at pos=S).

        ``lengths`` [B] (optional) marks each row's true prompt length in a
        right-padded packed batch: the returned logits are taken at column
        ``lengths-1`` per row instead of the last column.  Under causal
        attention the pad tail never influences earlier positions, so a
        packed prefill equals per-request prefills (pad K/V beyond
        ``lengths`` is masked out at decode by the per-slot length).
        """
        B, Sq = tokens.shape
        max_len = max_len or Sq
        hidden, kv = self.forward(tokens, collect_cache=True)
        if lengths is None:
            h_last = hidden[:, -1:, :]
        else:
            idx = (lengths.to(hidden.device).long() - 1).clamp(0, Sq - 1)
            h_last = hidden[torch.arange(B, device=hidden.device), idx][:, None]
        logits = self.logits_fn(h_last)
        cache = self.init_cache(B, max_len)
        for i, (k, v) in enumerate(kv):
            cache["k"][i, :, :Sq] = k
            cache["v"][i, :, :Sq] = v
        return logits, cache

    def decode_step(self, cache, token, pos):
        """token [B,1]; pos an int (current cache length, shared by every
        row) or a [B] tensor of per-slot cache lengths (ragged decode).
        Writes the new K/V into ``cache`` in place.
        Returns (logits [B,1,V], cache)."""
        x = self._embed(token)
        if L.is_shared_pos(pos):
            positions = torch.full((1, 1), int(pos), device=x.device)
        else:
            pos = torch.as_tensor(pos, device=x.device).long()
            positions = pos[:, None]                        # [B, 1] per slot
        for i, layer in enumerate(self.layers):
            x, _ = self._block(x, layer.tensors(), positions,
                               cache=(cache["k"][i], cache["v"][i]), pos=pos)
        x = L.rms_norm(x, self.top.final_ln, self.cfg.norm_eps)
        return self.logits_fn(x), cache
