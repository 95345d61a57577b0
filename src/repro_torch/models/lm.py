"""Decoder-only LM, dense, ssm and hybrid families, as an ``nn.Module``.

Port of ``repro.models.lm``.  Layers are an ``nn.ModuleList`` run by an
explicit Python loop (the JAX twin scans stacked layers with remat).
Parameters keep the JAX package's names and ``[in, out]`` layout;
``models.convert.params_from_jax`` turns a JAX parameter tree into this
module's state dict.

Entry points:
  forward(tokens)                     — parallel forward → hidden states
  prefill(tokens, max_len, lengths)   — last-token logits + cache: K/V
                                        (dense, hybrid) and the recurrent
                                        state (ssm: wkv, token shifts;
                                        hybrid: conv tail, SSD state)
  decode_step(cache, token, pos)      — one token per row; the cache is
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
from repro_torch.models import ssm as SSM

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def layer_spec(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """name → shape of one layer's parameters (the JAX twin's names)."""
    d = cfg.d_model
    if cfg.family == "ssm":
        spec = {"ln1": (d,), "ln2": (d,)}
        spec.update(SSM.rwkv_param_spec(cfg))
        return spec
    spec = {"ln1": (d,)}
    spec.update(L.attn_param_spec(cfg))
    if not cfg.parallel_block:
        spec["ln2"] = (d,)
    spec.update(L.mlp_param_spec(cfg))
    if cfg.family == "hybrid":
        spec.update({f"mamba_{k}": v
                     for k, v in SSM.mamba_param_spec(cfg).items()})
        spec["attn_out_ln"] = (d,)
        spec["mamba_out_ln"] = (d,)
    return spec


def top_spec(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """name → shape of the parameters outside the layers."""
    vp, d = cfg.padded_vocab(), cfg.d_model
    spec = {"embed": (vp, d), "final_ln": (d,)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = (d, vp)
    return spec


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
        if cfg.family not in ("dense", "ssm", "hybrid"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: dense, ssm and "
                "hybrid are; moe, encdec and vlm come with ROADMAP.md queue 1 "
                "(\"The MoE family\", \"Encoder–decoder\", \"The other "
                "dense-path configs\")")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.param_dtype]
        self.layers = nn.ModuleList(
            ParamGroup(layer_spec(cfg), self.dtype, self.device)
            for _ in range(cfg.n_layers))
        self.top = ParamGroup(top_spec(cfg), self.dtype, self.device)

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
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
    def _block(self, x, p, positions, cache=None, pos=None,
               need_state: bool = False):
        """One block.  With ``cache`` (this layer's slice of the decode
        cache) it decodes one token: K/V are written at ``pos`` in place,
        attention runs over the cache, and the recurrent state continues
        from the cache.  Returns (x, this call's cache entries: k/v of the
        call, the new recurrent state).  ``need_state``: the caller keeps
        the recurrent state of a parallel call (prefill)."""
        cfg = self.cfg
        B, S, _ = x.shape
        if cfg.family == "ssm":
            return self._rwkv_block(x, p, cache, need_state)
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = L._project_qkv(h, p, cfg, positions)
        if cache is None:
            att = L.attention_chunked(q, k, v, causal=True,
                                      softcap=cfg.logit_softcap)
        else:
            L.cache_update(cache["k"], k, pos)
            L.cache_update(cache["v"], v, pos)
            length = L.decode_lengths(pos, B, x.device)
            att = L.attention_decode(q, cache["k"], cache["v"], length,
                                     cfg.logit_softcap)
        attn_out = att.reshape(B, S, -1) @ p["wo"]
        new = {"k": k, "v": v}
        if cfg.family == "hybrid":
            mp = {name[len("mamba_"):]: t for name, t in p.items()
                  if name.startswith("mamba_")}
            m_state = None if cache is None else {"conv": cache["conv"],
                                                  "ssm": cache["ssm"]}
            mamba_out, m_new = SSM.mamba_block(h, mp, cfg, state=m_state,
                                               need_state=need_state)
            # mean of per-branch normalized outputs (hymba parallel heads)
            attn_out = L.rms_norm(attn_out, p["attn_out_ln"], cfg.norm_eps)
            mamba_out = L.rms_norm(mamba_out, p["mamba_out_ln"], cfg.norm_eps)
            attn_out = 0.5 * (attn_out + mamba_out)
            new.update(conv=m_new["conv"], ssm=m_new["ssm"].float())
        if cfg.parallel_block:
            return x + attn_out + L.mlp(h, p, cfg), new
        x = x + attn_out
        x = x + L.mlp(L.rms_norm(x, p["ln2"], cfg.norm_eps), p, cfg)
        return x, new

    def _rwkv_block(self, x, p, cache, need_state: bool = False):
        """One RWKV6 block (time mix, channel mix); decodes from ``cache``
        when given, else starts from zero token shifts and state."""
        cfg = self.cfg
        zeros = torch.zeros((x.shape[0], cfg.d_model), dtype=x.dtype,
                            device=x.device)
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        tm_out, (shift_tm, wkv) = SSM.rwkv_time_mix(
            h, p, cfg,
            shift_state=zeros if cache is None else cache["shift_tm"],
            wkv_state=None if cache is None else cache["wkv"],
            need_state=need_state)
        x = x + tm_out
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        cm_out, shift_cm = SSM.rwkv_channel_mix(
            h, p, cfg,
            shift_state=zeros if cache is None else cache["shift_cm"])
        x = x + cm_out
        return x, {"wkv": wkv.float(), "shift_tm": shift_tm,
                   "shift_cm": shift_cm}

    # ------------------------------------------------------------------
    # forward passes
    # ------------------------------------------------------------------
    def _embed(self, tokens):
        return F.embedding(tokens, self.top.embed).to(self.dtype)

    def forward(self, tokens, *, collect_cache: bool = False):
        """Parallel forward over [B, S].  Returns (hidden, caches) where
        caches is the per-layer list of cache entries with
        ``collect_cache`` (k/v [B, S, KV, hd]; the recurrent state at the
        end of the row), else None."""
        x = self._embed(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        caches: List[Dict[str, torch.Tensor]] = []
        for layer in self.layers:
            x, new = self._block(x, layer.tensors(), positions,
                                 need_state=collect_cache)
            if collect_cache:
                caches.append(new)
        x = L.rms_norm(x, self.top.final_ln, self.cfg.norm_eps)
        return x, (caches if collect_cache else None)

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
        """name → (shape, dtype) of the decode cache: K/V for the attention
        families, the recurrent state (f32 for wkv/ssm) for ssm/hybrid;
        every entry has the layer axis first."""
        cfg = self.cfg
        Lc = cfg.n_layers
        shapes = {}
        if cfg.family != "ssm":
            kv = (Lc, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
            shapes["k"] = (kv, self.dtype)
            shapes["v"] = (kv, self.dtype)
        if cfg.family == "hybrid":
            ms = SSM.mamba_state_shape(cfg, batch)
            shapes["conv"] = ((Lc,) + ms["conv"], self.dtype)
            shapes["ssm"] = ((Lc,) + ms["ssm"], torch.float32)
        if cfg.family == "ssm":
            rs = SSM.rwkv_state_shape(cfg, batch)
            shapes["wkv"] = ((Lc,) + rs["wkv"], torch.float32)
            shapes["shift_tm"] = ((Lc,) + rs["shift_tm"], self.dtype)
            shapes["shift_cm"] = ((Lc,) + rs["shift_cm"], self.dtype)
        return shapes

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
        hidden, caches = self.forward(tokens, collect_cache=True)
        if lengths is None:
            h_last = hidden[:, -1:, :]
        else:
            idx = (lengths.to(hidden.device).long() - 1).clamp(0, Sq - 1)
            h_last = hidden[torch.arange(B, device=hidden.device), idx][:, None]
        logits = self.logits_fn(h_last)
        cache = self.init_cache(B, max_len)
        for i, new in enumerate(caches):
            for name, t in new.items():
                if name in ("k", "v"):
                    cache[name][i, :, :Sq] = t
                else:                      # recurrent state: the row's end
                    cache[name][i] = t
        return logits, cache

    def decode_step(self, cache, token, pos):
        """token [B,1]; pos an int (current cache length, shared by every
        row) or a [B] tensor of per-slot cache lengths (ragged decode).
        Writes the new K/V and recurrent state into ``cache`` in place.
        Returns (logits [B,1,V], cache)."""
        x = self._embed(token)
        if L.is_shared_pos(pos):
            positions = torch.full((1, 1), int(pos), device=x.device)
        else:
            pos = torch.as_tensor(pos, device=x.device).long()
            positions = pos[:, None]                        # [B, 1] per slot
        for i, layer in enumerate(self.layers):
            x, new = self._block(x, layer.tensors(), positions,
                                 cache={n: c[i] for n, c in cache.items()},
                                 pos=pos)
            for name, t in new.items():
                if name not in ("k", "v"):  # K/V were written at pos
                    cache[name][i].copy_(t)
        x = L.rms_norm(x, self.top.final_ln, self.cfg.norm_eps)
        return self.logits_fn(x), cache
