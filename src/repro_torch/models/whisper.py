"""Whisper-style encoder–decoder backbone, as an ``nn.Module``.

Port of ``repro.models.whisper``.  The conv/mel frontend is a stub, as in
the reference: callers pass precomputed frame embeddings [B, n_frames,
d_model].  The encoder is bidirectional with learned positions; the
decoder is causal, with learned positions and cross-attention to the
encoder's output.  Layers are ``nn.ModuleList``s run by an explicit Python
loop (the JAX twin scans stacked layers with remat), with the JAX names and
``[in, out]`` layout; ``models.convert.params_from_jax`` turns a JAX tree
into this module's state dict.

Entry points:
  loss(batch)                             — mean next-token NLL of the
                                            decoder, chunked over the
                                            sequence
  encode(frames)                          — encoder output [B, F, d]
  decode_parallel(tokens, enc_out, ...)   — decoder hidden states (and the
                                            per-layer self and cross K/V)
  prefill(tokens, frames, max_len)        — last-token logits + cache: the
                                            self K/V (``k``, ``v``) and
                                            every layer's cross K/V
                                            (``xk``, ``xv``), computed once
  decode_step(cache, token, pos)          — one token per row at a shared
                                            position; K/V written at ``pos``
                                            in place

Self-attention in parallel mode (the encoder's non-causal, the decoder's
causal) and every cross-attention, at prefill and at decode, go through
``layers.attention_chunked``, so an impl installed at the ``attention``
site takes each of them, as in the reference; decode self-attention is
``layers.attention_decode``.  With ``remat`` (the default) a forward
under grad runs each encoder and decoder layer in
``torch.utils.checkpoint``, as ``LM`` does.  Under a ``ShardCtx`` the
model runs data-parallel on the rank's batch rows (every layer's weights
whole: gathered in one pass by ``sharding.gathered``, under grad inside
the layer's remat body; activations unsplit otherwise), and
``loss`` returns the rank's share of the global loss, as ``LM``'s does;
``param_axes`` and ``cache_axes`` give the JAX twin's logical axes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.lm import (_DTYPES, ParamGroup, chunked_nll,
                                   remat_layer, stacked)
from repro_torch.sharding import ShardCtx, comm, gathered

MAX_DECODER_POS = 32768  # learned positions table bound (largest assigned shape)


def enc_layer_spec(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    spec = {"ln1": (d,), "ln1_b": (d,), "ln2": (d,), "ln2_b": (d,)}
    spec.update(L.attn_param_spec(cfg))
    spec.update(L.mlp_param_spec(cfg))
    return spec


def dec_layer_spec(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    spec = {"ln1": (d,), "ln1_b": (d,), "ln2": (d,), "ln2_b": (d,),
            "ln3": (d,), "ln3_b": (d,)}
    spec.update(L.attn_param_spec(cfg))
    spec.update({f"x_{k}": v for k, v in L.attn_param_spec(cfg).items()})
    spec.update(L.mlp_param_spec(cfg))
    return spec


def top_spec(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    vp, d = cfg.padded_vocab(), cfg.d_model
    return {"embed": (vp, d), "dec_pos": (MAX_DECODER_POS, d),
            "enc_pos": (cfg.encoder.n_frames, d),
            "enc_final_ln": (d,), "enc_final_ln_b": (d,),
            "final_ln": (d,), "final_ln_b": (d,)}


def enc_layer_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    return {"ln1": (None,), "ln1_b": (None,), "ln2": (None,),
            "ln2_b": (None,), **L.attn_param_axes(cfg),
            **L.mlp_param_axes(cfg)}


def dec_layer_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    return {"ln1": (None,), "ln1_b": (None,), "ln2": (None,),
            "ln2_b": (None,), "ln3": (None,), "ln3_b": (None,),
            **L.attn_param_axes(cfg),
            **{f"x_{k}": v for k, v in L.attn_param_axes(cfg).items()},
            **L.mlp_param_axes(cfg)}


def top_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    return {"embed": ("vocab", "d_model"), "dec_pos": (None, "d_model"),
            "enc_pos": ("frames", "d_model"), "enc_final_ln": (None,),
            "enc_final_ln_b": (None,), "final_ln": (None,),
            "final_ln_b": (None,)}


def param_axes(cfg: ModelConfig):
    """Logical axes over the JAX twin's stacked parameter tree."""
    def lead(a):
        return ("layer",) + a
    return {**stacked(enc_layer_axes(cfg), {}, "enc_layers", lead),
            **stacked(dec_layer_axes(cfg), top_axes(cfg), "dec_layers", lead)}


def param_shapes(cfg: ModelConfig):
    """Shapes over the JAX twin's stacked parameter tree."""
    return {**stacked(enc_layer_spec(cfg), {}, "enc_layers",
                      lambda s: (cfg.encoder.n_layers,) + s),
            **stacked(dec_layer_spec(cfg), top_spec(cfg), "dec_layers",
                      lambda s: (cfg.n_layers,) + s)}


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """name → (shape, dtype): self K/V over ``max_len`` positions and
    cross K/V over the encoder's frames, the layer axis first."""
    dtype = _DTYPES[cfg.param_dtype]
    Lc, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    kv = (Lc, batch, max_len, KV, hd)
    xkv = (Lc, batch, cfg.encoder.n_frames, KV, hd)
    return {"k": (kv, dtype), "v": (kv, dtype),
            "xk": (xkv, dtype), "xv": (xkv, dtype)}


def cache_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    return {"k": ("layer", "batch", None, "kv_heads", None),
            "v": ("layer", "batch", None, "kv_heads", None),
            "xk": ("layer", "batch", "frames", "kv_heads", None),
            "xv": ("layer", "batch", "frames", "kv_heads", None)}


class EncDecLM(nn.Module):
    def __init__(self, cfg: ModelConfig, ctx: Optional[ShardCtx] = None, *,
                 device="cuda", q_chunk: int = 256, loss_chunk: int = 1024,
                 remat: bool = True):
        super().__init__()
        if cfg.family != "encdec" or cfg.encoder is None:
            raise ValueError(f"EncDecLM needs an encdec config with an "
                             f"encoder; {cfg.name} is {cfg.family!r} with "
                             f"encoder {cfg.encoder}")
        self.cfg = cfg
        self.ctx = ctx or ShardCtx.null()
        self.q_chunk = q_chunk
        self.loss_chunk = loss_chunk
        self.remat = remat
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.param_dtype]
        self.enc_layers = nn.ModuleList(
            ParamGroup(enc_layer_spec(cfg), self.dtype, self.device)
            for _ in range(cfg.encoder.n_layers))
        self.dec_layers = nn.ModuleList(
            ParamGroup(dec_layer_spec(cfg), self.dtype, self.device)
            for _ in range(cfg.n_layers))
        self.top = ParamGroup(top_spec(cfg), self.dtype, self.device)

    # ------------------------------------------------------------------
    def init_params(self, generator: torch.Generator) -> None:
        """Fill every parameter in place by the JAX package's init rule
        (``layers.init_rule``, names as they are: ``x_bq`` and ``final_ln``
        are drawn normal), drawing from ``generator``, which must live on
        the model's device."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        for layer in [*self.enc_layers, *self.dec_layers]:
            L.init_from_spec(layer.tensors(), generator)
        L.init_from_spec(self.top.tensors(), generator)

    def param_axes(self):
        return param_axes(self.cfg)

    def param_shapes(self):
        return param_shapes(self.cfg)

    def sequence_length(self, local_len: int) -> int:
        """The whole sequence's length of a rank's tokens (never split)."""
        return local_len

    def _top(self, name: str) -> torch.Tensor:
        """A top-level weight to compute with (a DTensor gathered whole by
        ``gathered``: under grad its gradient lands in its layout)."""
        return gathered(getattr(self.top, name), self.ctx.batch_axes)

    def _layer_params(self, layer) -> Dict[str, torch.Tensor]:
        """One layer's weights to compute with (DTensors gathered whole in
        one pass by ``gathered``, as ``LM._layer_params`` gathers a family
        that tensor parallelism leaves whole)."""
        p = layer.tensors()
        if not self.ctx.enabled:
            return p
        return {n: gathered(w, self.ctx.batch_axes) for n, w in p.items()}

    # ------------------------------------------------------------------
    def _ln(self, x, p, name):
        return L.layer_norm(x, p[name], p[name + "_b"], self.cfg.norm_eps)

    def _self_attn(self, x, p, causal: bool, cache=None, pos=None):
        """Self-attention over ``x`` (no rotation: learned positions).
        Parallel (``cache`` None) through ``attention_chunked``; else one
        token decoded against this layer's (k, v) cache, written at ``pos``
        in place.  Returns (output, this call's (k, v))."""
        B, S, _ = x.shape
        q, k, v = L._project_qkv(x, p, self.cfg, None, self.ctx)
        if cache is None:
            out = L.attention_chunked(q, k, v, causal=causal,
                                      q_chunk=self.q_chunk)
        else:
            k_cache, v_cache = cache
            L.cache_update(k_cache, k, pos)
            L.cache_update(v_cache, v, pos)
            out = L.attention_decode(q, k_cache, v_cache,
                                     L.decode_lengths(pos, B, x.device))
        return out.reshape(B, S, -1) @ p["wo"], (k, v)

    def _cross_attn(self, x, p, xk, xv):
        """Non-causal attention of ``x`` to the encoder's K/V (B, F, KV,
        hd), through ``attention_chunked`` at prefill and at decode."""
        cfg = self.cfg
        B, S, _ = x.shape
        q = x @ p["x_wq"]
        if cfg.qkv_bias:
            q = q + p["x_bq"]
        q = q.reshape(B, S, cfg.n_heads, cfg.resolved_head_dim)
        out = L.attention_chunked(q, xk, xv, causal=False,
                                  q_chunk=self.q_chunk)
        return out.reshape(B, S, -1) @ p["x_wo"]

    # ------------------------------------------------------------------
    def encode(self, frames):
        """frames: [B, n_frames, d_model] (the stub frontend's output)."""
        cfg = self.cfg
        want = (cfg.encoder.n_frames, cfg.d_model)
        if frames.dim() != 3 or tuple(frames.shape[1:]) != want:
            raise ValueError(f"frames must be [B, {want[0]}, {want[1]}], got "
                             f"{tuple(frames.shape)}")
        x = frames.to(self.dtype) + self._top("enc_pos").to(self.dtype)
        x = self.ctx.constrain(x, "batch", None, None)
        for layer in self.enc_layers:
            def one(x, layer=layer):
                return self._enc_block(x, self._layer_params(layer))
            x = remat_layer(one, x) if self.remat else one(x)
        return L.layer_norm(x, self._top("enc_final_ln"),
                            self._top("enc_final_ln_b"),
                            cfg.norm_eps)

    def _enc_block(self, x, p):
        a, _ = self._self_attn(self._ln(x, p, "ln1"), p, causal=False)
        x = x + a
        return x + L.mlp(self._ln(x, p, "ln2"), p, self.cfg, self.ctx)

    def _dec_embed(self, tokens, pos0: int):
        x = F.embedding(tokens, self._top("embed")).to(self.dtype)
        positions = pos0 + torch.arange(tokens.shape[1], device=tokens.device)
        x = x + self._top("dec_pos")[positions].to(self.dtype)
        return self.ctx.constrain(x, "batch", None, None)

    def _cross_kv(self, p, enc_out):
        """One decoder layer's cross K/V of the encoder output:
        [B, F, KV, hd] each."""
        cfg = self.cfg
        k, v = enc_out @ p["x_wk"], enc_out @ p["x_wv"]
        if cfg.qkv_bias:
            k, v = k + p["x_bk"], v + p["x_bv"]
        B, Fr = enc_out.shape[:2]
        shape = (B, Fr, cfg.n_kv_heads, cfg.resolved_head_dim)
        return k.reshape(shape), v.reshape(shape)

    def _dec_block(self, x, p, xk, xv, cache=None, pos=None):
        a, kv = self._self_attn(self._ln(x, p, "ln1"), p, causal=True,
                                cache=cache, pos=pos)
        x = x + a
        x = x + self._cross_attn(self._ln(x, p, "ln2"), p, xk, xv)
        return x + L.mlp(self._ln(x, p, "ln3"), p, self.cfg, self.ctx), kv

    def decode_parallel(self, tokens, enc_out, *,
                        collect_cache: bool = False):
        """Causal decoder over [B, S] attending to ``enc_out``.  Returns
        (hidden, caches): with ``collect_cache`` the per-layer list of
        ``{"k", "v"}`` (self, [B, S, KV, hd]) and ``{"xk", "xv"}`` (cross,
        [B, F, KV, hd]), else None."""
        x = self._dec_embed(tokens, 0)
        caches: List[Dict[str, torch.Tensor]] = []
        for layer in self.dec_layers:
            def one(x, layer=layer):
                p = self._layer_params(layer)
                xk, xv = self._cross_kv(p, enc_out)
                x, (k, v) = self._dec_block(x, p, xk, xv)
                return x, {"k": k, "v": v, "xk": xk, "xv": xv}
            x, new = remat_layer(one, x) if self.remat else one(x)
            if collect_cache:
                caches.append(new)
        x = L.layer_norm(x, self._top("final_ln"), self._top("final_ln_b"),
                         self.cfg.norm_eps)
        return x, (caches if collect_cache else None)

    def _embed_whole(self) -> torch.Tensor:
        """The embedding to take logits with (tied), gathered as
        ``_layer_params`` gathers a layer's weights."""
        return self._top("embed")

    def logits_fn(self, hidden, embed: Optional[torch.Tensor] = None):
        """Tied embeddings; the padded vocabulary's logits are -1e30.
        ``embed`` (``_embed_whole()``) when the caller gathered it."""
        cfg = self.cfg
        embed = self._embed_whole() if embed is None else embed
        logits = (hidden @ embed.T).float()
        if cfg.padded_vocab() != cfg.vocab_size:
            logits[..., cfg.vocab_size:] = L.NEG_INF
        return self.ctx.constrain(logits, "batch", None, "vocab")

    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {'frames': [B,F,d], 'tokens': [B,S], 'targets': [B,S]}
        (-1 = padding).  Returns (loss, {"nll": loss})."""
        enc_out = self.encode(batch["frames"])
        hidden, _ = self.decode_parallel(batch["tokens"], enc_out)
        c = min(self.loss_chunk, hidden.shape[1])
        assert hidden.shape[1] % c == 0
        embed = self._embed_whole()               # once for every chunk
        total, count = chunked_nll(lambda h: self.logits_fn(h, embed),
                                   hidden, batch["targets"], c)
        if self.ctx.enabled and self.ctx.axis_size(self.ctx.batch_axes) > 1:
            count = comm.all_reduce(count, self.ctx.group(
                self.ctx.batch_axes))
        loss = total / count.clamp(min=1.0)
        return loss, {"nll": loss}

    # ------------------------------------------------------------------
    def cache_shapes(self, batch: int, max_len: int):
        return cache_shapes(self.cfg, batch, max_len)

    def cache_axes(self) -> Dict[str, Tuple]:
        return cache_axes(self.cfg)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        return {name: torch.zeros(shape, dtype=dtype, device=self.device)
                for name, (shape, dtype) in
                self.cache_shapes(batch, max_len).items()}

    def prefill(self, tokens, frames, max_len: Optional[int] = None):
        """Returns (last-token logits [B, 1, V], cache ready at pos=S)."""
        B, Sq = tokens.shape
        enc_out = self.encode(frames)
        hidden, caches = self.decode_parallel(tokens, enc_out,
                                              collect_cache=True)
        logits = self.logits_fn(hidden[:, -1:, :])
        cache = self.init_cache(B, max_len or Sq)
        for i, new in enumerate(caches):
            cache["k"][i, :, :Sq] = new["k"]
            cache["v"][i, :, :Sq] = new["v"]
            cache["xk"][i] = new["xk"]
            cache["xv"][i] = new["xv"]
        return logits, cache

    def decode_step(self, cache, token, pos: int):
        """token [B, 1] at the shared position ``pos`` (an int: the cache
        length).  Writes the new self K/V into ``cache`` in place.
        Returns (logits [B, 1, V], cache)."""
        pos = int(pos)
        x = self._dec_embed(token, pos)
        for i, layer in enumerate(self.dec_layers):
            p = self._layer_params(layer)
            x, _ = self._dec_block(x, p, cache["xk"][i],
                                   cache["xv"][i],
                                   cache=(cache["k"][i], cache["v"][i]),
                                   pos=pos)
        x = L.layer_norm(x, self._top("final_ln"), self._top("final_ln_b"),
                         self.cfg.norm_eps)
        return self.logits_fn(x), cache
