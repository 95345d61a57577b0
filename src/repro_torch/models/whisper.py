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
model runs on the rank's batch rows (each layer's weights gathered in
one pass by ``sharding.gathered``, under grad inside the layer's remat
body), and ``loss`` returns the rank's share of the global loss, as
``LM``'s does; ``param_axes`` and ``cache_axes`` give the JAX twin's
logical axes.  At rest under a ctx whose ``tensor_parallel`` holds it is
tensor-parallel as ``LM`` is (``lm.TensorParallelWeights``): the encoder's
and decoder's self-attention and the cross-attention on the rank's heads
(the cross K/V taken once a call from the whole encoder output, the
cache's K/V the rank's heads), the MLP on its ffn slice with ``b2``
after the region's exit, the embedding, tied head and NLL on its
vocabulary rows; sequence parallel where the frames (1500 on 2 or 4
ranks, not 16) or the tokens split, ``encode`` then returning the rank's
F/n of the frames.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.lm import (_DTYPES, ParamGroup,
                                   TensorParallelWeights, chunked_nll,
                                   remat_layer, stacked)
from repro_torch.sharding import ShardCtx, comm

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


class EncDecLM(TensorParallelWeights, nn.Module):
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
        self._enc_axes = enc_layer_axes(cfg)
        self._dec_axes = dec_layer_axes(cfg)
        self._top_axes = top_axes(cfg)
        self._tp_parts: Optional[Dict[str, bool]] = None

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

    def _top(self, name: str, tp=None) -> torch.Tensor:
        """A top-level weight to compute with (``_weight``: a DTensor
        gathered whole, or under ``tp`` its model-axis piece; under grad
        its gradient lands in its layout)."""
        return self._weight(name, getattr(self.top, name),
                            self._top_axes[name], tp)

    def _layer_params(self, layer, axes, tp=None) -> Dict[str, torch.Tensor]:
        """One layer's weights to compute with (``_weight``, in one pass
        each, as ``LM._layer_params`` gathers them); under no ctx the
        parameters as they are."""
        p = layer.tensors()
        if not self.ctx.enabled:
            return p
        return {n: self._weight(n, w, axes[n], tp) for n, w in p.items()}

    # ------------------------------------------------------------------
    def _ln(self, x, p, name):
        return L.layer_norm(x, p[name], p[name + "_b"], self.cfg.norm_eps)

    def _self_attn(self, x, p, causal: bool, cache=None, pos=None,
                   split: bool = False):
        """Self-attention over ``x`` (no rotation: learned positions).
        Parallel (``cache`` None) through ``attention_chunked``; else one
        token decoded against this layer's (k, v) cache, written at ``pos``
        in place.  ``split``: tensor parallel, on the rank's heads of the
        region's input, the output its partial sum out of ``wo``.
        Returns (output, this call's (k, v))."""
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
        out = out.reshape(B, S, -1)
        return (L.partial_mm(out, p["wo"]) if split else out @ p["wo"],
                (k, v))

    def _cross_attn(self, x, p, xk, xv, split: bool = False):
        """Non-causal attention of ``x`` to the encoder's K/V (B, F, KV,
        hd: the rank's heads under tensor parallelism, ``split``), through
        ``attention_chunked`` at prefill and at decode."""
        cfg = self.cfg
        B, S, _ = x.shape
        q = x @ p["x_wq"]
        if cfg.qkv_bias:
            q = q + p["x_bq"]
        q = q.reshape(B, S, -1, cfg.resolved_head_dim)
        out = L.attention_chunked(q, xk, xv, causal=False,
                                  q_chunk=self.q_chunk).reshape(B, S, -1)
        return L.partial_mm(out, p["x_wo"]) if split else out @ p["x_wo"]

    def _block_mlp(self, x, p, name, tp):
        h = self._ln(x, p, name)
        if tp is None:
            return x + L.mlp(h, p, self.cfg, self.ctx)
        return x + L.mlp_region(h, p, self.cfg, tp, self._splits("mlp"))

    # ------------------------------------------------------------------
    def encode(self, frames):
        """frames: [B, n_frames, d_model] (the stub frontend's output).
        Under tensor parallelism with sequence parallelism (the frames
        split over the model axis: 1500 on 2 or 4 ranks, not 16) the
        output is this rank's F/n of the frames, as ``LM.forward``'s
        hidden states are its S/n of the sequence."""
        cfg = self.cfg
        want = (cfg.encoder.n_frames, cfg.d_model)
        if frames.dim() != 3 or tuple(frames.shape[1:]) != want:
            raise ValueError(f"frames must be [B, {want[0]}, {want[1]}], got "
                             f"{tuple(frames.shape)}")
        tp = self._tp(frames.shape[1])
        x = frames.to(self.dtype)
        pos = self._top("enc_pos", tp).to(self.dtype)
        if tp is not None and tp.sp:
            m = x.shape[1] // tp.n
            x = x[:, tp.rank * m:(tp.rank + 1) * m]
            pos = pos[tp.rank * m:(tp.rank + 1) * m]
        x = self.ctx.constrain(x + pos, "batch", None, None)
        for layer in self.enc_layers:
            def one(x, layer=layer):
                return self._enc_block(x, self._kv_columns(
                    self._layer_params(layer, self._enc_axes, tp), tp), tp)
            x = remat_layer(one, x) if self.remat else one(x)
        return L.layer_norm(x, self._top("enc_final_ln", tp),
                            self._top("enc_final_ln_b", tp),
                            cfg.norm_eps)

    def _enc_block(self, x, p, tp=None):
        split = self._part_tp("attn", tp) is not None
        a, _ = self._region(self._ln(x, p, "ln1"), lambda h: self._self_attn(
            h, p, False, split=split), "attn", tp)
        return self._block_mlp(x + a, p, "ln2", tp)

    def _dec_embed(self, tokens, pos0: int, tp=None):
        """The tokens' embeddings plus their learned positions; under
        ``tp`` vocab-parallel, and this rank's S/n of the sequence under
        sequence parallelism."""
        vtp = self._part_tp("vocab", tp)
        if vtp is None:
            x = F.embedding(tokens, self._top("embed")).to(self.dtype)
            if tp is not None:
                x = tp.rows(x)
        else:
            x = tp.exit(L.vocab_embed(tokens, self._top("embed", tp),
                                      self._vocab_lo(tp))).to(self.dtype)
        lo = tp.rank * x.shape[1] if tp is not None and tp.sp else 0
        positions = pos0 + lo + torch.arange(x.shape[1],
                                             device=tokens.device)
        x = x + self._top("dec_pos", tp)[positions].to(self.dtype)
        return self.ctx.constrain(x, "batch", None, None)

    def _cross_kv(self, p, enc_out):
        """One decoder layer's cross K/V of the encoder output (whole,
        every frame): [B, F, KV, hd] each (the rank's heads of ``p``'s
        columns under tensor parallelism)."""
        cfg = self.cfg
        k, v = enc_out @ p["x_wk"], enc_out @ p["x_wv"]
        if cfg.qkv_bias:
            k, v = k + p["x_bk"], v + p["x_bv"]
        B, Fr = enc_out.shape[:2]
        shape = (B, Fr, -1, cfg.resolved_head_dim)
        return k.reshape(shape), v.reshape(shape)

    def _cross_input(self, enc_out, tp):
        """The encoder output the cross K/V are taken from, once a call:
        under tensor parallelism every frame (gathered when the encoder
        ran sequence parallel), entered once as the region input of every
        layer's column-parallel ``x_wk``/``x_wv`` where attention splits
        (its backward sums the ranks' partial gradients), else whole rows
        every rank uses alike."""
        if tp is None:
            return enc_out
        etp = L.TensorParallel(self.ctx, sp=enc_out.shape[1]
                               != self.cfg.encoder.n_frames)
        return etp.enter(enc_out) if self._splits("attn") \
            else etp.whole(enc_out)

    def _kv_columns(self, p, tp):
        """``p`` with its KV projections' columns those of the KV heads
        the rank's query heads use (``TensorParallel.kv_columns``)."""
        if tp is None or not self._splits("attn"):
            return p
        return {**p, **{n: tp.kv_columns(p[n], self.cfg)
                        for n in ("wk", "wv", "bk", "bv", "x_wk", "x_wv",
                                  "x_bk", "x_bv") if n in p}}

    def _dec_block(self, x, p, xk, xv, cache=None, pos=None, tp=None):
        split = self._part_tp("attn", tp) is not None
        a, kv = self._region(self._ln(x, p, "ln1"), lambda h: self._self_attn(
            h, p, True, cache, pos, split), "attn", tp)
        x = x + a
        c, _ = self._region(self._ln(x, p, "ln2"), lambda h: (
            self._cross_attn(h, p, xk, xv, split), None), "attn", tp)
        return self._block_mlp(x + c, p, "ln3", tp), kv

    def decode_parallel(self, tokens, enc_out, *,
                        collect_cache: bool = False):
        """Causal decoder over [B, S] attending to ``enc_out`` (as
        ``encode`` gives it).  Returns (hidden, caches): with
        ``collect_cache`` the per-layer list of ``{"k", "v"}`` (self, [B,
        S, KV, hd]) and ``{"xk", "xv"}`` (cross, [B, F, KV, hd]), else
        None.  Under tensor parallelism the KV heads are the rank's where
        attention splits, and under sequence parallelism ``hidden`` is this
        rank's S/n of the sequence."""
        tp = self._tp(tokens.shape[1])
        x = self._dec_embed(tokens, 0, tp)
        enc = self._cross_input(enc_out, tp)
        caches: List[Dict[str, torch.Tensor]] = []
        for layer in self.dec_layers:
            def one(x, layer=layer):
                p = self._kv_columns(
                    self._layer_params(layer, self._dec_axes, tp), tp)
                xk, xv = self._cross_kv(p, enc)
                x, (k, v) = self._dec_block(x, p, xk, xv, tp=tp)
                return x, {"k": k, "v": v, "xk": xk, "xv": xv}
            x, new = remat_layer(one, x) if self.remat else one(x)
            if collect_cache:
                caches.append(new)
        x = L.layer_norm(x, self._top("final_ln", tp),
                         self._top("final_ln_b", tp), self.cfg.norm_eps)
        return x, (caches if collect_cache else None)

    def _embed_whole(self, tp=None) -> torch.Tensor:
        """The embedding to take logits with (tied), gathered as
        ``_layer_params`` gathers a layer's weights; under ``tp`` (where
        the vocabulary splits) this rank's rows."""
        return self._top("embed", tp)

    def logits_fn(self, hidden, embed: Optional[torch.Tensor] = None):
        """Tied embeddings; the padded vocabulary's logits are -1e30.
        ``embed`` (``_embed_whole()``) when the caller gathered it.  Under
        tensor parallelism (no ``embed``) each rank's vocabulary columns
        (``layers.vocab_logits``) gathered over the model axis, so every
        rank picks the same token."""
        cfg = self.cfg
        if embed is None:
            tp = self._part_tp("vocab", self._tp(1))
            if tp is not None:
                part = L.vocab_logits(hidden, self._embed_whole(tp).T,
                                      self._vocab_lo(tp), cfg.vocab_size)
                return comm.all_gather(part, tp.group, part.dim() - 1)
            embed = self._embed_whole()
        logits = (hidden @ embed.T).float()
        if cfg.padded_vocab() != cfg.vocab_size:
            logits[..., cfg.vocab_size:] = L.NEG_INF
        return self.ctx.constrain(logits, "batch", None, "vocab")

    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {'frames': [B,F,d], 'tokens': [B,S], 'targets': [B,S]}
        (-1 = padding).  Returns (loss, {"nll": loss}); under tensor
        parallelism a vocab-parallel NLL (``layers.vocab_parallel_nll``)."""
        enc_out = self.encode(batch["frames"])
        hidden, _ = self.decode_parallel(batch["tokens"], enc_out)
        tp = self._tp(batch["tokens"].shape[1])
        vtp = self._part_tp("vocab", tp)
        if vtp is not None:    # the rows' whole sequence, on the rank's vocab
            hidden = tp.enter(hidden)
        elif tp is not None:
            hidden = tp.whole(hidden)
        c = min(self.loss_chunk, hidden.shape[1])
        assert hidden.shape[1] % c == 0
        embed = self._embed_whole(vtp)            # once for every chunk
        if vtp is None:
            total, count = chunked_nll(lambda h: self.logits_fn(h, embed),
                                       hidden, batch["targets"], c)
        else:
            lo = self._vocab_lo(vtp)
            total, count = chunked_nll(
                lambda h: L.vocab_logits(h, embed.T, lo,
                                         self.cfg.vocab_size),
                hidden, batch["targets"], c, vocab=(lo, vtp.group))
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
        """A zero cache of ``batch`` rows; under tensor parallelism where
        attention splits its self and cross K/V hold the KV heads of the
        rank's query heads."""
        tp = self._part_tp("attn", self._tp(1))
        cache = {}
        for name, (shape, dtype) in self.cache_shapes(batch,
                                                      max_len).items():
            if tp is not None:
                lo, hi = tp.kv_range(self.cfg)
                shape = shape[:3] + (hi - lo,) + shape[4:]
            cache[name] = torch.zeros(shape, dtype=dtype, device=self.device)
        return cache

    def prefill(self, tokens, frames, max_len: Optional[int] = None):
        """Returns (last-token logits [B, 1, V], cache ready at pos=S)."""
        B, Sq = tokens.shape
        tp = self._tp(Sq)
        enc_out = self.encode(frames)
        hidden, caches = self.decode_parallel(tokens, enc_out,
                                              collect_cache=True)
        if tp is not None and tp.sp:     # the whole sequence of the rows
            hidden = comm.all_gather(hidden, tp.group, 1)
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
        tp = self._tp(token.shape[1])
        x = self._dec_embed(token, pos, tp)
        for i, layer in enumerate(self.dec_layers):
            p = self._kv_columns(
                self._layer_params(layer, self._dec_axes, tp), tp)
            x, _ = self._dec_block(x, p, cache["xk"][i],
                                   cache["xv"][i],
                                   cache=(cache["k"][i], cache["v"][i]),
                                   pos=pos, tp=tp)
        x = L.layer_norm(x, self._top("final_ln", tp),
                         self._top("final_ln_b", tp), self.cfg.norm_eps)
        return self.logits_fn(x), cache
