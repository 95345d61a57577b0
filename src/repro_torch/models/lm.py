"""Decoder-only LM covering the dense / vlm / moe / hybrid / ssm families,
as an ``nn.Module``.

Port of ``repro.models.lm``.  Layers are an ``nn.ModuleList`` run by an
explicit Python loop (the JAX twin scans stacked layers with remat).
Parameters keep the JAX package's names and ``[in, out]`` layout;
``models.convert.params_from_jax`` turns a JAX parameter tree into this
module's state dict.

Entry points:
  loss(batch)                         — mean next-token NLL (+ the moe aux
                                        loss), chunked over the sequence
  forward(tokens)                     — parallel forward → hidden states
  prefill(tokens, max_len, lengths)   — last-token logits + cache: K/V
                                        (every family but ssm; int8 with
                                        per-position scales under
                                        ``kv_quant``) and the recurrent
                                        state (ssm: wkv, token shifts;
                                        hybrid: conv tail, SSD state)
  decode_step(cache, token, pos)      — one token per row; the cache is
                                        updated in place

vlm is the dense path (its image tokens are vocabulary entries); a moe
layer has ``moe_block`` where the others have the MLP.

Sharded (``ctx``, a ``repro_torch.sharding.ShardCtx`` on a mesh of
``torch.distributed`` ranks), every entry point takes and returns the
rank's own shard: the batch rows of its data axes and, under the ``cp``
preset, its S/n of the sequence (positions counted from
``rank · S/n``).  There attention gathers K/V over the model axis and runs
the query shard with a causal offset, and the recurrent scans (rwkv's
block, hymba's mamba heads) and the MoE block, which need the whole
sequence of their rows, run on it gathered and keep their shard of the
result.  Decode under ``decode_kv`` ``tp_seq`` / ``dp_seq`` holds the
cache's sequence split over the model / data axes (``init_cache`` and
``prefill`` lay it out so) and combines the shards' partial softmaxes.
``param_axes`` and ``cache_axes`` give the JAX twin's logical axes over
its stacked tree (``param_shapes``, ``cache_shapes``).  ``loss`` under a
ctx that splits the tokens returns the rank's share of the global loss
(its summed NLL over the global count, and a moe model's share of the
global batch's aux term); the shares sum to the loss.  Weights at rest
(``train.steps.rest_sharded``) are gathered a layer at a time inside the
layer's remat body, differentiably under grad (``sharding.gathered``:
the backward lands each gradient in its weight's layout), so a train step
at rest holds one layer whole at a time, as the JAX twin's FSDP scan
does.

Tensor parallelism (the JAX twin's GSPMD layout of its rules on the
model axis): a model at rest under a ctx whose ``tensor_parallel`` holds
(``default``, ``ep``) gathers each weight over its FSDP axes alone and
computes with its model-axis piece (``ShardCtx.fsdp_spec``), part by
part (``split_parts``): attention on the rank's H/n query heads and the
KV heads they use, the MLP and the experts on its ffn slice (or its
experts under ``ep``), hymba's mamba mixer on its H_m/n heads, RWKV's
time mix on its heads and its channel mix on its ffn slice and d/n gate
columns, the embedding, head and NLL on its vocabulary rows
(``layers.TensorParallel``).  A part that does not split (hymba's 25
attention heads on 2, 4 or 16 ranks) computes whole rows on every model
rank, as GSPMD's divisibility fallback does; in the dense, vlm and moe
families such a part keeps the whole model on whole rows
(``WHOLE_OR_NONE``).  Entry points take the rank's rows and the whole
sequence; under sequence parallelism (``seq_shard``, a sequence that
splits) the residual stream and ``forward``'s hidden states are the
rank's S/n of the sequence, and ``prefill``, ``decode_step`` and
``generate()`` hand back the whole logits.  The cache holds the rank's
KV heads and recurrent state (wkv and ssm heads, conv channels) of the
parts that split.  A model with whole weights computes whole rows on
every model rank.

Parameters are made with ``requires_grad=False``, so serving builds no
autograd graph; ``train.steps.make_train_step`` switches it on for the
length of a step.  With ``remat`` (the default, as in the JAX twin) a
forward under grad runs each layer in ``torch.utils.checkpoint``, the
counterpart of ``jax.checkpoint``: the layer is recomputed in the backward
pass instead of keeping its activations.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.sharding import Layout, ShardCtx, comm, gathered
from repro_torch.sharding.ctx import _is_dtensor, _names

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the cache entries held per position (written at [:S] by prefill and at
# ``pos`` by decode); every other entry is a recurrent state, whole per row
KV_ENTRIES = ("k", "v", "k_scale", "v_scale")
# the families whose tensor parallelism is all or nothing (a part that
# does not split keeps the whole model on whole rows); the others decide
# part by part (``split_parts``)
WHOLE_OR_NONE = ("dense", "vlm", "moe")
# under tensor parallelism: weights every model rank holds whole whose
# gradient is partial on each (used on the rank's own heads, channels or
# columns), and those used on the rank's own S/n of the sequence under
# sequence parallelism
_TP_MODEL_SUMMED = ("q_scale", "k_scale", "wk", "wv", "bk", "bv",
                    "x_wk", "x_wv", "x_bk", "x_bv",
                    "mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "decay_lora_a",
                    "ln_x_scale", "ln_x_bias", "mu_ck", "mu_cr")
_TP_SEQ_SUMMED = ("ln1", "ln2", "ln3", "final_ln", "b2", "attn_out_ln",
                  "mamba_out_ln", "ln1_b", "ln2_b", "ln3_b", "final_ln_b",
                  "enc_final_ln", "enc_final_ln_b", "enc_pos", "dec_pos")
# the recurrent cache entries tensor parallelism splits: name → (the
# part whose split splits it, its dim, the layer axis first)
_STATE_SPLITS = {"wkv": ("time_mix", 2), "ssm": ("mamba", 2),
                 "conv": ("mamba", 3)}
# the part of a block each weight belongs to (``part_of``)
_PARTS = {
    "attn": ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "q_scale", "k_scale"),
    "mlp": ("w1", "w2", "w3", "b1", "b2", "router", "we1", "we2", "we3",
            "ws1", "ws2", "ws3", "ws_gate"),
    "time_mix": ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w_r", "w_k", "w_v",
                 "w_g", "w_o", "decay_base", "decay_lora_a", "decay_lora_b",
                 "bonus_u", "ln_x_scale", "ln_x_bias"),
    "channel_mix": ("mu_ck", "mu_cr", "cm_k", "cm_v", "cm_r"),
    "vocab": ("embed", "lm_head"),
}
_PART_OF = {n: part for part, names in _PARTS.items() for n in names}


def part_of(name: str) -> Optional[str]:
    """The part of a block (or the vocabulary) the weight ``name`` belongs
    to: ``attn`` (whisper's cross-attention ``x_*`` too), ``mlp`` (the
    MoE block's too), ``mamba``, ``time_mix``, ``channel_mix``,
    ``vocab``; None for the norms and positions, which every part's
    rank uses."""
    if name.startswith("mamba_"):
        return "mamba"
    if name.startswith("x_"):
        name = name[2:]
    return _PART_OF.get(name)


def split_parts(cfg: ModelConfig, ctx: ShardCtx) -> Dict[str, bool]:
    """part → whether tensor parallelism splits it over ``ctx``'s model
    axis: its weights' ``fsdp_spec`` put the axis on their split dim
    (the heads, ffn, expert ffn or experts, d_in, vocabulary rows) and
    each rank gets whole heads: attention where
    ``TensorParallel.splits_heads``, the mamba mixer where its heads
    divide (each rank's d_in/n channels are then its heads), the RWKV
    time mix where its heads divide.  A part that does not split keeps
    whole rows (GSPMD's divisibility fallback computes such a dim whole)."""
    n = ctx.axis_size(ctx.tp)

    def on_model(axes, shape):
        return any(ctx.tp in _names(e) for e in ctx.fsdp_spec(axes, shape))

    d = cfg.d_model
    parts = {"vocab": on_model(("vocab", "d_model"),
                               (cfg.padded_vocab(), d))}
    if cfg.family == "ssm":
        H = d // cfg.ssm.head_dim
        heads = on_model(("d_model", "heads"), (d, d))
        parts["time_mix"] = heads and H % n == 0
        parts["channel_mix"] = heads and on_model(("d_model", "ffn"),
                                                  (d, cfg.d_ff))
        return parts
    parts["attn"] = (L.TensorParallel(ctx, False).splits_heads(cfg)
                     and on_model(("d_model", "heads"), (d, cfg.q_dim)))
    if cfg.family == "moe":
        m = cfg.moe
        parts["mlp"] = all(on_model(a, sh) for a, sh in (
            (("experts", "d_model", "expert_ffn"),
             (m.n_experts, d, m.d_ff_expert)),
            (("experts", "expert_ffn", "d_model"),
             (m.n_experts, m.d_ff_expert, d))))
    else:
        parts["mlp"] = on_model(("d_model", "ffn"), (d, cfg.d_ff))
    if cfg.family == "hybrid":
        d_in, hm, _ = SSM.mamba_dims(cfg)
        parts["mamba"] = hm % n == 0 and on_model(("ffn", "d_model"),
                                                  (d_in, d))
    return parts


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
    if cfg.family == "moe":
        spec.update(L.moe_param_spec(cfg))
    else:
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


def layer_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """name → logical axes of one layer's parameters."""
    if cfg.family == "ssm":
        return {"ln1": (None,), "ln2": (None,), **SSM.rwkv_param_axes(cfg)}
    axes = {"ln1": (None,), **L.attn_param_axes(cfg)}
    if not cfg.parallel_block:
        axes["ln2"] = (None,)
    axes.update(L.moe_param_axes(cfg) if cfg.family == "moe"
                else L.mlp_param_axes(cfg))
    if cfg.family == "hybrid":
        axes.update({f"mamba_{k}": v
                     for k, v in SSM.mamba_param_axes(cfg).items()})
        axes["attn_out_ln"] = (None,)
        axes["mamba_out_ln"] = (None,)
    return axes


def top_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    axes = {"embed": ("vocab", "d_model"), "final_ln": (None,)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("d_model", "vocab")
    return axes


def stacked(layer: Dict, top: Dict, stack: str, lead) -> Dict:
    """The JAX twin's tree of a model: ``stack`` → one layer's leaves
    with ``lead(leaf)`` prepended (the stacked layer axis), and the top
    leaves beside it."""
    return {stack: {k: lead(v) for k, v in layer.items()}, **top}


def param_axes(cfg: ModelConfig):
    """Logical axes over the JAX twin's stacked parameter tree."""
    return stacked(layer_axes(cfg), top_axes(cfg), "layers",
                   lambda a: ("layer",) + a)


def param_shapes(cfg: ModelConfig):
    """Shapes over the JAX twin's stacked parameter tree."""
    return stacked(layer_spec(cfg), top_spec(cfg), "layers",
                   lambda sh: (cfg.n_layers,) + sh)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 kv_quant: bool = False):
    """name → (shape, dtype) of the decode cache: K/V for the attention
    families (int8, with bf16 ``k_scale``/``v_scale`` a position and kv
    head, under ``kv_quant``), the recurrent state (f32 for wkv/ssm) for
    ssm/hybrid; every entry has the layer axis first."""
    dtype = _DTYPES[cfg.param_dtype]
    Lc = cfg.n_layers
    shapes = {}
    if cfg.family != "ssm":
        kv = (Lc, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        kv_dtype = torch.int8 if kv_quant else dtype
        shapes["k"] = (kv, kv_dtype)
        shapes["v"] = (kv, kv_dtype)
        if kv_quant:
            sc = (Lc, batch, max_len, cfg.n_kv_heads, 1)
            shapes["k_scale"] = (sc, torch.bfloat16)
            shapes["v_scale"] = (sc, torch.bfloat16)
    if cfg.family == "hybrid":
        ms = SSM.mamba_state_shape(cfg, batch)
        shapes["conv"] = ((Lc,) + ms["conv"], dtype)
        shapes["ssm"] = ((Lc,) + ms["ssm"], torch.float32)
    if cfg.family == "ssm":
        rs = SSM.rwkv_state_shape(cfg, batch)
        shapes["wkv"] = ((Lc,) + rs["wkv"], torch.float32)
        shapes["shift_tm"] = ((Lc,) + rs["shift_tm"], dtype)
        shapes["shift_cm"] = ((Lc,) + rs["shift_cm"], dtype)
    return shapes


def cache_axes(cfg: ModelConfig, kv_quant: bool = False) -> Dict[str, Tuple]:
    """Logical axes of ``cache_shapes``' entries."""
    ax: Dict[str, Tuple] = {}
    if cfg.family != "ssm":
        for name in ("k", "v") + (("k_scale", "v_scale")
                                  if kv_quant else ()):
            ax[name] = ("layer", "batch", "kv_seq", "kv_heads", None)
    if cfg.family == "hybrid":
        ax["conv"] = ("layer", "batch", None, "ffn")
        ax["ssm"] = ("layer", "batch", "heads", None, None)
    if cfg.family == "ssm":
        ax["wkv"] = ("layer", "batch", "heads", None, None)
        ax["shift_tm"] = ("layer", "batch", None)
        ax["shift_cm"] = ("layer", "batch", None)
    return ax


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


def chunked_nll(logits_fn, hidden, targets, chunk: int, vocab=None):
    """(summed NLL, count of valid targets), both f32 0-d, of ``hidden``
    [B, S, d] against ``targets`` [B, S] (``-1`` = padding), taking the
    logits of ``chunk`` positions at a time, as the JAX twins' ``loss``
    scans over chunks (the caller checks that ``chunk`` divides S).
    ``vocab`` (lo, group): ``logits_fn`` gives the rank's vocabulary
    columns from ``lo`` on, and the NLL is vocab-parallel over ``group``
    (``layers.vocab_parallel_nll``)."""
    total = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for start in range(0, hidden.shape[1], chunk):
        t = targets[:, start:start + chunk].long()
        logits = logits_fn(hidden[:, start:start + chunk])
        valid = t >= 0
        tsafe = torch.where(valid, t, 0)
        if vocab is None:
            nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1,
                                tsafe[..., None])[..., 0]
        else:
            nll = L.vocab_parallel_nll(logits, tsafe, *vocab)
        total = total + (nll * valid).sum()
        count = count + valid.sum()
    return total, count


def remat_layer(fn, x):
    """``fn(x)`` through ``torch.utils.checkpoint`` (the layer recomputed in
    the backward pass) when autograd records ``x``; plainly otherwise, so
    serving and CUDA-graph capture are unchanged.  The recompute runs under
    the torch-function modes the forward ran under (the backward pass runs
    under none), so ``core.extraction`` names its products as it named the
    forward's."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return fn(x)
    modes = torch.overrides._get_current_function_mode_stack()

    @contextlib.contextmanager
    def forward_modes():
        with contextlib.ExitStack() as scope:
            for mode in modes:
                scope.enter_context(mode)
            yield

    return torch.utils.checkpoint.checkpoint(
        fn, x, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), forward_modes()))


class TensorParallelWeights:
    """Tensor parallelism's decision and weights, shared by ``LM`` and
    ``whisper.EncDecLM`` (each has ``cfg``, ``ctx``, ``top`` and
    ``_tp_parts``, None until the first call that asks)."""

    def _tp(self, S: int) -> Optional[L.TensorParallel]:
        """This call's ``layers.TensorParallel`` over ``S`` positions of
        each row, or None: the weights are at rest, the ctx's
        ``tensor_parallel`` holds and some part splits over the model axis
        (``split_parts``; in ``WHOLE_OR_NONE``'s families every part must).
        Sequence parallel when the ctx's ``seq_shard`` is on and S splits
        over the axis."""
        ctx = self.ctx
        if not (ctx.tensor_parallel and _is_dtensor(self.top.embed)):
            return None
        n = ctx.axis_size(ctx.tp)
        if n == 1:
            return None
        if self._tp_parts is None:
            self._tp_parts = split_parts(self.cfg, ctx)
        parts = self._tp_parts.values()
        if not any(parts) or (self.cfg.family in WHOLE_OR_NONE
                              and not all(parts)):
            return None
        return L.TensorParallel(ctx, sp=ctx.seq_shard and S % n == 0)

    def _splits(self, part: Optional[str]) -> bool:
        """Whether ``part`` (``part_of``; None: a norm or a position every
        part uses) splits; asked only under a ``_tp`` (a part the family
        lacks does not)."""
        return part is None or self._tp_parts.get(part, False)

    def _part_tp(self, part: str, tp):
        """``tp`` where ``part`` splits, else None (its whole rows)."""
        return tp if tp is not None and self._splits(part) else None

    def _region(self, h, fn, part: str, tp, **kw):
        """``fn(h)`` → (out, extra) with no tensor parallelism (``tp``
        None), else ``part``'s region (``TensorParallel.region``, its
        keywords ``kw``)."""
        if tp is None:
            return fn(h)
        return tp.region(h, fn, self._splits(part), **kw)

    def _weight(self, name: str, w, axes, tp=None) -> torch.Tensor:
        """A weight to compute with, gathered in one pass by ``gathered``
        (under grad its gradient lands in its layout): whole, or under
        tensor parallelism (``tp``) where its part splits, this rank's
        piece of its ``fsdp_spec`` layout, gathered over its FSDP axes
        alone (the router whole), its gradient summed over the model axis
        too where every model rank holds it whole but computes a part
        with it (``_TP_MODEL_SUMMED``; ``_TP_SEQ_SUMMED`` under sequence
        parallelism).  The weights of a part that does not split are
        whole, their gradient not summed over the model axis: every model
        rank computes that part alike."""
        ctx = self.ctx
        if tp is not None and not self._splits(part_of(name)):
            tp = None
        if tp is None:
            return gathered(w, ctx.batch_axes)
        kept = None if name == "router" else Layout(
            ctx, ctx.fsdp_spec(axes, w.shape))
        summed = tuple(ctx.batch_axes)
        split = kept is not None and any(ctx.tp in _names(e)
                                         for e in kept.spec)
        if not split and (name in _TP_MODEL_SUMMED
                          or (tp.sp and name in _TP_SEQ_SUMMED)):
            summed += (ctx.tp,)
        return gathered(w, summed, kept)

    def _vocab_lo(self, tp) -> int:
        """The first vocabulary row of this rank's piece."""
        return tp.rank * (self.cfg.padded_vocab() // tp.n)


class LM(TensorParallelWeights, nn.Module):
    def __init__(self, cfg: ModelConfig, ctx: Optional[ShardCtx] = None, *,
                 device="cuda", kv_quant: bool = False, q_chunk: int = 256,
                 loss_chunk: int = 1024, remat: bool = True):
        super().__init__()
        if cfg.family not in ("dense", "vlm", "moe", "hybrid", "ssm"):
            raise ValueError(
                f"LM runs the decoder-only families (dense, vlm, moe, hybrid, "
                f"ssm), not {cfg.family!r}: models.get_model builds the "
                "model of an encdec config (models.whisper.EncDecLM)")
        self.cfg = cfg
        self.ctx = ctx or ShardCtx.null()
        self._cp = self.ctx.enabled and self.ctx.attn_impl == "cp"
        self._layer_axes = layer_axes(cfg)
        self._top_axes = top_axes(cfg)
        self._tp_parts: Optional[Dict[str, bool]] = None
        # int8 KV cache with per-(position, kv-head) bf16 scales: 130/256
        # of a bf16 cache's bytes at head_dim 128
        self.kv_quant = kv_quant
        # query rows a chunk of the plain attention (its score buffer)
        self.q_chunk = q_chunk
        self.loss_chunk = loss_chunk
        self.remat = remat
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

    def param_axes(self):
        return param_axes(self.cfg)

    def param_shapes(self):
        return param_shapes(self.cfg)

    def _top(self, name: str, tp=None) -> torch.Tensor:
        """A top-level weight to compute with (``_weight``)."""
        return self._weight(name, getattr(self.top, name),
                            self._top_axes[name], tp)

    def _layer_params(self, layer, tp=None) -> Dict[str, torch.Tensor]:
        """One layer's weights to compute with (``_weight``); under no ctx
        the parameters as they are."""
        p = layer.tensors()
        if not self.ctx.enabled:
            return p
        return {n: self._weight(n, w, self._layer_axes[n], tp)
                for n, w in p.items()}

    def _head(self, tp=None) -> torch.Tensor:
        """The [d, V] logits weight to compute with (the embedding's
        transpose when tied); under ``tp`` (where the vocabulary splits)
        this rank's [d, V/n]."""
        return (self._top("embed", tp).T if self.cfg.tie_embeddings
                else self._top("lm_head", tp))

    def _whole_sequence(self, fn, x):
        """``fn`` (returning (out, state)) on the whole sequence of this
        rank's rows under cp, keeping this rank's shard of ``out``; the
        state is the whole sequence's."""
        if not self._cp:
            return fn(x)
        S = x.shape[1]
        out, state = fn(comm.gather_grad(x, self.ctx.group(self.ctx.tp), 1))
        lo = self.ctx.index(self.ctx.tp) * S
        return out[:, lo:lo + S], state

    def sequence_length(self, local_len: int) -> int:
        """The whole sequence's length of a rank's ``local_len`` tokens:
        n times it under context parallelism over n ranks."""
        return local_len * (self.ctx.axis_size(self.ctx.tp) if self._cp
                            else 1)

    def _kv_seq_axes(self):
        """The mesh axes the decode cache's sequence is split over, or
        None."""
        if not self.ctx.enabled:
            return None
        return {"tp_seq": (self.ctx.tp,), "dp_seq": tuple(self.ctx.dp)
                }.get(self.ctx.decode_kv)

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------
    def _decode_attention(self, q, k, v, cache, pos):
        """One token's attention at ``pos``: K/V written into this layer's
        ``cache`` in place (quantized under ``kv_quant``; on the rank that
        holds ``pos`` when the cache's sequence is split), then attended
        over the cache (the shards' partial softmaxes combined when
        split)."""
        cfg, ctx = self.cfg, self.ctx
        kv = {"k": k, "v": v}
        if self.kv_quant:
            for name in ("k", "v"):
                kv[name], kv[f"{name}_scale"] = L.kv_quantize(kv[name])
        seq_axes = self._kv_seq_axes()
        for name, t in kv.items():
            if seq_axes is None:
                L.cache_update(cache[name], t, pos)
            else:
                L.sharded_cache_update(
                    cache[name], t, pos,
                    ctx.index(seq_axes) * cache[name].shape[1])
        length = L.decode_lengths(pos, q.shape[0], q.device)
        scales = {n: cache[n] for n in ("k_scale", "v_scale") if n in kv}
        if seq_axes is None:
            return L.attention_decode(q, cache["k"], cache["v"], length,
                                      cfg.logit_softcap, **scales)
        return L.flash_decode_sharded(q, cache["k"], cache["v"], ctx,
                                      length, seq_axes=seq_axes, **scales)

    def _tp_attention(self, h, p, positions, tp, cache, pos):
        """Attention under tensor parallelism on ``h``, the region's input
        where attention splits (then the rank's query heads and the KV
        heads they use, its partial sum out of ``wo``), else the whole
        rows (every head, the whole output).  Returns (out, {"k", "v"}).
        At decode the cache holds the rank's KV heads, or, its sequence
        split (``tp_seq``), every head: under a split, q and the new K/V
        are then gathered over the model axis, and the rank multiplies its
        own heads of the attention by its rows of ``wo``."""
        cfg = self.cfg
        B, S, _ = h.shape
        split = self._splits("attn")
        if split:
            p = {**p, **{n: tp.kv_columns(p[n], cfg)
                         for n in ("wk", "wv", "bk", "bv") if n in p}}
        q, k, v = L._project_qkv(h, p, cfg, positions)
        if cache is None:
            att = L.attention_chunked(q, k, v, causal=True,
                                      q_chunk=self.q_chunk,
                                      softcap=cfg.logit_softcap)
        elif not split or self._kv_seq_axes() is None:
            att = self._decode_attention(q, k, v, cache, pos)
        else:
            att = tp.own_heads(self._decode_attention(
                *tp.all_qkv_heads(q, k, v, cfg), cache, pos), cfg.n_heads)
        att = att.reshape(B, S, -1)
        out = L.partial_mm(att, p["wo"]) if split else att @ p["wo"]
        return out, {"k": k, "v": v}

    def _tp_block(self, x, p, positions, tp, cache=None, pos=None,
                  need_state: bool = False, want_aux: bool = False):
        """``_block`` under tensor parallelism (``tp``): ``x`` is this
        rank's S/n of the sequence under sequence parallelism, else the
        whole rows.  Each part is a region (``TensorParallel.region``):
        split, column-parallel into the rank's heads, channels or ffn
        slice and row-parallel out (attention, the MLP or the MoE block,
        hymba's mamba heads, RWKV's time and channel mix), or whole rows
        where it does not split (``split_parts``).  A parallel block
        (command-r) shares one region's entry and exit between attention
        and the MLP; hymba's two branches share ``ln1``'s rows, gathered
        once, and each leaves its region before its own norm."""
        cfg, ctx = self.cfg, self.ctx
        if cfg.family == "ssm":
            return self._rwkv_block(x, p, cache, need_state, tp)
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        if cfg.parallel_block:           # dense: every part splits
            h_in = tp.enter(h)
            part, new = self._tp_attention(h_in, p, positions, tp, cache,
                                           pos)
            out = tp.exit(part + L.tp_mlp(h_in, p, cfg)).to(x.dtype)
            if cfg.mlp_bias:
                out = out + p["b2"]
            return x + out, new
        if cfg.family == "hybrid":
            x, new = self._tp_hybrid_mixers(x, h, p, positions, tp, cache,
                                            pos, need_state)
        else:
            attn_out, new = self._region(h, lambda hs: self._tp_attention(
                hs, p, positions, tp, cache, pos), "attn", tp)
            x = x + attn_out
        h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if cfg.family == "moe":          # every part splits
            xw = tp.whole(h2)
            if want_aux:
                new["aux"] = L.moe_aux_loss(xw, p, cfg, ctx)
            return x + tp.exit(L.tp_moe(xw, p, cfg, tp)).to(x.dtype), new
        return x + L.mlp_region(h2, p, cfg, tp, self._splits("mlp")), new

    def _tp_hybrid_mixers(self, x, h, p, positions, tp, cache, pos,
                          need_state):
        """hymba's attention and mamba branches under tensor parallelism,
        on ``ln1``'s rows ``h``: each branch a region of its own, split or
        on whole rows (25 heads and 5 KV heads split over no model axis of
        2, 4 or 16; 50 mamba heads over 2).  Where one branch keeps whole
        rows, the rows are gathered once (``whole``) and the split branch
        enters from them (``sum_grads``).  Each branch leaves its region
        before its own norm (over d); returns (x, the cache entries)."""
        cfg = self.cfg
        mp = {name[len("mamba_"):]: t for name, t in p.items()
              if name.startswith("mamba_")}
        m_state = None if cache is None else {"conv": cache["conv"],
                                              "ssm": cache["ssm"]}
        hw = None if self._splits("attn") and self._splits("mamba") \
            else tp.whole(h)
        attn_out, new = self._region(h, lambda hs: self._tp_attention(
            hs, p, positions, tp, cache, pos), "attn", tp, whole=hw)
        mamba_out, m_new = self._region(h, lambda hs: SSM.mamba_block(
            hs, mp, cfg, state=m_state, need_state=need_state,
            tp=self._part_tp("mamba", tp)), "mamba", tp, whole=hw)
        # mean of per-branch normalized outputs (hymba parallel heads)
        attn_out = L.rms_norm(attn_out, p["attn_out_ln"], cfg.norm_eps)
        mamba_out = L.rms_norm(mamba_out, p["mamba_out_ln"], cfg.norm_eps)
        new.update(conv=m_new["conv"], ssm=m_new["ssm"].float())
        return x + 0.5 * (attn_out + mamba_out), new

    def _block(self, x, p, positions, cache=None, pos=None,
               need_state: bool = False, want_aux: bool = False, tp=None):
        """One block.  With ``cache`` (this layer's slice of the decode
        cache) it decodes one token: K/V are written at ``pos`` in place,
        attention runs over the cache, and the recurrent state continues
        from the cache.  Returns (x, this call's cache entries: k/v of the
        call, the new recurrent state).  ``need_state``: the caller keeps
        the recurrent state of a parallel call (prefill).  ``want_aux``: a
        moe layer adds its load-balancing loss (f32 0-d) as ``new["aux"]``.
        """
        if tp is not None:
            return self._tp_block(x, p, positions, tp, cache, pos,
                                  need_state, want_aux)
        cfg, ctx = self.cfg, self.ctx
        B, S, _ = x.shape
        if cfg.family == "ssm":
            if cache is None:
                return self._whole_sequence(
                    lambda xs: self._rwkv_block(xs, p, None, need_state), x)
            return self._rwkv_block(x, p, cache, need_state)
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = L._project_qkv(h, p, cfg, positions, ctx)
        if cache is None and self._cp:
            att, k, v = L.attention_context_parallel(
                q, k, v, ctx=ctx, q_chunk=self.q_chunk,
                softcap=cfg.logit_softcap)
        elif cache is None:
            att = L.attention_chunked(q, k, v, causal=True,
                                      q_chunk=self.q_chunk,
                                      softcap=cfg.logit_softcap)
        else:
            att = self._decode_attention(q, k, v, cache, pos)
        attn_out = att.reshape(B, S, -1) @ p["wo"]
        new = {"k": k, "v": v}
        if cfg.family == "hybrid":
            mp = {name[len("mamba_"):]: t for name, t in p.items()
                  if name.startswith("mamba_")}
            m_state = None if cache is None else {"conv": cache["conv"],
                                                  "ssm": cache["ssm"]}
            mamba_out, m_new = self._whole_sequence(
                lambda hs: SSM.mamba_block(hs, mp, cfg, state=m_state,
                                           need_state=need_state),
                h) if cache is None else SSM.mamba_block(
                    h, mp, cfg, state=m_state, need_state=need_state)
            # mean of per-branch normalized outputs (hymba parallel heads)
            attn_out = L.rms_norm(attn_out, p["attn_out_ln"], cfg.norm_eps)
            mamba_out = L.rms_norm(mamba_out, p["mamba_out_ln"], cfg.norm_eps)
            attn_out = 0.5 * (attn_out + mamba_out)
            new.update(conv=m_new["conv"], ssm=m_new["ssm"].float())
        if cfg.parallel_block:
            return x + attn_out + L.mlp(h, p, cfg, ctx), new
        x = x + attn_out
        x = ctx.constrain(x, "batch", "seq" if cache is None else None, None)
        h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if cfg.family == "moe":
            if want_aux:
                new["aux"] = L.moe_aux_loss(h2, p, cfg, ctx)
            if not ctx.enabled:
                return x + L.moe_block(h2, p, cfg), new
            moe_out, _ = self._whole_sequence(
                lambda hs: (L.moe_block(hs, p, cfg, ctx), None), h2) \
                if cache is None else (L.moe_block(h2, p, cfg, ctx), None)
            return x + moe_out, new
        return x + L.mlp(h2, p, cfg, ctx), new

    def _rwkv_block(self, x, p, cache, need_state: bool = False, tp=None):
        """One RWKV6 block (time mix, channel mix); decodes from ``cache``
        when given, else starts from zero token shifts and state.  Under
        tensor parallelism (``tp``) each mix is a region: split (the time
        mix on the rank's heads, its WKV state theirs; the channel mix on
        its ffn slice and d/n gate columns, ``SSM.rwkv_channel_mix``) or on
        whole rows; the token shifts are taken on the whole sequence, so
        the shift states stay whole [B, d]."""
        cfg = self.cfg
        zeros = torch.zeros((x.shape[0], cfg.d_model), dtype=x.dtype,
                            device=x.device)

        def time_mix(hs):
            return SSM.rwkv_time_mix(
                hs, p, cfg,
                shift_state=zeros if cache is None else cache["shift_tm"],
                wkv_state=None if cache is None else cache["wkv"],
                need_state=need_state, ctx=self.ctx,
                tp=self._part_tp("time_mix", tp))

        def channel_mix(hs):
            return SSM.rwkv_channel_mix(
                hs, p, cfg,
                shift_state=zeros if cache is None else cache["shift_cm"],
                ctx=self.ctx, tp=self._part_tp("channel_mix", tp))
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        tm_out, (shift_tm, wkv) = self._region(h, time_mix, "time_mix", tp)
        x = x + tm_out
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        # split, the channel mix joins its columns in the residual's layout
        cm_out, shift_cm = self._region(h, channel_mix, "channel_mix", tp,
                                        joined=True)
        x = x + cm_out
        return x, {"wkv": wkv.float(), "shift_tm": shift_tm,
                   "shift_cm": shift_cm}

    # ------------------------------------------------------------------
    # forward passes
    # ------------------------------------------------------------------
    def _embed(self, tokens, tp=None):
        """The tokens' embeddings; under ``tp`` vocab-parallel (this rank's
        rows of the table, the ranks' parts summed: this rank's S/n of the
        sequence under sequence parallelism); a vocabulary that does not
        split is looked up whole (this rank's S/n of it)."""
        vtp = self._part_tp("vocab", tp)
        if vtp is None:
            e = F.embedding(tokens, self._top("embed")).to(self.dtype)
            return e if tp is None else tp.rows(e)
        e = L.vocab_embed(tokens, self._top("embed", tp), self._vocab_lo(tp))
        return tp.exit(e).to(self.dtype)

    def forward(self, tokens, *, collect_cache: bool = False,
                want_aux: bool = False):
        """Parallel forward over [B, S].  Returns (hidden, caches) where
        caches is the per-layer list of cache entries with
        ``collect_cache`` (k/v [B, S, KV, hd]; the recurrent state at the
        end of the row), else None; with ``want_aux`` also the moe
        load-balancing loss summed over the layers (f32 0-d, 0 outside the
        moe family; the global batch's on every rank) third.  Under grad
        with ``remat`` each layer runs in ``torch.utils.checkpoint``, its
        weights gathered inside (``_layer_params``): a layer at rest is
        whole only while it runs, and again in its recompute.  Under tensor
        parallelism with sequence parallelism ``hidden`` is this rank's S/n
        of the sequence (the caches' K/V the whole sequence's, of the KV
        heads the rank's query heads use)."""
        S = tokens.shape[1]
        tp = self._tp(S)
        x = self._embed(tokens, tp)
        off = self.ctx.index(self.ctx.tp) * S if self._cp else 0
        positions = off + torch.arange(S, device=tokens.device)[None, :]
        caches: List[Dict[str, torch.Tensor]] = []
        aux = x.new_zeros((), dtype=torch.float32)
        for layer in self.layers:
            def one(x, layer=layer):
                return self._block(x, self._layer_params(layer, tp),
                                   positions, need_state=collect_cache,
                                   want_aux=want_aux, tp=tp)
            x, new = remat_layer(one, x) if self.remat else one(x)
            if "aux" in new:
                aux = aux + new.pop("aux")
            if collect_cache:
                caches.append(new)
        x = L.rms_norm(x, self._top("final_ln", tp), self.cfg.norm_eps)
        if want_aux:
            return x, (caches if collect_cache else None), aux
        return x, (caches if collect_cache else None)

    def logits_fn(self, hidden, head: Optional[torch.Tensor] = None):
        """f32 logits of ``hidden``; ``head`` (``_head()``) when the caller
        gathered it already.  Under tensor parallelism (no ``head``) each
        rank's vocabulary columns (``layers.vocab_logits``) gathered over
        the model axis, so every rank picks the same token."""
        cfg = self.cfg
        if head is None:
            tp = self._part_tp("vocab", self._tp(1))
            if tp is not None:
                part = L.vocab_logits(hidden, self._head(tp),
                                      self._vocab_lo(tp), cfg.vocab_size)
                return comm.all_gather(part, tp.group, part.dim() - 1)
            head = self._head()
        logits = (hidden @ head).float()
        vp = cfg.padded_vocab()
        if vp != cfg.vocab_size:
            logits[..., cfg.vocab_size:] = L.NEG_INF
        return logits

    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {'tokens': [B,S], 'targets': [B,S]} (-1 = padding).
        Returns (loss, {"nll", "aux"}): the mean NLL over valid targets, to
        which a moe model adds ``0.01 * aux / n_layers``.  The head is
        gathered once for every chunk.  Under a ctx whose ``batch_axes``
        split the tokens over n ranks, ``nll`` is the rank's share (its
        summed NLL over the global count) and ``aux`` the global batch's
        (``layers.moe_aux_loss``), which enters the share as ``0.01 * aux
        / n_layers / n``: the shares sum to the global loss, and since the
        all-reduce under ``aux`` sums the ranks' gradients in its backward,
        the ranks' gradients sum to the global loss's."""
        tokens, targets = batch["tokens"], batch["targets"]
        n = self.ctx.axis_size(self.ctx.batch_axes) if self.ctx.enabled \
            else 1
        hidden, _, aux = self.forward(tokens, want_aux=True)
        tp = self._tp(tokens.shape[1])
        vtp = self._part_tp("vocab", tp)
        if vtp is not None:    # the rows' whole sequence, on the rank's vocab
            hidden = tp.enter(hidden)
        elif tp is not None:
            hidden = tp.whole(hidden)
        tp = vtp
        Sq = hidden.shape[1]
        c = min(self.loss_chunk, Sq)
        assert Sq % c == 0
        head = self._head(tp)
        if tp is None:
            total, count = chunked_nll(lambda h: self.logits_fn(h, head),
                                       hidden, targets, c)
        else:
            lo = self._vocab_lo(tp)
            total, count = chunked_nll(
                lambda h: L.vocab_logits(h, head, lo, self.cfg.vocab_size),
                hidden, targets, c, vocab=(lo, tp.group))
        if n > 1:
            count = comm.all_reduce(count, self.ctx.group(
                self.ctx.batch_axes))
        nll = total / count.clamp(min=1.0)
        loss = nll
        if self.cfg.family == "moe":
            loss = loss + 0.01 * aux / self.cfg.n_layers / n
        return loss, {"nll": nll, "aux": aux}

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def cache_shapes(self, batch: int, max_len: int):
        return cache_shapes(self.cfg, batch, max_len, self.kv_quant)

    def cache_axes(self) -> Dict[str, Tuple]:
        return cache_axes(self.cfg, self.kv_quant)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """A zero cache of ``batch`` rows; under ``decode_kv`` ``tp_seq``
        / ``dp_seq`` each K/V entry holds this rank's max_len/n positions."""
        seq_axes = self._kv_seq_axes()
        n = 1 if seq_axes is None else self.ctx.axis_size(seq_axes)
        if max_len % n:
            raise ValueError(f"max_len {max_len} does not split over {n} "
                             f"ranks of {seq_axes}")
        # under tensor parallelism a cache whose sequence is whole holds
        # the KV heads of the rank's query heads where attention splits,
        # and the recurrent state of the rank's heads (wkv, ssm) or
        # channels (conv) where its mixer splits
        tp = self._tp(1)
        kv_tp = self._part_tp("attn", tp) if seq_axes is None else None
        cache = {}
        for name, (shape, dtype) in self.cache_shapes(batch, max_len).items():
            if name in KV_ENTRIES:
                shape = shape[:2] + (max_len // n,) + shape[3:]
                if kv_tp is not None:
                    lo, hi = kv_tp.kv_range(self.cfg)
                    shape = shape[:3] + (hi - lo,) + shape[4:]
            elif tp is not None and name in _STATE_SPLITS and self._splits(
                    _STATE_SPLITS[name][0]):
                dim = _STATE_SPLITS[name][1]
                shape = shape[:dim] + (shape[dim] // tp.n,) + shape[dim + 1:]
            cache[name] = torch.zeros(shape, dtype=dtype, device=self.device)
        return cache

    def prefill(self, tokens, max_len: Optional[int] = None,
                lengths: Optional[torch.Tensor] = None):
        """Returns (last_token_logits [B,1,V], cache ready at pos=S).

        ``lengths`` [B] (optional) marks each row's true prompt length in a
        right-padded packed batch: the returned logits are taken at column
        ``lengths-1`` per row instead of the last column.  Under causal
        attention the pad tail never influences earlier positions, so a
        packed prefill equals per-request prefills (pad K/V beyond
        ``lengths`` is masked out at decode by the per-slot length) — except
        in the moe family, where an expert's capacity grows with the padded
        length, so a padded row may drop fewer tokens than the same prompt
        alone (as in the JAX twin).  Attention runs in full precision; under
        ``kv_quant`` the cache stores the quantized K/V and their scales.
        """
        B, Sq = tokens.shape
        tp = self._tp(Sq)
        hidden, caches = self.forward(tokens, collect_cache=True)
        if self._cp or (tp is not None and tp.sp):
            # the whole sequence of the rows
            hidden = comm.all_gather(hidden, self.ctx.group(self.ctx.tp), 1)
            Sq = hidden.shape[1]
        max_len = max_len or Sq
        if lengths is None:
            h_last = hidden[:, -1:, :]
        else:
            idx = (lengths.to(hidden.device).long() - 1).clamp(0, Sq - 1)
            h_last = hidden[torch.arange(B, device=hidden.device), idx][:, None]
        logits = self.logits_fn(h_last)
        cache = self.init_cache(B, max_len)
        seq_axes = self._kv_seq_axes()
        tl = cache["k"].shape[2] if "k" in cache else max_len
        lo = 0 if seq_axes is None else self.ctx.index(seq_axes) * tl
        a, b = lo, min(lo + tl, Sq)     # this rank's positions of [0, Sq)
        for i, new in enumerate(caches):
            for name, t in new.items():
                if name in KV_ENTRIES:
                    if self._part_tp("attn", tp) is not None \
                            and seq_axes is not None:
                        # every head (every rank takes part in the gather)
                        t = tp.all_kv_heads(t, self.cfg)
                    if b <= a:
                        continue
                    t = t[:, a:b]
                    if self.kv_quant:
                        t, scale = L.kv_quantize(t)
                        cache[f"{name}_scale"][i, :, :b - a] = scale
                    cache[name][i, :, :b - a] = t
                else:                      # recurrent state: the row's end
                    cache[name][i] = t
        return logits, cache

    def decode_step(self, cache, token, pos):
        """token [B,1]; pos an int (current cache length, shared by every
        row) or a [B] tensor of per-slot cache lengths (ragged decode).
        Writes the new K/V and recurrent state into ``cache`` in place.
        Returns (logits [B,1,V], cache)."""
        tp = self._tp(token.shape[1])
        x = self._embed(token, tp)
        if L.is_shared_pos(pos):
            positions = torch.full((1, 1), int(pos), device=x.device)
        else:
            pos = torch.as_tensor(pos, device=x.device).long()
            positions = pos[:, None]                        # [B, 1] per slot
        for i, layer in enumerate(self.layers):
            x, new = self._block(x, self._layer_params(layer, tp), positions,
                                 cache={n: c[i] for n, c in cache.items()},
                                 pos=pos, tp=tp)
            for name, t in new.items():
                if name not in KV_ENTRIES:  # K/V were written at pos
                    cache[name][i].copy_(t)
        x = L.rms_norm(x, self._top("final_ln", tp), self.cfg.norm_eps)
        return self.logits_fn(x), cache
