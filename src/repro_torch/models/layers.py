"""Core transformer layers: norms, RoPE, chunked and decode attention (with
the int8 KV cache's quantization), MLP, MoE.

Port of ``repro.models.layers``.  Shapes follow [batch, seq, heads,
head_dim] and weights keep the JAX package's ``[in, out]`` layout, so
``x @ w`` is its ``einsum("bsd,dq->bsq")``.  Softmax and norm statistics
are computed in f32 regardless of the activation dtype.  The compute
hotspot ``attention_chunked`` consults the kernel-variant registry
(``repro_torch.kernels.ops``) so an installed kernel takes over without
touching model code.

The sharded branches run rank-locally (``repro_torch.sharding``): under a
``ShardCtx`` with the ``cp`` preset ``attention_context_parallel``
all-gathers K/V over the model axis and runs each rank's query shard
through the ``attention`` site with its ``q_offset`` (an installed kernel
receives it; the JAX twin drops it there, ROADMAP.md queue 3);
``flash_decode_sharded`` combines per-shard partial softmaxes of a cache
whose sequence is split over mesh axes; ``moe_block``'s ``shard_map``
branch sums the tp-sharded expert-ffn partials after the per-token gather;
``moe_aux_loss`` takes its means over the global batch.  Under autograd
their collectives are ``comm``'s differentiable forms.

Tensor parallelism (``TensorParallel``, a model at rest under a ctx whose
``tensor_parallel`` holds) splits the work GSPMD splits over the model
axis in the JAX twin (Megatron's layers): q, k and v (``_project_qkv``
on the rank's columns) and the MLP's ``w1``/``w3`` are column-parallel,
``wo`` and ``w2`` row-parallel (``tp_mlp``), the MoE block's experts run
on the rank's expert-ffn slice or its experts (``tp_moe``, whichever
``moe_impl``), and the embedding and the head on the
rank's vocabulary rows (``vocab_embed``, ``vocab_logits``,
``vocab_parallel_nll``).  Each region is bracketed by
``TensorParallel.enter`` and ``exit``; a part that does not split runs
on the whole rows (``TensorParallel.region``: ``whole`` in, ``rows``
out), and a norm over split channels sums its squares across the ranks
(``split_rms_norm``).
The ``*_param_axes`` tables give each parameter's logical axes, the JAX
twin's ``*_param_spec`` second halves.  ``constrain`` calls mark the JAX
twin's layout points; on the plain local tensors here they change
nothing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import ShardCtx, comm

_NULL = ShardCtx.null()

NEG_INF = -1e30


# --------------------------------------------------------------------------
# param-spec machinery: one table drives init
# --------------------------------------------------------------------------
def init_rule(name: str, shape: Tuple[int, ...]) -> Tuple[str, float]:
    """The JAX package's init rule for one parameter: ("ones" | "zeros" |
    "normal", std).  Names are matched as-is, so ``final_ln`` (which does
    not start with ``ln``) is drawn normal with std 1/sqrt(d)."""
    if name.startswith("ln") or name.endswith("_scale"):
        return "ones", 0.0
    if name.startswith("b") or name.endswith("_bias"):
        return "zeros", 0.0
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return "normal", 1.0 / math.sqrt(max(fan_in, 1))


@torch.no_grad()
def init_from_spec(params: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> None:
    """Fill ``params`` in place by ``init_rule``, drawing normals from
    ``generator`` (same rule as ``repro.models.layers.init_from_spec``,
    not the same bits)."""
    for name in sorted(params):
        p = params[name]
        kind, std = init_rule(name, tuple(p.shape))
        if kind == "ones":
            p.fill_(1.0)
        elif kind == "zeros":
            p.zero_()
        else:
            p.normal_(0.0, std, generator=generator)


# --------------------------------------------------------------------------
# tensor parallelism on the model axis
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class TensorParallel:
    """One call's tensor parallelism over ``ctx``'s model axis (Megatron's,
    as GSPMD lays out the JAX twin's ``constrain`` points).  With ``sp``
    (sequence parallelism: ``ctx.seq_shard`` and a sequence that splits
    over the axis) the residual stream between regions is this rank's
    S/n of the sequence, all-gathered on the way into a region
    (``layers.py:151-153``, ``:402`` in the JAX twin) and reduce-scattered
    on the way out (``lm.py:216,224``); without it the residual is whole
    on every rank and a region's partial sums are all-reduced.  Within a
    region every rank computes with its pieces of the weights
    (``ShardCtx.fsdp_spec``) and holds a partial sum of the output.
    Gradients follow Megatron's convention: every rank of the axis
    computes the same loss, a tensor every rank holds alike carries the
    whole gradient, and the brackets sum the partial gradients of a
    region's inputs."""
    ctx: ShardCtx
    sp: bool

    @property
    def group(self):
        return self.ctx.group(self.ctx.tp)

    @property
    def n(self) -> int:
        return self.ctx.axis_size(self.ctx.tp)

    @property
    def rank(self) -> int:
        return self.ctx.index(self.ctx.tp)

    def enter(self, x):
        """A region's input: the whole sequence from this rank's S/n under
        ``sp`` (its backward reduce-scatters the ranks' partial
        gradients), else ``x`` (its backward sums them)."""
        if self.sp:
            return comm.gather_grad(x, self.group, 1)
        return comm.sum_grads(x, self.group)

    def exit(self, y):
        """A region's output from the ranks' partial ``y`` (``partial_mm``'s
        f32 when serving a bf16 model: the caller casts the sum): this
        rank's S/n of the sum under ``sp``, else the whole sum."""
        if self.sp:
            return comm.scatter_partials(y, self.group, 1)
        return comm.reduce_partials(y, self.group)

    def whole(self, x):
        """The whole sequence, which every rank then uses alike (no
        region's input: its gradient is the whole one on every rank)."""
        if self.sp:
            return comm.gather_replicated(x, self.group, 1)
        return x

    def sum_grads(self, x):
        """A region's input that every rank holds alike already."""
        return comm.sum_grads(x, self.group)

    def rows(self, y):
        """The output of a part every rank computes whole and alike (a
        part that does not split: ``whole``'s input) in the residual's
        layout: this rank's S/n of the sequence under ``sp`` (no
        collective; its backward all-gathers, so every rank goes on with
        the whole gradient), else ``y``."""
        if self.sp:
            return comm.own_piece(y, self.group, 1)
        return y

    def region(self, h, fn, split: bool, whole=None, joined: bool = False):
        """One part of a block on the residual's ``h``: ``fn`` (returning
        (out, extra)) on the region's input and ``exit`` of its partial
        ``out`` (cast to ``h``'s dtype) where the part splits, else on the
        whole rows (``whole``) and ``rows`` of its output, as GSPMD's
        divisibility fallback computes a dim that does not split whole.
        ``whole``: ``self.whole(h)`` gathered already (hymba's branches
        share ``ln1``'s rows): a split part enters from it (``sum_grads``).
        ``joined``: a split ``fn`` returns its output in the residual's
        layout already (RWKV's channel mix), so it makes no exit.
        Returns (out in ``h``'s layout, extra)."""
        if split:
            x = self.enter(h) if whole is None else self.sum_grads(whole)
            out, extra = fn(x)
            return (out if joined else self.exit(out).to(h.dtype)), extra
        out, extra = fn(self.whole(h) if whole is None else whole)
        return self.rows(out), extra

    def columns(self, w, width: int):
        """This rank's ``width``/n columns of the whole ``w`` [..., width]
        (a vector every rank holds whole and uses on its part)."""
        m = width // self.n
        return w[..., self.rank * m:(self.rank + 1) * m]

    def join_columns(self, y):
        """The residual's layout of a result of which each rank computed
        its own columns ``y`` [B, S, d/n]: the ranks' columns joined (the
        whole sequence's, then this rank's S/n of it under ``sp``, whose
        gradient each rank holds alone: the gather's backward sums them;
        else the whole rows every rank goes on with alike)."""
        if self.sp:
            whole = comm.gather_grad(y, self.group, 2)
            m = whole.shape[1] // self.n
            return whole[:, self.rank * m:(self.rank + 1) * m]
        return comm.gather_replicated(y, self.group, 2)

    def paired_columns(self, w, width: int):
        """This rank's columns of each half of a fused projection ``w``
        whose rank piece is [d, 2·width/n] (mamba's ``w_in``: ``xi`` and
        ``z`` side by side): the rank's ``width``/n channels are columns
        of two pieces, so ``w`` is gathered over the model axis (its
        backward reduce-scatters the ranks' gradients into the layout)
        and both halves cut, as ``kv_columns`` cuts KV columns."""
        whole = comm.gather_grad(w, self.group, w.dim() - 1)
        m = width // self.n
        lo = self.rank * m
        return torch.cat([whole[..., lo:lo + m],
                          whole[..., width + lo:width + lo + m]], dim=-1)

    def kv_range(self, cfg: ModelConfig, rank: Optional[int] = None
                 ) -> Tuple[int, int]:
        """[lo, hi) of the KV heads this rank's H/n query heads use:
        global query head ``r·H/n + i`` reads KV head ``(r·H/n + i) //
        (H/KV)``."""
        r = self.rank if rank is None else rank
        hn, G = cfg.n_heads // self.n, cfg.n_heads // cfg.n_kv_heads
        return (r * hn) // G, ((r + 1) * hn - 1) // G + 1

    def splits_heads(self, cfg: ModelConfig) -> bool:
        """Whether every rank's query heads split evenly and use whole KV
        heads in the same pattern."""
        H, KV, n = cfg.n_heads, cfg.n_kv_heads, self.n
        if H % n:
            return False
        hn, G = H // n, H // KV
        return not (hn % G and G % hn)

    def kv_columns(self, w, cfg: ModelConfig):
        """The columns of a KV projection (``wk``, ``wv``: [d, KV·hd];
        ``bk``, ``bv``) for this rank's KV heads, from its piece: the piece
        itself when it is those columns, else cut from the whole weight
        (gathered over the model axis when split: its backward
        reduce-scatters the ranks' gradients)."""
        hd = cfg.resolved_head_dim
        lo, hi = self.kv_range(cfg)
        cols = w.shape[-1]
        if cols != cfg.kv_dim:
            if (self.rank * cols, (self.rank + 1) * cols) == (lo * hd,
                                                              hi * hd):
                return w
            w = comm.gather_grad(w, self.group, w.dim() - 1)
        return w[..., lo * hd:hi * hd]

    def _pick_kv(self, got, per: int, cfg: ModelConfig):
        """Every KV head from the ranks' gathered [B, S, n·per, hd], each
        taken from the first rank that holds it."""
        pick: List[int] = []
        for j in range(cfg.n_kv_heads):
            r = next(r for r in range(self.n)
                     if self.kv_range(cfg, r)[0] <= j
                     < self.kv_range(cfg, r)[1])
            pick.append(r * per + j - self.kv_range(cfg, r)[0])
        if pick == list(range(got.shape[2])):
            return got
        return got[:, :, pick]

    def all_kv_heads(self, k, cfg: ModelConfig):
        """[B, S, KV, hd] from every rank's KV heads (``kv_range``)."""
        return self._pick_kv(comm.all_gather(k, self.group, 2), k.shape[2],
                             cfg)

    def all_qkv_heads(self, q, k, v, cfg: ModelConfig):
        """Every query and KV head of one token from the ranks' (one
        all-gather for the three), as the JAX twin's sharded flash-decode
        takes q whole over the model axis (``layers.py:352-370``)."""
        hq, hk = q.shape[2], k.shape[2]
        got = comm.all_gather(torch.cat([q, k, v], dim=2),
                              self.group, 2)
        got = got.unflatten(2, (self.n, hq + 2 * hk))
        qa = got[:, :, :, :hq].flatten(2, 3)
        ka = got[:, :, :, hq:hq + hk].flatten(2, 3)
        va = got[:, :, :, hq + hk:].flatten(2, 3)
        return qa, self._pick_kv(ka, hk, cfg), self._pick_kv(va, hk, cfg)

    def own_heads(self, att, n_heads: int):
        """This rank's H/n heads of [B, S, H, hd]."""
        hn = n_heads // self.n
        return att[:, :, self.rank * hn:(self.rank + 1) * hn]


def partial_mm(x, w):
    """``x @ w`` (or a batched ``bmm``) whose result one rank's partial sum
    is.  Serving a bf16 or fp16 model (autograd not recording) it is f32,
    the GEMM's f32 accumulator kept (``out_dtype``), so the ranks' sum is
    rounded once, where one rank's whole product is: tensor-parallel
    serving then agrees with one rank's to f32 summation order.  Under
    autograd (``mm.dtype`` has no derivative) and in f32 it is ``x @ w``."""
    if x.dtype == torch.float32 or (torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad)):
        return x @ w
    from torch._subclasses.fake_tensor import is_fake
    if not (x.is_cuda or is_fake(x)):    # no out_dtype matmul on the CPU
        return x.float() @ w.float()
    if w.dim() == 3:
        return torch.bmm(x, w, out_dtype=torch.float32)
    return torch.mm(x.reshape(-1, x.shape[-1]), w,
                    out_dtype=torch.float32).view(*x.shape[:-1], w.shape[-1])


# --------------------------------------------------------------------------
# norms and activations
# --------------------------------------------------------------------------
def rms_norm(x, scale, eps):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def split_rms_norm(x, scale, eps, tp: TensorParallel, width: int):
    """``rms_norm`` over a last dim of ``width`` channels of which ``x``
    holds this rank's (``scale`` its piece): the sums of squares are
    all-reduced over the model axis ([..., 1], f32)."""
    xf = x.float()
    ss = comm.all_reduce_grad(xf.square().sum(dim=-1, keepdim=True),
                              tp.group)
    out = xf * torch.rsqrt(ss / width + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps):
    """LayerNorm over the last axis: f32 statistics, the biased variance
    (as ``jnp.var``), an optional bias; the result in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def act_fn(name: str):
    if name == "swiglu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu_sq":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


# --------------------------------------------------------------------------
# rotary embeddings (partial-rotary aware)
# --------------------------------------------------------------------------
def rope(x, positions, theta: float, partial: float = 1.0):
    """x: [B, S, H, hd]; positions: [B, S] (or [S]) int.  Rotates the first
    ``partial`` of head_dim as split halves (not interleaved)."""
    if theta <= 0.0:
        return x
    hd = x.shape[-1]
    rot = int(hd * partial)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    freqs = torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot
    inv = theta ** -freqs                                  # [rot/2]
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions.float()[:, :, None] * inv[None, None, :]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def attn_param_spec(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    spec = {
        "wq": (d, cfg.q_dim),
        "wk": (d, cfg.kv_dim),
        "wv": (d, cfg.kv_dim),
        "wo": (cfg.q_dim, d),
    }
    if cfg.qkv_bias:
        spec["bq"] = (cfg.q_dim,)
        spec["bk"] = (cfg.kv_dim,)
        spec["bv"] = (cfg.kv_dim,)
    if cfg.qk_norm:
        hd = cfg.resolved_head_dim
        spec["q_scale"] = (hd,)
        spec["k_scale"] = (hd,)
    return spec


def attn_param_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """name → logical axes of ``attn_param_spec``'s parameters."""
    axes = {"wq": ("d_model", "heads"), "wk": ("d_model", "kv_heads"),
            "wv": ("d_model", "kv_heads"), "wo": ("heads", "d_model")}
    if cfg.qkv_bias:
        axes.update(bq=("heads",), bk=("kv_heads",), bv=("kv_heads",))
    if cfg.qk_norm:
        axes.update(q_scale=(None,), k_scale=(None,))
    return axes


def _project_qkv(x, p, cfg: ModelConfig, positions, ctx: ShardCtx = _NULL):
    """q, k, v of ``x``, normed and rotated: [B, S, heads, hd] each, the
    heads those ``p``'s columns hold (under tensor parallelism the rank's
    query heads and, ``TensorParallel.kv_columns``, the KV heads they
    use)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_scale"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta, cfg.partial_rotary)
    k = rope(k, positions, cfg.rope_theta, cfg.partial_rotary)
    if ctx.attn_impl == "cp" and q.shape[1] > 1:
        # context parallel: everything stays sequence-sharded; the cp
        # attention gathers K/V itself
        q = ctx.constrain(q, "batch", "seq", None, None)
        k = ctx.constrain(k, "batch", "seq", None, None)
        v = ctx.constrain(v, "batch", "seq", None, None)
    else:
        q = ctx.constrain(q, "batch", None, "heads", None)
        k = ctx.constrain(k, "batch", None, "kv_heads", None)
        v = ctx.constrain(v, "batch", None, "kv_heads", None)
    return q, k, v


def attention_chunked(q, k, v, *, causal: bool, q_chunk: int = 256,
                      softcap: float = 0.0, q_offset=None,
                      use_impl: bool = True):
    """Flash-style q-chunked attention: O(S·chunk) score memory.

    The plain reference lowering; when a kernel is installed at the
    registry's ``attention`` site it takes over (the reintegration step).
    ``q_offset`` (context-parallel shards) puts query row i at sequence
    position ``q_offset + i`` under the causal mask; an installed impl
    receives it whenever it is given.
    """
    if use_impl:
        from repro_torch.kernels import ops
        impl = ops.get_impl("attention")
        if impl is not None:
            if q_offset is None:
                return impl(q, k, v, causal=causal, softcap=softcap)
            return impl(q, k, v, causal=causal, softcap=softcap,
                        q_offset=q_offset)

    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    q_chunk = min(q_chunk, S)
    while S % q_chunk:        # non-divisible seq: largest divisor ≤ chunk
        q_chunk -= 1
    qg = q.reshape(B, S, KV, G, hd)
    kpos = torch.arange(T, device=q.device)
    outs = []
    for start in range(0, S, q_chunk):
        qb = qg[:, start:start + q_chunk]                  # [B, c, KV, G, hd]
        s = torch.einsum("bckgh,btkh->bkgct", qb, k).float() * scale
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        if causal:
            qpos = (q_offset or 0) + start + torch.arange(q_chunk,
                                                          device=q.device)
            mask = kpos[None, :] <= qpos[:, None]          # [c, t]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgct,btkh->bckgh", p, v))
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


def attention_context_parallel(q, k, v, *, ctx: ShardCtx, q_chunk: int = 256,
                               softcap: float = 0.0):
    """Context-parallel causal attention: q stays sequence-sharded on the
    model axis; K/V (small under GQA) are all-gathered and each rank
    attends its own query shard with its causal mask shifted by
    ``rank · S/n``.  Returns (out, whole K, whole V): the gathered K/V are
    the sequence's, for a prefill's cache."""
    if not ctx.enabled:
        return attention_chunked(q, k, v, causal=True, q_chunk=q_chunk,
                                 softcap=softcap), k, v
    group = ctx.group(ctx.tp)
    s_local = q.shape[1]
    kf = comm.gather_grad(k, group, 1)
    vf = comm.gather_grad(v, group, 1)
    off = ctx.index(ctx.tp) * s_local
    out = attention_chunked(q, kf, vf, causal=True,
                            q_chunk=min(q_chunk, s_local), softcap=softcap,
                            q_offset=off)
    return out, kf, vf


# ---- decode cache indexing (shared-position and ragged per-slot) --------
def is_shared_pos(pos) -> bool:
    """True for one decode position shared by every row (an int or 0-d
    tensor), False for a [B] vector of per-slot positions."""
    return isinstance(pos, int) or torch.as_tensor(pos).dim() == 0


def cache_update(cache, new, pos):
    """Write ``new`` [B, 1, ...] into ``cache`` [B, T, ...] at ``pos``, in
    place (the JAX twin returns an updated copy); returns ``cache``.

    ``pos`` is a scalar (all rows share one decode position) or a [B]
    tensor of per-slot positions (ragged continuous-batching decode).
    """
    new = new.to(cache.dtype)
    if is_shared_pos(pos):
        cache[:, int(pos)] = new[:, 0]
    else:
        pos = torch.as_tensor(pos, device=cache.device).long()
        cache[torch.arange(cache.shape[0], device=cache.device), pos] = new[:, 0]
    return cache


def decode_lengths(pos, batch: int, device=None):
    """Valid KV length per row after writing at ``pos`` (scalar or [B])."""
    if is_shared_pos(pos):
        return torch.full((batch,), int(pos) + 1, dtype=torch.int64,
                          device=device)
    return torch.as_tensor(pos, device=device).long() + 1


# ---- int8 KV-cache quantization (per-position, per-kv-head scales) ------
def kv_quantize(x):
    """x [..., hd] → (int8 values, bf16 scales [..., 1]); rounds half to
    even, as ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-8
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def kv_dequantize(q, scale, dtype=torch.float32):
    return (q.float() * scale.float()).to(dtype)


def attention_decode(q, k_cache, v_cache, length: Optional[torch.Tensor] = None,
                     softcap: float = 0.0, k_scale=None, v_scale=None):
    """Single-token decode: q [B, 1, H, hd] vs caches [B, T, KV, hd]
    (optionally int8 with per-position scales, attended in f32).  Returns
    q's dtype; the JAX twin returns the promoted f32 over an int8 cache,
    which its bf16 models cannot carry through their layer scan."""
    if k_scale is not None:
        k_cache = kv_dequantize(k_cache, k_scale)
        v_cache = kv_dequantize(v_cache, v_scale)
    B, _, H, hd = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qh = q.reshape(B, KV, G, hd).to(torch.promote_types(q.dtype,
                                                        k_cache.dtype))
    s = torch.einsum("bkgh,btkh->bkgt", qh, k_cache).float() * scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    if length is not None:
        valid = torch.arange(T, device=q.device)[None, :] < length[:, None]
        s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgt,btkh->bkgh", p, v_cache)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def flash_decode_sharded(q, k_cache, v_cache, ctx: ShardCtx,
                         length: Optional[torch.Tensor] = None, *,
                         seq_axes=None, k_scale=None, v_scale=None):
    """Distributed flash-decode: each rank holds a shard of the cache's
    sequence over the mesh ``seq_axes`` (default the data axes) and of its
    batch rows; it computes partial attention over its shard, and the
    shards are combined by a log-sum-exp reduction (all-reduce MAX of the
    row maxima, then one SUM of the rescaled numerators and denominators,
    joined along head_dim).  int8
    caches are dequantized per shard.  q [b,1,H,hd] (this rank's rows),
    caches [b, T/n, KV, hd], ``length`` [b] in whole-sequence positions.
    Plain torch, as the JAX twin computes it outside any kernel; like it,
    it applies no softcap."""
    if not ctx.enabled:
        return attention_decode(q, k_cache, v_cache, length,
                                k_scale=k_scale, v_scale=v_scale)
    seq_axes = tuple(seq_axes if seq_axes is not None else ctx.dp)
    group = ctx.group(seq_axes)
    B, _, H, hd = q.shape
    tl, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    if k_scale is not None:
        k_cache = kv_dequantize(k_cache, k_scale)
        v_cache = kv_dequantize(v_cache, v_scale)
    qh = q.reshape(B, KV, G, hd).to(torch.promote_types(q.dtype,
                                                        k_cache.dtype))
    kpos = ctx.index(seq_axes) * tl + torch.arange(tl, device=q.device)
    s = torch.einsum("bkgh,btkh->bkgt", qh, k_cache).float() * scale
    if length is not None:
        valid = (kpos[None, :] < length[:, None])[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                       # [b,KV,G]
    e = torch.exp(s - m[..., None])
    num = torch.einsum("bkgt,btkh->bkgh", e, v_cache.float())
    den = e.sum(dim=-1)
    c = torch.exp(m - comm.all_reduce(m, group, "max"))
    # one SUM for the rescaled numerators and denominators together
    both = comm.all_reduce(torch.cat([num * c[..., None],
                                      (den * c)[..., None]], dim=-1), group)
    out = both[..., :-1] / both[..., -1:].clamp(min=1e-30)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def sharded_cache_update(cache, new, pos, lo: int):
    """``cache_update`` on a rank's shard of a cache's sequence, which
    holds positions [lo, lo + its length): rows whose ``pos`` falls there
    are written, the others left to the rank that holds them."""
    tl = cache.shape[1]
    if is_shared_pos(pos):
        if lo <= int(pos) < lo + tl:
            cache_update(cache, new, int(pos) - lo)
        return cache
    pos = torch.as_tensor(pos, device=cache.device).long()
    rows = ((pos >= lo) & (pos < lo + tl)).nonzero()[:, 0]
    if rows.numel():
        cache[rows, pos[rows] - lo] = new[rows, 0].to(cache.dtype)
    return cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def mlp_param_spec(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, f = cfg.d_model, cfg.d_ff
    spec = {"w1": (d, f), "w2": (f, d)}
    if cfg.act == "swiglu":
        spec["w3"] = (d, f)
    if cfg.mlp_bias:
        spec["b1"] = (f,)
        spec["b2"] = (d,)
    return spec


def mlp_param_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    axes = {"w1": ("d_model", "ffn"), "w2": ("ffn", "d_model")}
    if cfg.act == "swiglu":
        axes["w3"] = ("d_model", "ffn")
    if cfg.mlp_bias:
        axes.update(b1=("ffn",), b2=("d_model",))
    return axes


def mlp(x, p, cfg: ModelConfig, ctx: ShardCtx = _NULL):
    a = act_fn(cfg.act)
    h = x @ p["w1"]
    if cfg.mlp_bias:
        h = h + p["b1"]
    h = a(h)
    if cfg.act == "swiglu":
        h = h * (x @ p["w3"])
    if ctx.attn_impl == "cp":
        h = ctx.constrain(h, "batch", "seq", None)   # tokens stay sharded
    else:
        h = ctx.constrain(h, "batch", None, "ffn")   # Megatron TP
    out = h @ p["w2"]
    if cfg.mlp_bias:
        out = out + p["b2"]
    return out


def tp_mlp(x, p, cfg: ModelConfig):
    """The MLP's partial sum on this rank's ffn slice of ``x`` (the
    region's input; ``partial_mm``'s dtype): ``w1``/``w3``
    column-parallel, ``w2`` row-parallel; ``b2`` is the caller's, after
    the region's exit."""
    a = act_fn(cfg.act)
    h = x @ p["w1"]
    if cfg.mlp_bias:
        h = h + p["b1"]
    h = a(h)
    if cfg.act == "swiglu":
        h = h * (x @ p["w3"])
    return partial_mm(h, p["w2"])


def mlp_region(h, p, cfg: ModelConfig, tp: TensorParallel, split: bool):
    """The MLP on the residual's ``h`` under tensor parallelism, a region
    (``TensorParallel.region``): split, its partial sum (``tp_mlp``) with
    ``b2`` added after the exit; else on the whole rows."""
    out, _ = tp.region(h, lambda x: (tp_mlp(x, p, cfg) if split
                                     else mlp(x, p, cfg), None), split)
    if split and cfg.mlp_bias:
        out = out + p["b2"]
    return out


# --------------------------------------------------------------------------
# Mixture of Experts (capacity-based per-sequence local dispatch)
# --------------------------------------------------------------------------
def moe_param_spec(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    m = cfg.moe
    d, fe = cfg.d_model, m.d_ff_expert
    spec = {
        "router": (d, m.n_experts),
        "we1": (m.n_experts, d, fe),
        "we2": (m.n_experts, fe, d),
        "we3": (m.n_experts, d, fe),
    }
    if m.n_shared:
        spec.update({
            "ws1": (d, m.d_ff_shared),
            "ws2": (m.d_ff_shared, d),
            "ws3": (d, m.d_ff_shared),
            "ws_gate": (d, 1),
        })
    return spec


def moe_param_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    axes = {"router": ("d_model", "experts"),
            "we1": ("experts", "d_model", "expert_ffn"),
            "we2": ("experts", "expert_ffn", "d_model"),
            "we3": ("experts", "d_model", "expert_ffn")}
    if cfg.moe.n_shared:
        axes.update(ws1=("d_model", "ffn"), ws2=("ffn", "d_model"),
                    ws3=("d_model", "ffn"), ws_gate=("d_model", None))
    return axes


def _moe_capacity(S: int, m) -> int:
    c = int(math.ceil(S * m.top_k * m.capacity_factor / m.n_experts))
    return max(4, ((c + 3) // 4) * 4)


def moe_route(x, p, m):
    """Router of a MoE layer: (probs f32 [B, S, E], gates [B, S, K]
    renormalised over the top k, expert indices [B, S, K]).  Ties go to the
    lower expert index, as ``lax.top_k`` breaks them (a stable descending
    sort; ``torch.topk`` leaves their order unspecified, and bf16 router
    logits tie)."""
    probs = torch.softmax((x @ p["router"]).float(), dim=-1)
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[..., :m.top_k], eidx[..., :m.top_k]
    return probs, gate / gate.sum(dim=-1, keepdim=True), eidx


def _moe_dispatch(x, eidx, gate, m):
    """The capacity dispatch of a parallel call: (the expert buffer [E,
    B·C, d], the kept gates [B, T], expert and queue indices [B, T], row
    indices [B, 1], C)."""
    B, S, d = x.shape
    E, K = m.n_experts, m.top_k
    C = _moe_capacity(S, m)
    T = S * K
    ef = eidx.reshape(B, T)                                 # [B, T]
    gf = gate.reshape(B, T)
    # a token's place in its expert's queue, in sequence order; the scan
    # runs along the contiguous axis (along T as the middle axis CUDA
    # scans one column a thread: among a prefill's slowest kernels)
    onehot = F.one_hot(ef, E).transpose(1, 2).contiguous()  # [B, E, T]
    pos = ((onehot.cumsum(dim=-1) - onehot) * onehot).sum(dim=1)
    keep = (pos < C).to(x.dtype)                            # [B, T]
    xk = x[:, :, None].expand(B, S, K, d).reshape(B, T, d)  # s*K + j
    pos_c = pos.clamp(max=C - 1)
    rows = torch.arange(B, device=x.device)[:, None]
    slot = (rows * E + ef) * C + pos_c                      # [B, T]
    buf = torch.zeros((B * E * C, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot.reshape(-1),
                   (xk * keep[..., None]).reshape(B * T, d))
    buf = buf.view(B, E, C, d).transpose(0, 1).reshape(E, B * C, d)
    return buf, gf * keep, ef, pos_c, rows, C


def _moe_experts(xe, p, a, mm=torch.bmm):
    """Every expert of ``p`` (``we1``/``we3``/``we2``, [E, ...]) on its
    rows of ``xe`` [E, N, d]: [E, N, d], ``mm`` the last product."""
    return mm(a(torch.bmm(xe, p["we1"])) * torch.bmm(xe, p["we3"]), p["we2"])


def _moe_gates(eidx, gate, E: int):
    """A decode token's gate of each of the E experts, 0 where it was not
    routed: [B, E]."""
    return torch.zeros((eidx.shape[0], E), dtype=gate.dtype,
                       device=gate.device).scatter(-1, eidx[:, 0], gate[:, 0])


def _moe_decode(x0, p, a, w, mm=torch.bmm):
    """Decode's all-expert compute and combine: every expert of ``p`` on
    the token ``x0`` [B, d], weighted by ``w`` [B, E] (``_moe_gates``):
    [B, 1, d]."""
    ye = _moe_experts(x0.expand(p["we1"].shape[0], *x0.shape), p, a, mm)
    return torch.einsum("ebd,be->bd", ye, w.to(ye.dtype))[:, None]


def _moe_combine(ye, ef, pos_c, rows, gk, S: int, K: int):
    """A parallel call's combine: each token's top-k expert outputs, read
    at its queue slots of ``ye`` [E, B, C, d] and weighted by its kept
    gates ``gk``: [B, S, d]."""
    yk = ye[ef, rows, pos_c] * gk[..., None]                # [B, T, d]
    return yk.reshape(yk.shape[0], S, K, yk.shape[-1]).sum(dim=2)


def tp_moe(x, p, cfg: ModelConfig, tp: TensorParallel):
    """The MoE block's partial sum on this rank (``moe_block``'s routing
    and dispatch, on ``x`` that every rank holds alike): under ``default``
    each expert on the rank's expert-ffn slice (``we1``/``we3`` columns,
    ``we2`` rows), under ``ep`` the rank's E/n experts on their part of
    the dispatch buffer (a token routed elsewhere adds zero); the shared
    expert on its ffn slice.  The router is whole on every rank, as in the
    JAX twin.  The dispatch buffer, the gates and the shared expert's
    input enter the region (their gradients summed over the ranks); the
    caller's ``exit`` sums the partials (combine before reduce;
    ``partial_mm``'s dtype).  Both ``moe_impl``s run this: under tensor
    parallelism the weights are the rank's pieces already, so the choice
    selects nothing."""
    m = cfg.moe
    B, S, d = x.shape
    E, K = m.n_experts, m.top_k
    a = act_fn(cfg.act)
    _, gate, eidx = moe_route(x, p, m)
    gate = gate.to(x.dtype)
    El = p["we1"].shape[0]
    e_lo = 0 if El == E else tp.rank * El         # ep: this rank's experts
    if S == 1:
        w = tp.sum_grads(_moe_gates(eidx, gate, E))[:, e_lo:e_lo + El]
        out = _moe_decode(tp.sum_grads(x)[:, 0], p, a, w, partial_mm)
    else:
        buf, gk, ef, pos_c, rows, C = _moe_dispatch(x, eidx, gate, m)
        buf = tp.sum_grads(buf)[e_lo:e_lo + El]
        gk = tp.sum_grads(gk)
        ye = _moe_experts(buf, p, a, partial_mm).view(El, B, C, d)
        if El != E:
            gk = gk * ((ef >= e_lo) & (ef < e_lo + El)).to(gk.dtype)
            ef = (ef - e_lo).clamp(0, El - 1)
        out = _moe_combine(ye, ef, pos_c, rows, gk, S, K)
    if m.n_shared:
        xs = tp.sum_grads(x)
        h = a(xs @ p["ws1"]) * (xs @ p["ws3"])
        sgate = torch.sigmoid((x @ p["ws_gate"]).float()).to(x.dtype)
        out = out + partial_mm(h, p["ws2"]) * tp.sum_grads(sgate)
    return out


def moe_block(x, p, cfg: ModelConfig, ctx: ShardCtx = _NULL):
    """x: [B, S, d].  Tokens are routed within their own sequence, top k of
    E experts each.  Decode (S == 1) runs every expert and combines by the
    gates; a parallel call dispatches each expert at most ``_moe_capacity``
    tokens, in sequence order, and drops the rest (a dropped token's slot
    gets zeros added, as the JAX twin's ``.at[].add`` does, so it leaves the
    kept token there intact).  Every shape is static for a given (B, S), so
    the block is captured in a CUDA graph as it is.

    Under a ctx with ``moe_impl="shard_map"`` a parallel call runs
    combine-before-reduce: each rank of the model axis applies its slice
    of the expert-ffn dim (columns of we1/we3, rows of we2), gathers its
    per-token partial outputs and sums them over the axis as [B, S, d]
    instead of [B, E, C, d].  It needs the model axis's ranks to hold the
    same rows (``default``, ``ep``; ``cp``, whose MoE block runs on the
    gathered sequence), so under ``fsdp``, where the model axis splits the
    batch, the block computes every expert-ffn column itself.  Under
    autograd the partial sum's gradient is the sum of the ranks'
    (``comm.all_reduce_grad``) when each rank's loss reads its own shard
    of the output (``cp``); else the region's inputs take the sum of the
    ranks' partial gradients (``comm.sum_grads``) and its output passes
    its gradient on (``comm.reduce_partials``)."""
    m = cfg.moe
    B, S, d = x.shape
    E, K = m.n_experts, m.top_k
    a = act_fn(cfg.act)
    _, gate, eidx = moe_route(x, p, m)
    gate = gate.to(x.dtype)

    if S == 1:
        # decode: all-expert dense compute then weighted combine
        out = _moe_decode(x[:, 0], p, a, _moe_gates(eidx, gate, E))
    else:
        buf, gk, ef, pos_c, rows, C = _moe_dispatch(x, eidx, gate, m)
        we = {n: p[n] for n in ("we1", "we3", "we2")}
        # the model axis's ranks must hold the same rows (not under fsdp)
        combine = (ctx.enabled and ctx.moe_impl == "shard_map"
                   and ctx.tp not in ctx.dp)
        if combine:           # this rank's slice of the expert-ffn dim
            group = ctx.group(ctx.tp)
            # under cp each rank's loss reads its own shard of the output
            # (its gradient there is partial); else the ranks of the model
            # axis go on alike, and the region's inputs take the sum of
            # their partial gradients
            own_shards = ctx.tp in ctx.batch_axes
            if not own_shards:
                buf, gk = comm.sum_grads(buf, group), comm.sum_grads(gk, group)
            n = ctx.axis_size(ctx.tp)
            f = we["we1"].shape[-1] // n
            lo = ctx.index(ctx.tp) * f
            we = {"we1": we["we1"][..., lo:lo + f],
                  "we3": we["we3"][..., lo:lo + f],
                  "we2": we["we2"][:, lo:lo + f]}
        ye = _moe_experts(buf, we, a).view(E, B, C, d)
        out = _moe_combine(ye, ef, pos_c, rows, gk, S, K)
        if combine:
            out = (comm.all_reduce_grad(out, group) if own_shards
                   else comm.reduce_partials(out, group))

    if m.n_shared:
        h = a(x @ p["ws1"]) * (x @ p["ws3"])
        sgate = torch.sigmoid((x @ p["ws_gate"]).float())
        out = out + (h @ p["ws2"]) * sgate.to(x.dtype)
    return ctx.constrain(out, "batch", "seq", None)


def moe_aux_loss(x, p, cfg: ModelConfig, ctx: ShardCtx = _NULL
                 ) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style) of the global batch:
    the routed fractions ``frac`` and the mean router probabilities
    ``imp`` are means over every token.  Under a ctx whose ``batch_axes``
    split the tokens, each is summed over this rank's tokens (``x`` is its
    shard), all-reduced over those axes (``imp`` by
    ``comm.all_reduce_grad``, ``frac`` has no gradient) and divided by
    the global count, so every rank returns the global term; each token
    counts once (under cp ``x`` is the rank's own shard of the
    sequence)."""
    m = cfg.moe
    probs, _, eidx = moe_route(x, p, m)
    hot = F.one_hot(eidx, m.n_experts).float()
    if not (ctx.enabled and ctx.axis_size(ctx.batch_axes) > 1):
        frac = hot.mean(dim=(0, 1, 2))
        return m.n_experts * (frac * probs.mean(dim=(0, 1))).sum()
    group = ctx.group(ctx.batch_axes)
    tokens = probs.shape[0] * probs.shape[1] * ctx.axis_size(ctx.batch_axes)
    frac = comm.all_reduce(hot.sum(dim=(0, 1, 2)), group) / (
        tokens * m.top_k)
    imp = comm.all_reduce_grad(probs.sum(dim=(0, 1)), group) / tokens
    return m.n_experts * (frac * imp).sum()


# --------------------------------------------------------------------------
# vocab-parallel embedding, head and loss: GSPMD's reading of the JAX
# twin's ``lm.py`` ``_embed``, ``logits_fn`` and ``loss`` (``:230-300``)
# with ``vocab`` on the model axis
# --------------------------------------------------------------------------
def vocab_embed(tokens, w, lo: int):
    """This rank's part of the embedding lookup from its rows [lo, lo +
    len(w)) of the table: a token outside them reads zero (the caller's
    ``exit`` sums the ranks' parts)."""
    n = w.shape[0]
    local = tokens - lo
    inside = (local >= 0) & (local < n)
    e = F.embedding(local.clamp(0, n - 1), w)
    return e * inside[..., None].to(e.dtype)


def vocab_logits(hidden, head, lo: int, vocab_size: int):
    """f32 logits of this rank's vocabulary columns [lo, lo + V/n) of the
    head; the padded vocabulary's columns (global index ≥
    ``vocab_size``) read ``NEG_INF``."""
    logits = (hidden @ head).float()
    if lo + head.shape[-1] > vocab_size:
        logits[..., max(vocab_size - lo, 0):] = NEG_INF
    return logits


def vocab_parallel_nll(logits, t, lo: int, group):
    """The NLL of targets ``t`` (valid indices) from each rank's
    vocabulary columns [lo, lo + V/n) of the logits: the max and the sum
    of exponentials are reduced over ``group`` and the target's logit
    read by the rank that holds it.  Every rank returns the whole NLL and
    the gradient of its columns."""
    n = logits.shape[-1]
    mx = comm.all_reduce(logits.detach().amax(dim=-1), group, "max")
    z = torch.exp(logits - mx[..., None]).sum(dim=-1)
    lse = torch.log(comm.reduce_partials(z, group)) + mx
    local = t - lo
    own = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    picked = comm.reduce_partials(torch.where(own, picked, 0.0), group)
    return lse - picked
