"""Core transformer layers, dense subset: norms, RoPE, chunked and decode
attention, MLP.

Port of ``repro.models.layers``.  Shapes follow [batch, seq, heads,
head_dim] and weights keep the JAX package's ``[in, out]`` layout, so
``x @ w`` is its ``einsum("bsd,dq->bsq")``.  Softmax and norm statistics
are computed in f32 regardless of the activation dtype.  The compute
hotspot ``attention_chunked`` consults the kernel-variant registry
(``repro_torch.kernels.ops``) so an installed kernel takes over without
touching model code.

Not ported here: ``kv_quantize``, context-parallel attention,
``flash_decode_sharded`` and MoE (no sharding in the port yet).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

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
# norms and activations
# --------------------------------------------------------------------------
def rms_norm(x, scale, eps):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


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


def _project_qkv(x, p, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_scale"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta, cfg.partial_rotary)
    k = rope(k, positions, cfg.rope_theta, cfg.partial_rotary)
    return q, k, v


def attention_chunked(q, k, v, *, causal: bool, q_chunk: int = 256,
                      softcap: float = 0.0, use_impl: bool = True):
    """Flash-style q-chunked attention: O(S·chunk) score memory.

    The plain reference lowering; when a kernel is installed at the
    registry's ``attention`` site it takes over (the reintegration step).
    """
    if use_impl:
        from repro_torch.kernels import ops
        impl = ops.get_impl("attention")
        if impl is not None:
            return impl(q, k, v, causal=causal, softcap=softcap)

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
            qpos = start + torch.arange(q_chunk, device=q.device)
            mask = kpos[None, :] <= qpos[:, None]          # [c, t]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgct,btkh->bckgh", p, v))
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


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


def attention_decode(q, k_cache, v_cache, length: Optional[torch.Tensor] = None,
                     softcap: float = 0.0):
    """Single-token decode: q [B, 1, H, hd] vs caches [B, T, KV, hd]."""
    B, _, H, hd = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qh = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,btkh->bkgt", qh, k_cache).float() * scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    if length is not None:
        valid = torch.arange(T, device=q.device)[None, :] < length[:, None]
        s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgt,btkh->bkgh", p, v_cache)
    return out.reshape(B, 1, H, hd)


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


def mlp(x, p, cfg: ModelConfig):
    a = act_fn(cfg.act)
    h = x @ p["w1"]
    if cfg.mlp_bias:
        h = h + p["b1"]
    h = a(h)
    if cfg.act == "swiglu":
        h = h * (x @ p["w3"])
    out = h @ p["w2"]
    if cfg.mlp_bias:
        out = out + p["b2"]
    return out
