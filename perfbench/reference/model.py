"""Plain PyTorch reference of the dense decoder family, in float32.

It follows the published architecture of the configurations it runs
(pre-norm RMSNorm blocks, grouped-query attention with optional q/k/v
bias, rotary embedding on a leading share of each head, SwiGLU MLP,
untied head) with one departure shared with the program: the rotated share
of a head is split into halves, not interleaved in pairs, which is the
published model up to a fixed permutation of each head's q/k columns.  It
imports nothing of the program, uses no kernel, cache or batching, and
runs layer by layer on weights drawn again from the seed.

``mm`` is the one place a matrix product happens; ``fp8_mm`` puts a
lower precision there (the control: both operands and the product rounded
to float8 e4m3 with a per-tensor scale, forward and backward).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

SUPPORTED = dict(family="dense", act="swiglu", qk_norm=False,
                 parallel_block=False, tie_embeddings=False,
                 logit_softcap=0.0, mlp_bias=False)


def check_supported(model: Dict) -> None:
    for key, want in SUPPORTED.items():
        if model.get(key, want) != want:
            raise NotImplementedError(f"the reference runs {key}={want!r}, "
                                      f"not {model.get(key)!r}")


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32: TF32 off while the reference runs."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def mm(x, w):
    return x @ w


def _fp8(x):
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def fp8_mm(x, w):
    q = _Fp8.apply
    return q(q(x) @ q(w))


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta: float, partial: float):
    """x [B, S, H, hd]; positions [S].  Rotates the first ``partial`` of
    each head as two halves."""
    hd = x.shape[-1]
    rot = int(hd * partial)
    rot -= rot % 2
    half = rot // 2
    inv = theta ** (-torch.arange(0, rot, 2, dtype=torch.float32,
                                  device=x.device) / rot)
    ang = positions.float()[:, None] * inv[None, :]          # [S, half]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:rot]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., rot:]],
                     dim=-1)


def attention(q, k, v):
    """Causal attention: q [B, S, H, hd], k/v [B, S, KV, hd]; query head h
    reads key/value head h // (H / KV)."""
    B, S, H, hd = q.shape
    g = H // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhst,bthd->bshd", torch.softmax(s, dim=-1), v)


def layer(x, p: Dict[str, torch.Tensor], model: Dict, positions, matmul=mm,
          kv=None):
    """One block on x [B, S, d] (float32 weights ``p``); appends the
    block's (k, v) [B, S, KV, hd], k rotated, to the list ``kv`` if
    given."""
    B, S, _ = x.shape
    hd = model["head_dim"] or model["d_model"] // model["n_heads"]
    eps = model["norm_eps"]
    h = rms_norm(x, p["ln1"], eps)
    q, k, v = matmul(h, p["wq"]), matmul(h, p["wk"]), matmul(h, p["wv"])
    if model["qkv_bias"]:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = (t.reshape(B, S, -1, hd) for t in (q, k, v))
    q = rope(q, positions, model["rope_theta"], model["partial_rotary"])
    k = rope(k, positions, model["rope_theta"], model["partial_rotary"])
    if kv is not None:
        kv.append((k, v))
    x = x + matmul(attention(q, k, v).reshape(B, S, -1), p["wo"])
    h = rms_norm(x, p["ln2"], eps)
    return x + matmul(F.silu(matmul(h, p["w1"])) * matmul(h, p["w3"]),
                      p["w2"])
