"""Plain PyTorch oracles for the hotspot kernels.

Port of ``repro.kernels.ref`` (``ref.py:14-75``): ``attention_ref``,
``wkv_ref``, ``ssd_ref`` and ``grouped_matmul_ref``.  Deliberately naive:
the full score matrix, sequential recurrences, f32 throughout.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, softcap: float = 0.0):
    """q [B,S,H,hd], k/v [B,T,KV,hd] (GQA) → [B,S,H,hd]; full score matrix.
    The causal mask is offset by T−S (the last query sees every key)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qh = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bskgh,btkh->bkgst", qh, k.float())
    s = s / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device).tril(T - S)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def wkv_ref(r, k, v, lw, u):
    """Sequential RWKV6 recurrence.  r/k/v/lw [B,S,H,K]; u [H,K].
    o_t = r_t·(S_{t-1} + u⊙k_t⊗v_t);  S_t = diag(w_t)S_{t-1} + k_t⊗v_t.
    Returns (o [B,S,H,V] f32, final state [B,H,K,V] f32)."""
    B, S, H, K = r.shape
    r, k, v, lw = (t.float() for t in (r, k, v, lw))
    uf = u.float()
    state = torch.zeros((B, H, K, v.shape[-1]), dtype=torch.float32,
                        device=r.device)
    outs = []
    for t in range(S):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], lw[:, t]
        o_t = torch.einsum("bhk,bhkv->bhv", r_t, state) \
            + torch.einsum("bhk,bhk,bhv->bhv", r_t, uf * k_t, v_t)
        state = torch.exp(w_t)[..., None] * state \
            + k_t[..., None] * v_t[..., None, :]
        outs.append(o_t)
    return torch.stack(outs, dim=1), state


def ssd_ref(xh, dt, a_log, B_t, C_t):
    """Sequential Mamba-2 SSD.  xh [B,S,H,P]; dt [B,S,H]; a_log [H];
    B_t/C_t [B,S,N].  h_t = a_t h_{t-1} + (dt_t x_t)⊗B_t;  y_t = C_t·h_t.
    Returns (y [B,S,H,P] in xh's dtype, final state [B,H,P,N] f32)."""
    Bb, S, H, P = xh.shape
    N = B_t.shape[-1]
    a = torch.exp(-torch.exp(a_log.float())[None, None] * dt.float())
    u = dt.float()[..., None] * xh.float()
    Bf, Cf = B_t.float(), C_t.float()
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(S):
        h = a[:, t, :, None, None] * h \
            + torch.einsum("bhp,bn->bhpn", u[:, t], Bf[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(xh.dtype), h


def grouped_matmul_ref(x, w):
    """x [E,M,K] @ w [E,K,N] → [E,M,N] (MoE expert GEMM): an f32 einsum,
    the result in x's dtype."""
    return torch.einsum("emk,ekn->emn", x.float(), w.float()).to(x.dtype)
