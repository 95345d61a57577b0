"""Plain PyTorch oracles for the hotspot kernels.

Port of ``repro.kernels.ref``; holds ``attention_ref`` for now (the plain
version of the flash-attention kernel), and the other oracles arrive with
their kernels.  Deliberately naive: the full
score matrix, f32 throughout.
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
