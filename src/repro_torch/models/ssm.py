"""State-space blocks: Mamba-2-style SSD heads (hymba) and RWKV6 (Finch).

Port of ``repro.models.ssm``.  Both use exact chunked linear-recurrence
algorithms:

* Mamba SSD: per-head *scalar* decay, so the intra-chunk term is a pairwise
  decay matrix ``exp(la_t - la_s)`` (t≥s ⇒ always ≤1, numerically safe) and
  everything is matmuls; the inter-chunk state is a short loop over chunks.

* RWKV6: per-*channel* data-dependent decay, which cannot be factored into a
  stable pairwise matmul; instead the intra-chunk recurrence runs as a short
  sequential loop *vectorized across all chunks* (depth = chunk length, not
  sequence length), followed by the same inter-chunk loop and a closed-form
  cross term ``r_t ⊙ exp(lw_exclusive) · S_start``.  Exact, no decay clamp.

``_ssd_chunked`` and ``_wkv_chunked`` consult the kernel registry's
``ssm_chunk`` and ``rwkv_wkv`` sites as the JAX twins do.  An installed
kernel that returns ``(out, state)`` (K6 ``kernels.rwkv_wkv.wkv``, K7
``kernels.ssd_scan.ssd``) serves prefill with its final state; one that
returns ``out`` alone gets a state of zeros, as in JAX.  Weights keep the
``[in, out]`` layout, so ``x @ w`` is the twin's ``einsum``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm


# ==========================================================================
# Mamba-2-style SSD (hymba's mamba heads)
# ==========================================================================
def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    p = s.head_dim
    n_heads = d_in // p
    return d_in, n_heads, p


def mamba_param_spec(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    s = cfg.ssm
    d = cfg.d_model
    d_in, hm, p = mamba_dims(cfg)
    n = s.state_dim
    return {
        "w_in": (d, 2 * d_in),
        "conv_w": (s.conv_dim, d_in),
        "conv_bias": (d_in,),
        "w_bc": (d_in, 2 * n),
        "w_dt": (d_in, hm),
        "dt_bias": (hm,),
        "a_log": (hm,),
        "d_skip": (hm,),
        "ln_y": (d_in,),
        "w_out": (d_in, d),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv along seq: x [B,S,C], w [K,C]."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return out + b


def _ssd_chunked(xh, dt, a_log, B_t, C_t, chunk: int, use_impl: bool = True):
    """Exact SSD over chunks.

    xh [B,S,H,P] inputs per head; dt [B,S,H] (post-softplus); a_log [H] (>0);
    B_t, C_t [B,S,N].  Returns y [B,S,H,P] and final state [B,H,P,N].
    """
    if use_impl:
        from repro_torch.kernels import ops
        impl = ops.get_impl("ssm_chunk")
        if impl is not None:
            out = impl(xh, dt, a_log, B_t, C_t, chunk=chunk)
            if isinstance(out, tuple):
                return out
            # stateless impl (training forward only): the JAX twin's state
            # of zeros; prefill needs an impl that returns the state
            Bb, _, H, P = xh.shape
            return out, torch.zeros((Bb, H, P, B_t.shape[-1]),
                                    dtype=torch.float32, device=xh.device)

    Bb, S, H, P = xh.shape
    N = B_t.shape[-1]
    c = min(chunk, S)
    assert S % c == 0
    NC = S // c
    la_step = -torch.exp(a_log.float()) * dt.float()               # [B,S,H] ≤ 0
    u = dt.float()[..., None] * xh.float()                         # [B,S,H,P]

    def rs(t):
        return t.reshape((Bb, NC, c) + tuple(t.shape[2:]))
    la = torch.cumsum(rs(la_step), dim=2)                          # incl. cumsum
    Bc, Cc, uc = rs(B_t.float()), rs(C_t.float()), rs(u)

    # intra-chunk: scores[t,s] = (C_t·B_s)·exp(la_t - la_s), s ≤ t
    dmat = la[:, :, :, None, :] - la[:, :, None, :, :]             # [B,NC,t,s,H]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xh.device))
    dmat = torch.where(mask[None, None, :, :, None], torch.exp(dmat),
                       torch.zeros((), device=xh.device))
    cb = torch.einsum("bntx,bnsx->bnts", Cc, Bc)                   # [B,NC,t,s]
    y_intra = torch.einsum("bnts,bntsh,bnshp->bnthp", cb, dmat, uc)

    # per-chunk state contribution: U = Σ_s exp(la_end - la_s) u_s ⊗ B_s
    dend = torch.exp(la[:, :, -1:, :] - la)                        # [B,NC,c,H]
    U = torch.einsum("bnsh,bnshp,bnsx->bnhpx", dend, uc, Bc)
    a_chunk = torch.exp(la[:, :, -1, :])                           # [B,NC,H]

    s_cur = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=xh.device)
    starts = []
    for i in range(NC):
        starts.append(s_cur)
        s_cur = a_chunk[:, i, :, None, None] * s_cur + U[:, i]
    s_starts = torch.stack(starts, dim=1)                          # [B,NC,H,P,N]

    y_cross = torch.einsum("bnth,bntx,bnhpx->bnthp", torch.exp(la), Cc,
                           s_starts)
    y = (y_intra + y_cross).reshape(Bb, S, H, P)
    return y.to(xh.dtype), s_cur


def mamba_block(x, p, cfg: ModelConfig, *, state: Dict = None):
    """Full mamba mixer.  ``state=None`` → parallel (train/prefill) mode,
    returns (y, new_state); state dict has 'conv' [B,K-1,d_in], 'ssm'
    [B,H,P,N] for single-token decode."""
    s = cfg.ssm
    d_in, H, P = mamba_dims(cfg)
    B, S, _ = x.shape

    xz = x @ p["w_in"]
    xi, z = torch.chunk(xz, 2, dim=-1)
    if state is None:
        xi_conv = _causal_conv(xi, p["conv_w"], p["conv_bias"])
        conv_tail = xi[:, -(s.conv_dim - 1):, :] if S >= s.conv_dim - 1 \
            else F.pad(xi, (0, 0, s.conv_dim - 1 - S, 0))
    else:
        window = torch.cat([state["conv"].to(xi.dtype), xi], dim=1)  # [B,K,d_in]
        xi_conv = torch.einsum("bkc,kc->bc", window, p["conv_w"])[:, None, :] \
            + p["conv_bias"]
        conv_tail = window[:, 1:, :]
    xi_conv = F.silu(xi_conv)

    dt = F.softplus((xi_conv @ p["w_dt"]).float() + p["dt_bias"].float())
    bc = xi_conv @ p["w_bc"]
    B_t, C_t = torch.chunk(bc, 2, dim=-1)
    xh = xi_conv.reshape(B, S, H, P)

    if state is None:
        y, s_final = _ssd_chunked(xh, dt, p["a_log"], B_t, C_t, s.chunk)
    else:
        a = torch.exp(-torch.exp(p["a_log"].float()) * dt[:, 0, :])  # [B,H]
        u = dt[:, 0, :, None] * xh[:, 0].float()                       # [B,H,P]
        s_new = a[:, :, None, None] * state["ssm"].float() \
            + torch.einsum("bhp,bn->bhpn", u, B_t[:, 0].float())
        y = torch.einsum("bn,bhpn->bhp", C_t[:, 0].float(), s_new)
        y = y[:, None].reshape(B, 1, H, P).to(x.dtype)
        s_final = s_new

    y = y + p["d_skip"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(B, S, d_in)
    y = rms_norm(y * F.silu(z), p["ln_y"], cfg.norm_eps)
    out = y @ p["w_out"]
    return out, {"conv": conv_tail, "ssm": s_final}


def mamba_state_shape(cfg: ModelConfig, batch: int):
    s = cfg.ssm
    d_in, H, P = mamba_dims(cfg)
    return {"conv": (batch, s.conv_dim - 1, d_in),
            "ssm": (batch, H, P, s.state_dim)}


# ==========================================================================
# RWKV6 (Finch)
# ==========================================================================
def rwkv_param_spec(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    H = cfg.d_model // cfg.ssm.head_dim
    K = cfg.ssm.head_dim
    lora = 64
    return {
        # time-mix
        "mu_r": (d,), "mu_k": (d,), "mu_v": (d,), "mu_g": (d,), "mu_w": (d,),
        "w_r": (d, d), "w_k": (d, d), "w_v": (d, d), "w_g": (d, d),
        "w_o": (d, d),
        "decay_base": (H, K),
        "decay_lora_a": (d, lora),
        "decay_lora_b": (lora, d),
        "bonus_u": (H, K),
        "ln_x_scale": (d,), "ln_x_bias": (d,),
        # channel-mix
        "mu_ck": (d,), "mu_cr": (d,),
        "cm_k": (d, cfg.d_ff),
        "cm_v": (cfg.d_ff, d),
        "cm_r": (d, d),
    }


def _wkv_chunked(r, k, v, lw, u, chunk: int, use_impl: bool = True):
    """Exact chunked WKV6.  r/k/v/lw: [B,S,H,K] (lw = log decay ≤ 0), u [H,K].
    Returns o [B,S,H,V] and final state [B,H,K,V].

    o_t = r_t · (S_{t-1} + u ⊙ k_t ⊗ v_t);  S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
    """
    if use_impl:
        from repro_torch.kernels import ops
        impl = ops.get_impl("rwkv_wkv")
        if impl is not None:
            out = impl(r, k, v, lw, u, chunk=chunk)
            if isinstance(out, tuple):
                return out
            Bb, _, H, K = r.shape
            return out, torch.zeros((Bb, H, K, v.shape[-1]),
                                    dtype=torch.float32, device=r.device)

    B, S, H, K = r.shape
    V = v.shape[-1]
    c = min(chunk, S)
    assert S % c == 0
    NC = S // c

    def rs(t):
        return t.float().reshape(B, NC, c, H, -1)
    rc, kc, vc, lwc = rs(r), rs(k), rs(v), rs(lw)
    uf = u.float()

    # ---- intra-chunk: sequential over c, vectorized over (B, NC, H) ------
    S_i = torch.zeros((B, NC, H, K, V), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(c):
        r_t, k_t, v_t, w_t = rc[:, :, t], kc[:, :, t], vc[:, :, t], lwc[:, :, t]
        o_t = torch.einsum("bnhk,bnhkv->bnhv", r_t, S_i) \
            + torch.einsum("bnhk,bnhk,bnhv->bnhv", r_t, uf * k_t, v_t)
        S_i = torch.exp(w_t)[..., None] * S_i + k_t[..., None] * v_t[..., None, :]
        outs.append(o_t)
    o_intra = torch.stack(outs, dim=2)                      # [B,NC,c,H,V]

    # ---- inter-chunk state loop -------------------------------------------
    w_chunk = torch.exp(torch.sum(lwc, dim=2))              # [B,NC,H,K]
    s_cur = torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
    starts = []
    for i in range(NC):
        starts.append(s_cur)
        s_cur = w_chunk[:, i, ..., None] * s_cur + S_i[:, i]
    s_starts = torch.stack(starts, dim=1)                   # [B,NC,H,K,V]

    # ---- cross term: r_t ⊙ exp(exclusive cumsum lw) · S_start ------------
    lwx = torch.cumsum(lwc, dim=2) - lwc                    # exclusive, ≤ 0
    o_cross = torch.einsum("bnchk,bnhkv->bnchv", rc * torch.exp(lwx), s_starts)
    o = (o_intra + o_cross).reshape(B, S, H, V)
    return o, s_cur


def _wkv_decode(r, k, v, lw, u, state):
    """Single token: r/k/v/lw [B,H,K]; state [B,H,K,V]."""
    r, k, v, lw = (t.float() for t in (r, k, v, lw))
    o = torch.einsum("bhk,bhkv->bhv", r, state) \
        + torch.einsum("bhk,bhk,bhv->bhv", r, u.float() * k, v)
    state = torch.exp(lw)[..., None] * state + k[..., None] * v[..., None, :]
    return o, state


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu


def _token_shift(x, last):
    """x [B,S,d]; last [B,d] = final token of the previous segment."""
    prev = torch.cat([last[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)
    return prev, x[:, -1, :]


def rwkv_time_mix(x, p, cfg: ModelConfig, *, shift_state, wkv_state):
    """RWKV6 attention replacement.  Returns (out, (shift', wkv'))."""
    B, S, d = x.shape
    H = d // cfg.ssm.head_dim
    K = cfg.ssm.head_dim
    prev, shift_new = _token_shift(x, shift_state)

    xr = _lerp(x, prev, p["mu_r"])
    xk = _lerp(x, prev, p["mu_k"])
    xv = _lerp(x, prev, p["mu_v"])
    xg = _lerp(x, prev, p["mu_g"])
    xw = _lerp(x, prev, p["mu_w"])

    r = (xr @ p["w_r"]).reshape(B, S, H, K)
    k = (xk @ p["w_k"]).reshape(B, S, H, K)
    v = (xv @ p["w_v"]).reshape(B, S, H, K)
    g = F.silu(xg @ p["w_g"])
    dlora = torch.tanh(xw @ p["decay_lora_a"]) @ p["decay_lora_b"]
    lw = -torch.exp(p["decay_base"].float()[None, None]
                    + dlora.reshape(B, S, H, K).float())        # ≤ 0

    if S == 1 and wkv_state is not None and wkv_state.dim() == 4:
        o, wkv_new = _wkv_decode(r[:, 0], k[:, 0], v[:, 0], lw[:, 0],
                                 p["bonus_u"], wkv_state.float())
        o = o[:, None]
    else:
        o, wkv_new = _wkv_chunked(r, k, v, lw, p["bonus_u"], cfg.ssm.chunk)
        if wkv_state is not None:
            # continuing from a previous segment: fold carried state in via
            # the same cross-term identity (decode path handles step-wise).
            lw_full = torch.cumsum(lw, dim=1) - lw
            o = o + torch.einsum("bshk,bhkv->bshv",
                                 r.float() * torch.exp(lw_full),
                                 wkv_state.float())
            wkv_new = torch.exp(torch.sum(lw, dim=1))[..., None] \
                * wkv_state.float() + wkv_new

    o = o.reshape(B, S, d).to(x.dtype)
    o = layer_scaled_groupnorm(o, p["ln_x_scale"], p["ln_x_bias"], H,
                               cfg.norm_eps)
    out = (o * g) @ p["w_o"]
    return out, (shift_new, wkv_new)


def layer_scaled_groupnorm(x, scale, bias, groups: int, eps: float):
    """Per-group normalisation with the population variance (``jnp.var``
    divides by n; ``torch.var``'s default would divide by n − 1)."""
    B, S, d = x.shape
    xg = x.reshape(B, S, groups, d // groups).float()
    mu = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, keepdim=True, unbiased=False)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return (xg.reshape(B, S, d) * scale + bias).to(x.dtype)


def rwkv_channel_mix(x, p, cfg: ModelConfig, *, shift_state):
    prev, shift_new = _token_shift(x, shift_state)
    xk = _lerp(x, prev, p["mu_ck"])
    xr = _lerp(x, prev, p["mu_cr"])
    h = torch.square(F.relu(xk @ p["cm_k"]))
    out = h @ p["cm_v"]
    rgate = torch.sigmoid(xr @ p["cm_r"])
    return out * rgate, shift_new


def rwkv_state_shape(cfg: ModelConfig, batch: int):
    H = cfg.d_model // cfg.ssm.head_dim
    K = cfg.ssm.head_dim
    return {"wkv": (batch, H, K, K),
            "shift_tm": (batch, cfg.d_model),
            "shift_cm": (batch, cfg.d_model)}
