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
``ssm_chunk`` and ``rwkv_wkv`` sites as the JAX twins do.  Where the caller
needs the final state (``need_state``: prefill, or a segment continuing
from a carried state) the impl is called with ``return_state=True`` and
must return ``(out, state)``, as every build of the ``rwkv_wkv`` /
``mamba_ssd`` cases does; an impl that returns ``out`` alone raises there
and names its site.  K6 (``kernels.rwkv_wkv.wkv``) and K7
(``kernels.ssd_scan.ssd``) return ``(out, state)`` on every call and are
installed as ``stateful_site(wrapper)``, which takes the keyword.  The
JAX twins hand decode a state of zeros instead (ROADMAP.md queue 3).
Where no state is needed (a forward that keeps no cache) the impl is
called without the keyword, and an output alone gets zeros, which nothing
reads.  Weights keep the ``[in, out]`` layout, so ``x @ w`` is the twin's
``einsum``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (partial_mm, rms_norm,
                                       split_rms_norm)
from repro_torch.sharding import ShardCtx, comm

_NULL = ShardCtx.null()


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


def mamba_param_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """name → logical axes of ``mamba_param_spec``'s parameters."""
    return {"w_in": ("d_model", "ffn"), "conv_w": ("conv", "ffn"),
            "conv_bias": ("ffn",), "w_bc": ("ffn", "state"),
            "w_dt": ("ffn", "heads"), "dt_bias": ("heads",),
            "a_log": ("heads",), "d_skip": ("heads",), "ln_y": ("ffn",),
            "w_out": ("ffn", "d_model")}


def _causal_conv(x, w, b):
    """Depthwise causal conv along seq: x [B,S,C], w [K,C]."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return out + b


def stateful_site(fn):
    """A recurrent site's impl from a kernel wrapper that returns
    ``(out, state)`` on every call: it takes the sites' ``return_state``
    keyword and passes the rest on."""
    def impl(*args, return_state: bool = False, **kw):
        return fn(*args, **kw)
    return impl


def _site_call(site: str, impl, args, chunk: int, need_state: bool,
               state_shape, device):
    """``impl`` at a recurrent ``site`` → (out, final state); see the module
    docstring for ``need_state``."""
    if not need_state:
        out = impl(*args, chunk=chunk)
        if isinstance(out, tuple):
            return out
        return out, torch.zeros(state_shape, dtype=torch.float32,
                                device=device)
    out = impl(*args, chunk=chunk, return_state=True)
    if not isinstance(out, tuple):
        raise RuntimeError(
            f"the impl installed at {site!r} returned no state: prefill "
            "hands decode the site's final state, so an impl there must "
            "return (out, state) when called with return_state=True")
    return out


def _ssd_chunked(xh, dt, a_log, B_t, C_t, chunk: int, use_impl: bool = True,
                 need_state: bool = False):
    """Exact SSD over chunks.

    xh [B,S,H,P] inputs per head; dt [B,S,H] (post-softplus); a_log [H] (>0);
    B_t, C_t [B,S,N].  Returns y [B,S,H,P] and final state [B,H,P,N].
    """
    if use_impl:
        from repro_torch.kernels import ops
        impl = ops.get_impl("ssm_chunk")
        if impl is not None:
            Bb, _, H, P = xh.shape
            return _site_call("ssm_chunk", impl, (xh, dt, a_log, B_t, C_t),
                              chunk, need_state,
                              (Bb, H, P, B_t.shape[-1]), xh.device)

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


def mamba_block(x, p, cfg: ModelConfig, *, state: Dict = None,
                need_state: bool = False, tp=None):
    """Full mamba mixer.  ``state=None`` → parallel (train/prefill) mode,
    returns (y, new_state); state dict has 'conv' [B,K-1,d_in], 'ssm'
    [B,H,P,N] for single-token decode.  ``need_state``: the caller keeps
    the parallel mode's final state (prefill).

    Under tensor parallelism (``tp``, a ``layers.TensorParallel``: the
    mamba heads split over the model axis) ``x`` is the region's input and
    ``p`` the rank's pieces: its d_in/n channels, which are its H/n whole
    heads (``w_in``'s columns of them from both halves,
    ``TensorParallel.paired_columns``; ``conv_w`` and the state local),
    ``w_dt`` and ``w_bc`` row-parallel (their partial sums all-reduced in
    one call, then the rank's heads of dt), ``ln_y``'s sum of squares
    all-reduced, and ``w_out`` row-parallel: the output is the rank's
    partial sum (``partial_mm``'s dtype)."""
    s = cfg.ssm
    d_in, H, P = mamba_dims(cfg)
    B, S, _ = x.shape
    w_in = p["w_in"]
    if tp is not None:
        w_in = tp.paired_columns(w_in, d_in)
        d_in, H = d_in // tp.n, H // tp.n

    xz = x @ w_in
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

    if tp is None:
        dt = (xi_conv @ p["w_dt"]).float()
        bc = xi_conv @ p["w_bc"]
    else:
        # every head's dt and B_t, C_t, summed over the ranks' channels
        n_dt = p["w_dt"].shape[-1]
        both = comm.all_reduce_grad(torch.cat([
            partial_mm(xi_conv, p["w_dt"]), partial_mm(xi_conv, p["w_bc"])],
            dim=-1), tp.group)
        # rounded to the activations' dtype where one rank's product is
        dt = tp.columns(both[..., :n_dt], n_dt).to(x.dtype).float()
        bc = both[..., n_dt:].to(x.dtype)
    dt = F.softplus(dt + p["dt_bias"].float())
    B_t, C_t = torch.chunk(bc, 2, dim=-1)
    xh = xi_conv.reshape(B, S, H, P)

    if state is None:
        y, s_final = _ssd_chunked(xh, dt, p["a_log"], B_t, C_t, s.chunk,
                                  need_state=need_state)
    else:
        a = torch.exp(-torch.exp(p["a_log"].float()) * dt[:, 0, :])  # [B,H]
        u = dt[:, 0, :, None] * xh[:, 0].float()                       # [B,H,P]
        s_new = a[:, :, None, None] * state["ssm"].float() \
            + torch.einsum("bhp,bn->bhpn", u, B_t[:, 0].float())
        y = torch.einsum("bn,bhpn->bhp", C_t[:, 0].float(), s_new)
        y = y[:, None].reshape(B, 1, H, P).to(x.dtype)
        s_final = s_new

    y = y + p["d_skip"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(B, S, d_in) * F.silu(z)
    if tp is not None:
        y = split_rms_norm(y, p["ln_y"], cfg.norm_eps, tp, d_in * tp.n)
        return partial_mm(y, p["w_out"]), {"conv": conv_tail,
                                           "ssm": s_final}
    y = rms_norm(y, p["ln_y"], cfg.norm_eps)
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


def rwkv_param_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """name → logical axes of ``rwkv_param_spec``'s parameters."""
    axes = {n: (None,) for n in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w",
                                 "ln_x_scale", "ln_x_bias", "mu_ck", "mu_cr")}
    axes.update({n: ("d_model", "heads") for n in ("w_r", "w_k", "w_v",
                                                   "w_g", "cm_r")})
    axes.update(w_o=("heads", "d_model"), decay_base=("heads", None),
                decay_lora_a=("d_model", None), decay_lora_b=(None, "heads"),
                bonus_u=("heads", None), cm_k=("d_model", "ffn"),
                cm_v=("ffn", "d_model"))
    return axes


def _wkv_chunked(r, k, v, lw, u, chunk: int, use_impl: bool = True,
                 need_state: bool = False):
    """Exact chunked WKV6.  r/k/v/lw: [B,S,H,K] (lw = log decay ≤ 0), u [H,K].
    Returns o [B,S,H,V] and final state [B,H,K,V].

    o_t = r_t · (S_{t-1} + u ⊙ k_t ⊗ v_t);  S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
    """
    if use_impl:
        from repro_torch.kernels import ops
        impl = ops.get_impl("rwkv_wkv")
        if impl is not None:
            Bb, _, H, K = r.shape
            return _site_call("rwkv_wkv", impl, (r, k, v, lw, u), chunk,
                              need_state, (Bb, H, K, v.shape[-1]), r.device)

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


def rwkv_time_mix(x, p, cfg: ModelConfig, *, shift_state, wkv_state,
                  need_state: bool = False, ctx: ShardCtx = _NULL, tp=None):
    """RWKV6 attention replacement.  Returns (out, (shift', wkv')).
    ``need_state``: the caller keeps wkv' (prefill); a segment continuing
    from ``wkv_state`` always needs it.

    Under tensor parallelism (``tp``: the heads split over the model
    axis) ``x`` is the region's input (the whole sequence, so the token
    shift reads the previous token), ``p`` the rank's pieces:
    ``w_r``/``w_k``/``w_v``/``w_g`` and ``decay_lora_b`` column-parallel
    with ``decay_base`` and ``bonus_u`` on the rank's H/n heads (the WKV
    state too), the group norm over those heads with their columns of the
    whole ``ln_x_scale``/``ln_x_bias``, ``w_o`` row-parallel: ``out`` is
    the rank's partial sum (``partial_mm``'s dtype)."""
    B, S, d = x.shape
    K = cfg.ssm.head_dim
    H = p["w_r"].shape[-1] // K          # the rank's heads under tp
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
        o, wkv_new = _wkv_chunked(
            r, k, v, lw, p["bonus_u"], cfg.ssm.chunk,
            need_state=need_state or wkv_state is not None)
        if wkv_state is not None:
            # continuing from a previous segment: fold carried state in via
            # the same cross-term identity (decode path handles step-wise).
            lw_full = torch.cumsum(lw, dim=1) - lw
            o = o + torch.einsum("bshk,bhkv->bshv",
                                 r.float() * torch.exp(lw_full),
                                 wkv_state.float())
            wkv_new = torch.exp(torch.sum(lw, dim=1))[..., None] \
                * wkv_state.float() + wkv_new

    o = o.reshape(B, S, H * K).to(x.dtype)
    scale, bias = p["ln_x_scale"], p["ln_x_bias"]
    if tp is not None:
        scale, bias = tp.columns(scale, d), tp.columns(bias, d)
    o = layer_scaled_groupnorm(o, scale, bias, H, cfg.norm_eps)
    if tp is not None:
        return partial_mm(o * g, p["w_o"]), (shift_new, wkv_new)
    out = (o * g) @ p["w_o"]
    return ctx.constrain(out, "batch", "seq", None), (shift_new, wkv_new)


def layer_scaled_groupnorm(x, scale, bias, groups: int, eps: float):
    """Per-group normalisation with the population variance (``jnp.var``
    divides by n; ``torch.var``'s default would divide by n − 1)."""
    B, S, d = x.shape
    xg = x.reshape(B, S, groups, d // groups).float()
    mu = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, keepdim=True, unbiased=False)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return (xg.reshape(B, S, d) * scale + bias).to(x.dtype)


def rwkv_channel_mix(x, p, cfg: ModelConfig, *, shift_state,
                     ctx: ShardCtx = _NULL, tp=None):
    """RWKV6 channel mix.  Returns (out, shift').

    Under tensor parallelism (``tp``: ``d_ff`` and ``cm_r``'s columns
    split over the model axis) ``x`` is the region's input, ``cm_k``
    column- and ``cm_v`` row-parallel; the row-parallel partial ``h @
    cm_v`` is reduce-scattered over d to the rank's d/n columns, where
    ``cm_r``'s gate (column-parallel) is whole too, and the gated columns
    are joined into the residual's layout (``TensorParallel
    .join_columns``): ``out`` is the residual's, not a partial sum."""
    prev, shift_new = _token_shift(x, shift_state)
    xk = _lerp(x, prev, p["mu_ck"])
    xr = _lerp(x, prev, p["mu_cr"])
    h = torch.square(F.relu(xk @ p["cm_k"]))
    if tp is not None:
        out = comm.scatter_partials(partial_mm(h, p["cm_v"]), tp.group,
                                    2).to(x.dtype)
        gated = out * torch.sigmoid(xr @ p["cm_r"])
        return tp.join_columns(gated), shift_new
    if ctx.attn_impl == "cp":
        h = ctx.constrain(h, "batch", "seq", None)
    else:
        h = ctx.constrain(h, "batch", None, "ffn")
    out = h @ p["cm_v"]
    rgate = torch.sigmoid(xr @ p["cm_r"])
    return out * rgate, shift_new


def rwkv_state_shape(cfg: ModelConfig, batch: int):
    H = cfg.d_model // cfg.ssm.head_dim
    K = cfg.ssm.head_dim
    return {"wkv": (batch, H, K, K),
            "shift_tm": (batch, cfg.d_model),
            "shift_cm": (batch, cfg.d_model)}
