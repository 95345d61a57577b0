"""HPC hotspot suite: the application's own hotspot kernels as KernelCases
(paper Table 4 — kernels extracted from a large application whose full
build is too expensive to re-run per candidate).

Port of ``repro.kernels.suites.hpc``: ``attention_prefill``, ``rwkv_wkv``,
``mamba_ssd`` and ``moe_grouped_gemm``.  The ``app_site``s of the first
three (``attention``, ``rwkv_wkv``, ``ssm_chunk``) are the sites the
port's LM consults, so ``core.integrate`` can reintegrate a winner and
measure the Integrated Speedup; ``moe_gemm`` is declared in ``ops`` but no
model consults it, in the JAX package as here (its ``moe_block`` runs
einsums).  The ``cuda`` builds are the hand-written kernels K2, K6, K7 and
K5 where the JAX builds call their Pallas kernels; specs, variant spaces,
baselines and cost models are the JAX package's.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernelcase import ArraySpec, KernelCase, register
from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gemm import grouped_matmul
from repro_torch.kernels.rwkv_wkv import wkv
from repro_torch.kernels.ssd_scan import ssd
from repro_torch.models.ssm import _ssd_chunked, _wkv_chunked

F32 = "float32"

_ATT_B, _ATT_H, _ATT_KV, _ATT_HD = 2, 8, 2, 64


# ------------------------------------------------------- attention --------
def _att_ref(q, k, v):
    return kref.attention_ref(q, k, v, causal=True)


def _att_build(variant, impl="torch"):
    """Site signature: (q, k, v, causal=..., softcap=...).

    ``impl="cuda"`` is the hand-written flash kernel K2.  Its tile is fixed
    (64 query rows by 64 keys, ``csrc/flash_attention.cu``), so ``block_q``
    and ``block_k`` do not change it; they shape the ``chunked`` torch
    build, as in the JAX package.  ``compute_dtype`` changes no build here,
    as it changes none there."""
    if impl == "cuda":
        def fn(q, k, v, causal=True, softcap=0.0):
            return flash_attention(q, k, v, causal=True, softcap=softcap,
                                   device=q.device.type)
        return fn
    if variant.get("chunked"):
        qc = variant.get("block_q", 128)

        def chunked_core(q, k, v, causal=True, softcap=0.0):
            from repro_torch.models.layers import attention_chunked
            return attention_chunked(q, k, v, causal=True, q_chunk=qc,
                                     use_impl=False)
        return chunked_core

    # naive: full S×T score matrix materialized (the extracted hotspot)
    def naive_core(q, k, v, causal=True, softcap=0.0):
        return kref.attention_ref(q, k, v, causal=True)
    return naive_core


def _att_specs(s):
    return [ArraySpec((_ATT_B, s, _ATT_H, _ATT_HD), F32),
            ArraySpec((_ATT_B, s, _ATT_KV, _ATT_HD), F32),
            ArraySpec((_ATT_B, s, _ATT_KV, _ATT_HD), F32)]


register(KernelCase(
    name="attention_prefill", suite="hpc", family="attention",
    ref=_att_ref, build=_att_build,
    input_specs=_att_specs,
    variant_space={"chunked": [False, True],
                   "block_q": [64, 128, 256], "block_k": [64, 128, 256],
                   "compute_dtype": ["f32", "bf16"]},
    baseline_variant={"chunked": False, "block_q": 64, "block_k": 64,
                      "compute_dtype": "f32"},
    flops=lambda s: 4.0 * _ATT_B * _ATT_H * s * s * _ATT_HD,
    traffic=lambda v, s: 4.0 * _ATT_B * _ATT_H * s * (
        2 * _ATT_HD + (0 if v.get("chunked") else 2 * s)),
    latency=lambda v, s: 1e-6 * (s / v.get("block_q", 64)
                                 if v.get("chunked") else 3.0),
    app_site="attention",
    scales=(256, 512, 1024, 2048)))


# ---------------------------------------------------------- rwkv wkv ------
_WKV_B, _WKV_H, _WKV_K = 2, 8, 64


def _wkv_case_ref(r, k, v, lw, u):
    o, _ = kref.wkv_ref(r, k, v, lw, u)
    return o


def _wkv_build(variant, impl="torch"):
    """Site signature: (r, k, v, lw, u, chunk=..., return_state=False) → o,
    or (o, final state [B,H,K,V] f32) with ``return_state=True``, as the
    model asks at its ``rwkv_wkv`` site when prefill keeps the state (the
    Pallas build returns o alone; ROADMAP.md queue 3).

    ``impl="cuda"`` is the hand-written WKV kernel K6, with ``chunk`` the
    time steps it stages per load.  The ``chunked`` torch build is the
    model's three-phase chunked WKV; the naive one the sequential
    recurrence."""
    chunk = variant.get("chunk", 64)
    if impl == "cuda":
        def fn(r, k, v, lw, u, *, return_state=False, **kw):
            out = wkv(r, k, v, lw, u, chunk=chunk, device=r.device.type)
            return out if return_state else out[0]
        return fn
    if variant.get("chunked"):
        def chunked(r, k, v, lw, u, *, return_state=False, **kw):
            o, state = _wkv_chunked(r, k, v, lw, u, chunk, use_impl=False)
            return (o.to(r.dtype), state) if return_state else o.to(r.dtype)
        return chunked

    # naive: sequential token-by-token recurrence (the extracted hotspot)
    def seq(r, k, v, lw, u, *, return_state=False, **kw):
        o, state = kref.wkv_ref(r, k, v, lw, u)
        return (o.to(r.dtype), state) if return_state else o.to(r.dtype)
    return seq


def _wkv_specs(s):
    shp = (_WKV_B, s, _WKV_H, _WKV_K)
    return [ArraySpec(shp, F32), ArraySpec(shp, F32), ArraySpec(shp, F32),
            ArraySpec(shp, F32, "uniform", -3.0, -0.01),
            ArraySpec((_WKV_H, _WKV_K), F32)]


register(KernelCase(
    name="rwkv_wkv", suite="hpc", family="scan",
    ref=_wkv_case_ref, build=_wkv_build,
    input_specs=_wkv_specs,
    variant_space={"chunked": [False, True], "chunk": [16, 32, 64, 128]},
    baseline_variant={"chunked": False, "chunk": 64},
    flops=lambda s: 6.0 * _WKV_B * _WKV_H * s * _WKV_K * _WKV_K,
    traffic=lambda v, s: 4.0 * _WKV_B * _WKV_H * s * _WKV_K * (
        4 + (2 * _WKV_K / max(v.get("chunk", 64), 1)
             if v.get("chunked") else 2 * _WKV_K)),
    latency=lambda v, s: 3e-6 * ((v.get("chunk", 64) + s / v.get("chunk", 64))
                                 if v.get("chunked") else s),
    app_site="rwkv_wkv",
    scales=(128, 256, 512, 1024)))


# ---------------------------------------------------------- mamba ssd -----
_SSD_B, _SSD_H, _SSD_P, _SSD_N = 2, 8, 64, 16


def _ssd_case_ref(xh, dt, a_log, B_t, C_t):
    y, _ = kref.ssd_ref(xh, dt, a_log, B_t, C_t)
    return y


def _ssd_build(variant, impl="torch"):
    """Site signature: (xh, dt, a_log, B_t, C_t, chunk=...,
    return_state=False) → y, or (y, final state [B,H,P,N] f32) with
    ``return_state=True``, as the model asks at its ``ssm_chunk`` site when
    prefill keeps the state (the Pallas build returns y alone; ROADMAP.md
    queue 3).

    ``impl="cuda"`` is the hand-written SSD kernel K7 at the variant's
    ``chunk``.  The ``chunked`` torch build is the model's chunked SSD; the
    naive one the sequential scan."""
    chunk = variant.get("chunk", 128)
    if impl == "cuda":
        def fn(xh, dt, a_log, B_t, C_t, *, return_state=False, **kw):
            out = ssd(xh, dt, a_log, B_t, C_t, chunk=chunk,
                      device=xh.device.type)
            return out if return_state else out[0]
        return fn
    if variant.get("chunked"):
        def chunked(xh, dt, a_log, B_t, C_t, *, return_state=False, **kw):
            y, state = _ssd_chunked(xh, dt, a_log, B_t, C_t, chunk,
                                    use_impl=False)
            return (y, state) if return_state else y
        return chunked

    def seq(xh, dt, a_log, B_t, C_t, *, return_state=False, **kw):
        y, state = kref.ssd_ref(xh, dt, a_log, B_t, C_t)
        return (y, state) if return_state else y
    return seq


def _ssd_specs(s):
    return [ArraySpec((_SSD_B, s, _SSD_H, _SSD_P), F32),
            ArraySpec((_SSD_B, s, _SSD_H), F32, "uniform", 0.001, 0.1),
            ArraySpec((_SSD_H,), F32, "uniform", -1.0, 1.0),
            ArraySpec((_SSD_B, s, _SSD_N), F32),
            ArraySpec((_SSD_B, s, _SSD_N), F32)]


register(KernelCase(
    name="mamba_ssd", suite="hpc", family="scan",
    ref=_ssd_case_ref, build=_ssd_build,
    input_specs=_ssd_specs,
    variant_space={"chunked": [False, True], "chunk": [32, 64, 128, 256]},
    baseline_variant={"chunked": False, "chunk": 128},
    flops=lambda s: 6.0 * _SSD_B * _SSD_H * s * _SSD_P * _SSD_N,
    latency=lambda v, s: 3e-6 * ((s / v.get("chunk", 128))
                                 if v.get("chunked") else s),
    app_site="ssm_chunk",
    scales=(256, 512, 1024, 2048)))


# ---------------------------------------------------------- moe gemm ------
_GMM_E, _GMM_K, _GMM_N = 8, 256, 512


def _gmm_ref(x, w):
    return kref.grouped_matmul_ref(x, w)


def _gmm_build(variant, impl="torch"):
    """Site signature: (x, w) → [E, M, N] in f32.

    ``impl="cuda"`` is the hand-written grouped GEMM K5 with the variant's
    tile.  The ``batched`` torch build is one batched product (a library
    call standing in for the JAX einsum); the naive one a GEMM per expert,
    one after another, as ``lax.map`` runs them."""
    dt = torch.bfloat16 if variant.get("compute_dtype") == "bf16" \
        else torch.float32
    if impl == "cuda":
        b = dict(block_m=variant.get("block_m", 128),
                 block_n=variant.get("block_n", 128),
                 block_k=variant.get("block_k", 128))
        return lambda x, w, **kw: grouped_matmul(
            x.to(dt), w.to(dt), device=x.device.type, **b).float()
    if variant.get("batched"):
        return lambda x, w, **kw: torch.bmm(x.to(dt), w.to(dt)).float()

    def per_expert(x, w, **kw):
        return torch.stack([(x[e].to(dt) @ w[e].to(dt)).float()
                            for e in range(x.shape[0])])
    return per_expert


def _gmm_specs(s):
    return [ArraySpec((_GMM_E, s, _GMM_K), F32),
            ArraySpec((_GMM_E, _GMM_K, _GMM_N), F32)]


register(KernelCase(
    name="moe_grouped_gemm", suite="hpc", family="matmul",
    ref=_gmm_ref, build=_gmm_build,
    input_specs=_gmm_specs,
    variant_space={"batched": [False, True], "compute_dtype": ["f32", "bf16"],
                   "block_m": [32, 64, 128, 256],
                   "block_n": [32, 64, 128, 256],
                   "block_k": [32, 64, 128, 256]},
    baseline_variant={"batched": False, "compute_dtype": "f32",
                      "block_m": 32, "block_n": 32, "block_k": 32},
    flops=lambda s: 2.0 * _GMM_E * s * _GMM_K * _GMM_N,
    latency=lambda v, s: (2e-6 if v.get("batched") else 5e-6 * _GMM_E),
    app_site="moe_gemm",
    gemm_dims=lambda s: (s, _GMM_N, _GMM_K),
    scales=(64, 128, 256, 512)))
