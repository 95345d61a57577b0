"""PolyBench-GPU suite: the matmul family of paper Tables 1–2 as
KernelCases (``gemm``, ``2mm``, ``3mm``, ``syrk``, ``syr2k``).

Port of the K1 cases of ``repro.kernels.suites.polybench``
(``polybench.py:64-172,318-392``); the other PolyBench cases wait for
ROADMAP queue 1 item 6.  Flops, traffic, scales, variant space and baseline
are the JAX package's.  Builds:

* ``impl="torch"`` (the counterpart of ``"jnp"``): the baseline transcribes
  the naive PolyBench kernels, one PyTorch call per logical pass, as the JAX
  build jits each pass separately; ``fuse_epilogue`` writes the chain as one
  expression (eager PyTorch still launches each operator; only K1 fuses).
* ``impl="cuda"`` (the counterpart of ``"pallas"``): calls the hand-written
  K1 (``repro_torch.kernels.matmul``) exactly where the JAX build calls
  ``matmul_pallas``, with the variant's tile; ``fuse_epilogue`` does not
  change it, as it does not change the Pallas build.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.core.kernelcase import ArraySpec, KernelCase, register
from repro_torch.kernels.matmul import matmul

F32 = "float32"
ALPHA, BETA = 1.5, 1.2


def _dt(variant):
    return torch.bfloat16 if variant.get("compute_dtype") == "bf16" \
        else torch.float32


def _blocks(variant):
    return dict(block_m=variant.get("block_m", 128),
                block_n=variant.get("block_n", 128),
                block_k=variant.get("block_k", 128))


def _k1(a, b, c=None, **kw):
    """K1 on the device the operands lie on."""
    return matmul(a, b, c, device=a.device.type, **kw)


def _mat_traffic(variant, scale, n_mats=2, extra_passes_key="fuse_epilogue"):
    n = scale
    bm = variant.get("block_m", 128)
    bn = variant.get("block_n", 128)
    d = 2 if variant.get("compute_dtype") == "bf16" else 4
    per_mm = n * n * math.ceil(n / bn) + n * n * math.ceil(n / bm) + 2 * n * n
    t = d * per_mm * (n_mats - 1 + 1)
    if not variant.get(extra_passes_key, False):
        t += 4 * 4 * n * n        # unfused epilogue round-trips (fp32)
    return float(t)


_MM_SPACE = {
    "block_m": [32, 64, 128, 256], "block_n": [32, 64, 128, 256],
    "block_k": [32, 64, 128, 256], "compute_dtype": ["f32", "bf16"],
    "fuse_epilogue": [False, True],
}
_MM_BASE = {"block_m": 32, "block_n": 32, "block_k": 32,
            "compute_dtype": "f32", "fuse_epilogue": False}


def _square_inputs(k, scale):
    return [ArraySpec((scale, scale), F32) for _ in range(k)]


# ---------------------------------------------------------------- GEMM ----
def _gemm_ref(A, B, C):
    return ALPHA * (A @ B) + BETA * C


def _gemm_build(variant, impl="torch"):
    dt = _dt(variant)
    if impl == "cuda":
        b = _blocks(variant)

        def fn(A, B, C):
            return _k1(A.to(dt), B.to(dt), C, epilogue="alpha_beta",
                       alpha=ALPHA, beta=BETA, **b).float()
        return fn
    if variant.get("fuse_epilogue"):
        def fused(A, B, C):
            t = (A.to(dt) @ B.to(dt)).float()
            return ALPHA * t + BETA * C
        return fused

    def mm(A, B):
        return (A.to(dt) @ B.to(dt)).float()

    def sc(T):
        return ALPHA * T

    def ad(T, C):
        return T + BETA * C
    return lambda A, B, C: ad(sc(mm(A, B)), C)


register(KernelCase(
    name="gemm", suite="polybench", family="matmul",
    ref=_gemm_ref, build=_gemm_build,
    input_specs=lambda s: _square_inputs(3, s),
    variant_space=_MM_SPACE, baseline_variant=dict(_MM_BASE),
    flops=lambda s: 2.0 * s ** 3 + 2 * s * s,
    traffic=functools.partial(_mat_traffic, n_mats=2),
    scales=(256, 384, 512, 768, 1024)))


# ----------------------------------------------------------------- 2MM ----
def _mm2_ref(A, B, C, D):
    return (ALPHA * (A @ B)) @ C + BETA * D


def _mm2_build(variant, impl="torch"):
    dt = _dt(variant)
    if impl == "cuda":
        b = _blocks(variant)

        def fn(A, B, C, D):
            t = _k1(A.to(dt), B.to(dt), **b)
            return _k1((ALPHA * t.float()).to(dt), C.to(dt), D,
                       epilogue="alpha_beta", alpha=1.0, beta=BETA,
                       **b).float()
        return fn
    if variant.get("fuse_epilogue"):
        def fused(A, B, C, D):
            t = ALPHA * (A.to(dt) @ B.to(dt)).float()
            return (t.to(dt) @ C.to(dt)).float() + BETA * D
        return fused

    def mm1(A, B):
        return (A.to(dt) @ B.to(dt)).float()

    def sc(T):
        return ALPHA * T

    def mm2(T, C):
        return (T.to(dt) @ C.to(dt)).float()

    def ad(T, D):
        return T + BETA * D
    return lambda A, B, C, D: ad(mm2(sc(mm1(A, B)), C), D)


register(KernelCase(
    name="2mm", suite="polybench", family="matmul",
    ref=_mm2_ref, build=_mm2_build,
    input_specs=lambda s: _square_inputs(4, s),
    variant_space=_MM_SPACE, baseline_variant=dict(_MM_BASE),
    flops=lambda s: 4.0 * s ** 3,
    traffic=functools.partial(_mat_traffic, n_mats=3),
    scales=(256, 384, 512, 768)))


# ----------------------------------------------------------------- 3MM ----
def _mm3_ref(A, B, C, D):
    return (A @ B) @ (C @ D)


def _mm3_build(variant, impl="torch"):
    dt = _dt(variant)
    if impl == "cuda":
        b = _blocks(variant)

        def fn(A, B, C, D):
            e = _k1(A.to(dt), B.to(dt), **b)
            f = _k1(C.to(dt), D.to(dt), **b)
            return _k1(e, f, **b).float()
        return fn
    if variant.get("fuse_epilogue"):
        def fused(A, B, C, D):
            e = A.to(dt) @ B.to(dt)
            f = C.to(dt) @ D.to(dt)
            return (e @ f).float()
        return fused

    def mm(X, Y):
        return (X.to(dt) @ Y.to(dt)).float()
    return lambda A, B, C, D: mm(mm(A, B), mm(C, D))


register(KernelCase(
    name="3mm", suite="polybench", family="matmul",
    ref=_mm3_ref, build=_mm3_build,
    input_specs=lambda s: _square_inputs(4, s),
    variant_space=_MM_SPACE, baseline_variant=dict(_MM_BASE),
    flops=lambda s: 6.0 * s ** 3,
    traffic=functools.partial(_mat_traffic, n_mats=3),
    scales=(256, 384, 512, 768)))


# ---------------------------------------------------------------- SYRK ----
def _syrk_ref(A, C):
    return ALPHA * (A @ A.T) + BETA * C


def _syrk_build(variant, impl="torch"):
    dt = _dt(variant)
    if impl == "cuda":
        b = _blocks(variant)

        def fn(A, C):
            # A.T is a strided view: K1 reads it through its strides
            return _k1(A.to(dt), A.to(dt).T, C, epilogue="alpha_beta",
                       alpha=ALPHA, beta=BETA, **b).float()
        return fn
    if variant.get("fuse_epilogue"):
        def fused(A, C):
            Ad = A.to(dt)
            return ALPHA * (Ad @ Ad.T).float() + BETA * C
        return fused

    def mm(A):
        return (A.to(dt) @ A.to(dt).T).float()

    def ep(T, C):
        return ALPHA * T + BETA * C
    return lambda A, C: ep(mm(A), C)


register(KernelCase(
    name="syrk", suite="polybench", family="matmul",
    ref=_syrk_ref, build=_syrk_build,
    input_specs=lambda s: _square_inputs(2, s),
    variant_space=_MM_SPACE, baseline_variant=dict(_MM_BASE),
    flops=lambda s: 2.0 * s ** 3,
    traffic=functools.partial(_mat_traffic, n_mats=2),
    scales=(256, 384, 512, 768, 1024)))


# --------------------------------------------------------------- SYR2K ----
def _syr2k_ref(A, B, C):
    return ALPHA * (A @ B.T + B @ A.T) + BETA * C


def _syr2k_build(variant, impl="torch"):
    dt = _dt(variant)
    if impl == "cuda":
        b = _blocks(variant)

        def fn2(A, B, C):
            Ad, Bd = A.to(dt), B.to(dt)
            t1 = _k1(Ad, Bd.T, **b).float()
            t2 = _k1(Bd, Ad.T, **b).float()
            return ALPHA * (t1 + t2) + BETA * C
        return fn2
    if variant.get("fuse_epilogue"):
        def fused(A, B, C):
            Ad, Bd = A.to(dt), B.to(dt)
            s = (Ad @ Bd.T + Bd @ Ad.T).float()
            return ALPHA * s + BETA * C
        return fused

    def mm1(A, B):
        return (A.to(dt) @ B.to(dt).T).float()

    def mm2(B, A):
        return (B.to(dt) @ A.to(dt).T).float()

    def ep(t1, t2, C):
        return ALPHA * (t1 + t2) + BETA * C
    return lambda A, B, C: ep(mm1(A, B), mm2(B, A), C)


register(KernelCase(
    name="syr2k", suite="polybench", family="matmul",
    ref=_syr2k_ref, build=_syr2k_build,
    input_specs=lambda s: _square_inputs(3, s),
    variant_space=_MM_SPACE, baseline_variant=dict(_MM_BASE),
    flops=lambda s: 4.0 * s ** 3,
    traffic=functools.partial(_mat_traffic, n_mats=2),
    scales=(256, 384, 512, 768)))
