"""PolyBench-GPU suite: the 13 kernels of paper Tables 1–2 as KernelCases.

Port of ``repro.kernels.suites.polybench``.  Flops, traffic, latency,
scales, variant space and baseline are the JAX package's.  Builds:

* ``impl="torch"`` (the counterpart of ``"jnp"``): the baseline transcribes
  the naive PolyBench kernels, one PyTorch call per logical pass, as the JAX
  build jits each pass separately; the restructured variants (pass fusion,
  one-pass sweeps, the rank-1 trick, moment forms, blocked Gram-Schmidt,
  hoisted ADI coefficients) write the same algorithm as the JAX build
  (eager PyTorch still launches each operator; only a kernel fuses).
  ``lax.scan`` loops become Python loops.
* ``impl="cuda"`` (the counterpart of ``"pallas"``) mirrors the JAX
  ``pallas`` branch exactly: the matmul family (``gemm``, ``2mm``, ``3mm``,
  ``syrk``, ``syr2k``) calls the hand-written K1
  (``repro_torch.kernels.matmul``) where the JAX build calls
  ``matmul_pallas``, with the variant's tile (``fuse_epilogue`` does not
  change it, as it does not change the Pallas build).  For ``atax``,
  ``bicg``, ``gemver``, ``gesummv``, ``corr``, ``covar`` and ``adi`` that
  branch is the restructured plain build whatever the variant
  (``polybench.py:180,212,244,294,404,461,617``), and ``gramschm`` has no
  ``pallas`` branch: so are they here, and on the ``h100`` platform every
  variant of those cases times one build.
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


# ---------------------------------------------------------------- ATAX ----
def _atax_ref(A, x):
    return A.T @ (A @ x)


def _atax_build(variant, impl="torch"):
    dt = _dt(variant)
    if variant.get("one_pass") or impl == "cuda":
        def fused(A, x):
            Ad = A.to(dt)
            return (Ad.T @ (Ad @ x.to(dt))).float()
        return fused

    def p1(A, x):
        return (A.to(dt) @ x.to(dt)).float()

    def p2(A, t):
        return (A.to(dt).T @ t.to(dt)).float()
    return lambda A, x: p2(A, p1(A, x))


_MV_SPACE = {"one_pass": [False, True], "compute_dtype": ["f32", "bf16"],
             "block": [128, 256, 512]}
_MV_BASE = {"one_pass": False, "compute_dtype": "f32", "block": 128}

register(KernelCase(
    name="atax", suite="polybench", family="matvec",
    ref=_atax_ref, build=_atax_build,
    input_specs=lambda s: [ArraySpec((s, s), F32), ArraySpec((s,), F32)],
    variant_space=_MV_SPACE, baseline_variant=dict(_MV_BASE),
    flops=lambda s: 4.0 * s * s,
    traffic=lambda v, s: (1 if v.get("one_pass") else 2) * 4.0 * s * s,
    scales=(512, 1024, 2048, 4096)))


# ---------------------------------------------------------------- BICG ----
def _bicg_ref(A, p, r):
    return A @ p, A.T @ r


def _bicg_build(variant, impl="torch"):
    dt = _dt(variant)
    if variant.get("one_pass") or impl == "cuda":
        def fused(A, p, r):
            Ad = A.to(dt)
            return ((Ad @ p.to(dt)).float(), (Ad.T @ r.to(dt)).float())
        return fused

    def p1(A, p):
        return (A.to(dt) @ p.to(dt)).float()

    def p2(A, r):
        return (A.to(dt).T @ r.to(dt)).float()
    return lambda A, p, r: (p1(A, p), p2(A, r))


register(KernelCase(
    name="bicg", suite="polybench", family="matvec",
    ref=_bicg_ref, build=_bicg_build,
    input_specs=lambda s: [ArraySpec((s, s), F32), ArraySpec((s,), F32),
                           ArraySpec((s,), F32)],
    variant_space=_MV_SPACE, baseline_variant=dict(_MV_BASE),
    flops=lambda s: 4.0 * s * s,
    traffic=lambda v, s: (1 if v.get("one_pass") else 2) * 4.0 * s * s,
    scales=(512, 1024, 2048, 4096)))


# -------------------------------------------------------------- GEMVER ----
def _gemver_ref(A, u1, v1, u2, v2, y, z):
    Ah = A + torch.outer(u1, v1) + torch.outer(u2, v2)
    x = BETA * (Ah.T @ y) + z
    return Ah @ x * ALPHA, x


def _gemver_build(variant, impl="torch"):
    dt = _dt(variant)
    if variant.get("rank1_trick") or impl == "cuda":
        def fused(A, u1, v1, u2, v2, y, z):
            # never materialize A_hat: fold the rank-1 terms algebraically
            Ad = A.to(dt)
            x = BETA * ((Ad.T @ y.to(dt)).float()
                        + v1 * torch.dot(u1, y) + v2 * torch.dot(u2, y)) + z
            w = ((Ad @ x.to(dt)).float()
                 + u1 * torch.dot(v1, x) + u2 * torch.dot(v2, x))
            return ALPHA * w, x
        return fused
    if variant.get("one_pass"):
        def fusedA(A, u1, v1, u2, v2, y, z):
            Ah = (A + torch.outer(u1, v1) + torch.outer(u2, v2)).to(dt)
            x = BETA * (Ah.T @ y.to(dt)).float() + z
            return ALPHA * (Ah @ x.to(dt)).float(), x
        return fusedA

    def r1(A, u1, v1):
        return A + torch.outer(u1, v1)

    def r2(A, u2, v2):
        return A + torch.outer(u2, v2)

    def mv1(Ah, y, z):
        return BETA * (Ah.T @ y) + z

    def mv2(Ah, x):
        return ALPHA * (Ah @ x)

    def run(A, u1, v1, u2, v2, y, z):
        Ah = r2(r1(A, u1, v1), u2, v2)
        x = mv1(Ah, y, z)
        return mv2(Ah, x), x
    return run


register(KernelCase(
    name="gemver", suite="polybench", family="matvec",
    ref=_gemver_ref, build=_gemver_build,
    input_specs=lambda s: [ArraySpec((s, s), F32)] + [ArraySpec((s,), F32)] * 6,
    variant_space={"one_pass": [False, True], "rank1_trick": [False, True],
                   "compute_dtype": ["f32", "bf16"], "block": [128, 256, 512]},
    baseline_variant={"one_pass": False, "rank1_trick": False,
                      "compute_dtype": "f32", "block": 128},
    flops=lambda s: 8.0 * s * s,
    traffic=lambda v, s: (2 if v.get("rank1_trick")
                          else 4 if v.get("one_pass") else 8) * 4.0 * s * s,
    scales=(512, 1024, 2048, 4096)))


# ------------------------------------------------------------- GESUMMV ----
def _gesummv_ref(A, B, x):
    return ALPHA * (A @ x) + BETA * (B @ x)


def _gesummv_build(variant, impl="torch"):
    dt = _dt(variant)
    if variant.get("one_pass") or impl == "cuda":
        def fused(A, B, x):
            xd = x.to(dt)
            return (ALPHA * (A.to(dt) @ xd).float()
                    + BETA * (B.to(dt) @ xd).float())
        return fused

    def p1(A, x):
        return (A.to(dt) @ x.to(dt)).float()

    def p2(B, x):
        return (B.to(dt) @ x.to(dt)).float()

    def p3(t1, t2):
        return ALPHA * t1 + BETA * t2
    return lambda A, B, x: p3(p1(A, x), p2(B, x))


register(KernelCase(
    name="gesummv", suite="polybench", family="matvec",
    ref=_gesummv_ref, build=_gesummv_build,
    input_specs=lambda s: [ArraySpec((s, s), F32), ArraySpec((s, s), F32),
                           ArraySpec((s,), F32)],
    variant_space=_MV_SPACE, baseline_variant=dict(_MV_BASE),
    flops=lambda s: 4.0 * s * s,
    traffic=lambda v, s: 8.0 * s * s,
    scales=(512, 1024, 2048, 4096)))


# ---------------------------------------------------------------- CORR ----
# jnp.std is the population standard deviation (ddof 0): correction=0
def _std(X):
    return X.std(dim=0, correction=0) + 1e-6


def _corr_ref(X):
    n = X.shape[0]
    mu = X.mean(dim=0)
    Z = (X - mu) / _std(X)
    return Z.T @ Z / (n - 1)


def _corr_build(variant, impl="torch"):
    dt = _dt(variant)
    if variant.get("moment_trick") or impl == "cuda":
        def fused(X):
            # one GEMM over raw data + closed-form moments (one-pass)
            n = X.shape[0]
            Xd = X.to(dt)
            g = (Xd.T @ Xd).float()
            mu = X.mean(dim=0)
            sd = _std(X)
            c = (g - n * torch.outer(mu, mu)) / (n - 1)
            return c / torch.outer(sd, sd)
        return fused
    if variant.get("fuse_epilogue"):
        def fusedz(X):
            n = X.shape[0]
            Z = ((X - X.mean(dim=0)) / _std(X)).to(dt)
            return (Z.T @ Z).float() / (n - 1)
        return fusedz

    def mean(X):
        return X.mean(dim=0)

    def center(X, mu, sd):
        return (X - mu) / sd

    def gram(Z):
        return (Z.to(dt).T @ Z.to(dt)).float() / (Z.shape[0] - 1)
    return lambda X: gram(center(X, mean(X), _std(X)))


_CORR_SPACE = {"fuse_epilogue": [False, True], "moment_trick": [False, True],
               "compute_dtype": ["f32", "bf16"],
               "block_m": [32, 64, 128, 256], "block_n": [32, 64, 128, 256],
               "block_k": [32, 64, 128, 256]}
_CORR_BASE = {"fuse_epilogue": False, "moment_trick": False,
              "compute_dtype": "f32", "block_m": 32, "block_n": 32,
              "block_k": 32}

register(KernelCase(
    name="corr", suite="polybench", family="matmul",
    ref=_corr_ref, build=_corr_build,
    input_specs=lambda s: [ArraySpec((s, s), F32)],
    variant_space=_CORR_SPACE, baseline_variant=dict(_CORR_BASE),
    flops=lambda s: 2.0 * s ** 3 + 6 * s * s,
    traffic=lambda v, s: (2 if v.get("moment_trick") else 5) * 4.0 * s * s,
    scales=(256, 384, 512, 768)))


# --------------------------------------------------------------- COVAR ----
def _covar_ref(X):
    n = X.shape[0]
    Z = X - X.mean(dim=0)
    return Z.T @ Z / (n - 1)


def _covar_build(variant, impl="torch"):
    dt = _dt(variant)
    if variant.get("moment_trick") or impl == "cuda":
        def fused(X):
            n = X.shape[0]
            Xd = X.to(dt)
            g = (Xd.T @ Xd).float()
            mu = X.mean(dim=0)
            return (g - n * torch.outer(mu, mu)) / (n - 1)
        return fused
    if variant.get("fuse_epilogue"):
        def fusedz(X):
            n = X.shape[0]
            Z = (X - X.mean(dim=0)).to(dt)
            return (Z.T @ Z).float() / (n - 1)
        return fusedz

    def mean(X):
        return X.mean(dim=0)

    def center(X, mu):
        return X - mu

    def gram(Z):
        return (Z.to(dt).T @ Z.to(dt)).float() / (Z.shape[0] - 1)
    return lambda X: gram(center(X, mean(X)))


register(KernelCase(
    name="covar", suite="polybench", family="matmul",
    ref=_covar_ref, build=_covar_build,
    input_specs=lambda s: [ArraySpec((s, s), F32)],
    variant_space=_CORR_SPACE, baseline_variant=dict(_CORR_BASE),
    flops=lambda s: 2.0 * s ** 3 + 4 * s * s,
    traffic=lambda v, s: (2 if v.get("moment_trick") else 4) * 4.0 * s * s,
    scales=(256, 384, 512, 768)))


# ------------------------------------------------------------ GRAMSCHM ----
def _gram_sign(Q, A):
    return Q * torch.sign((Q * A).sum(dim=0) + 1e-30)


def _cgs2_columns(cols, Qb):
    """Orthonormalizes ``cols`` column by column into the zeroed ``Qb``,
    each against the columns already there (two projections: CGS2)."""
    for jj in range(cols.shape[1]):
        v = cols[:, jj] - Qb @ (Qb.T @ cols[:, jj])
        v = v - Qb @ (Qb.T @ v)
        Qb[:, jj] = v / (torch.linalg.norm(v) + 1e-12)
    return Qb


def _gram_ref(A):
    # modified Gram-Schmidt Q factor with reorthogonalization (CGS2 —
    # matches the baseline build's numerics), columns sign-normalized
    return _gram_sign(_cgs2_columns(A, torch.zeros_like(A)), A)


def _gram_build(variant, impl="torch"):
    """``lax.scan`` over columns (and blocks) becomes a Python loop; the
    JAX build has no ``pallas`` branch, so ``impl`` changes nothing."""
    bc = variant.get("block_cols", 1)
    reorth = variant.get("reorth", True)

    if bc <= 1:
        def mgs(A):
            Q = torch.zeros_like(A)
            for j in range(A.shape[1]):
                v = A[:, j] - Q @ (Q.T @ A[:, j])
                if reorth:
                    v = v - Q @ (Q.T @ v)
                Q[:, j] = v / (torch.linalg.norm(v) + 1e-12)
            return _gram_sign(Q, A)
        return mgs

    def blocked(A):
        m, n = A.shape
        Q = torch.zeros_like(A)
        for b in range(n // bc):
            cols = A[:, b * bc:(b + 1) * bc]
            # project out everything already computed (two passes = CGS2)
            cols = cols - Q @ (Q.T @ cols)
            cols = cols - Q @ (Q.T @ cols)
            Q[:, b * bc:(b + 1) * bc] = _cgs2_columns(
                cols, torch.zeros((m, bc), dtype=A.dtype, device=A.device))
        return _gram_sign(Q, A)
    return blocked


register(KernelCase(
    name="gramschm", suite="polybench", family="matmul",
    ref=_gram_ref, build=_gram_build,
    input_specs=lambda s: [ArraySpec((s, s), F32)],
    variant_space={"block_cols": [1, 8, 16, 32, 64], "reorth": [True]},
    baseline_variant={"block_cols": 1, "reorth": True},
    flops=lambda s: 4.0 * s ** 3,
    latency=lambda v, s: 5e-6 * (s if v.get("block_cols", 1) <= 1
                                 else s / v.get("block_cols", 1) + v.get("block_cols", 1)),
    traffic=lambda v, s: 4.0 * s * s * (s / max(v.get("block_cols", 1), 1)),
    scales=(128, 192, 256, 384)))


# ----------------------------------------------------------------- ADI ----
_ADI_A, _ADI_B = -0.5, 2.0   # constant tridiagonal (a c) = (-0.5, -0.5)
_TSTEPS = 2


def _thomas_coeffs(n, like):
    """c'_i of the constant tridiagonal system, the scalar recurrence in
    ``like``'s dtype (f32, as the JAX scan computes it) on its device."""
    cp = torch.zeros((), dtype=like.dtype, device=like.device)
    cps = []
    for _ in range(n):
        cp = _ADI_A / (_ADI_B - _ADI_A * cp)
        cps.append(cp)
    return torch.stack(cps)


def _adi_sweep(d, cps):
    """Solve (a, b, a) tridiagonal systems for each row of d [rows, n]:
    the Thomas forward and back substitutions, a loop over columns."""
    n = d.shape[1]
    cp_prev = torch.cat([torch.zeros(1, dtype=d.dtype, device=d.device),
                         cps[:-1]])
    den = _ADI_B - _ADI_A * cp_prev
    carry = torch.zeros(d.shape[0], dtype=d.dtype, device=d.device)
    dps = []
    for i in range(n):
        carry = (d[:, i] - _ADI_A * carry) / den[i]
        dps.append(carry)
    carry = torch.zeros_like(carry)
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        carry = dps[i] - cps[i] * carry
        xs[i] = carry
    return torch.stack(xs, dim=1)


def _adi_ref(U):
    cps = _thomas_coeffs(U.shape[1], U)
    for _ in range(_TSTEPS):
        U = _adi_sweep(U, cps)        # row sweep
        U = _adi_sweep(U.T, cps).T    # column sweep
    return U


def _adi_build(variant, impl="torch"):
    if variant.get("precompute_coeffs") or impl == "cuda":
        def fast(U):
            cps = _thomas_coeffs(U.shape[1], U)  # hoisted, reused
            for _ in range(_TSTEPS):
                U = _adi_sweep(U, cps)
                U = _adi_sweep(U.T, cps).T
            return U
        return fast

    # naive: recompute the scalar coefficient recurrence inside every sweep
    # (as the per-thread CUDA kernel does), one call per sweep
    def sweep(U):
        return _adi_sweep(U, _thomas_coeffs(U.shape[1], U))

    def sweep_t(U):
        return sweep(U.T).T

    def run(U):
        for _ in range(_TSTEPS):
            U = sweep(U)
            U = sweep_t(U)
        return U
    return run


register(KernelCase(
    name="adi", suite="polybench", family="stencil",
    ref=_adi_ref, build=_adi_build,
    input_specs=lambda s: [ArraySpec((s, s), F32)],
    variant_space={"precompute_coeffs": [False, True],
                   "compute_dtype": ["f32"]},
    baseline_variant={"precompute_coeffs": False, "compute_dtype": "f32"},
    flops=lambda s: _TSTEPS * 2 * 5.0 * s * s,
    latency=lambda v, s: 2e-6 * _TSTEPS * 2 * s * (1 if v.get("precompute_coeffs") else 2),
    traffic=lambda v, s: _TSTEPS * 2 * (2 if v.get("precompute_coeffs")
                                        else 3) * 4.0 * s * s,
    scales=(256, 512, 1024, 2048)))
