"""AMD APP SDK suite: the 8 kernels of paper Table 3 as KernelCases.

Port of ``repro.kernels.suites.appsdk``.  Same conventions as the PolyBench
suite: naive multi-pass / gather-heavy baselines mirroring the SDK sample
kernels; variant spaces expose fusion, reshape-based butterflies (no
gathers), algorithm swaps, and tile shapes.  Flops, traffic, latency,
scales, variant space and baseline are the JAX package's.  Builds:

* ``impl="torch"`` (the counterpart of ``"jnp"``): one PyTorch call per
  logical pass where the JAX build jits passes separately; ``lax.scan``
  loops become Python loops.  The gathers of the baselines (``idx ^ d``
  partners) stay gathers: they are what the reshape variants remove.
  ``one_pass`` of ``dwthaar1d`` and ``fastwalshtransform``, one jit over
  every level in the JAX build, is one CUDA graph replay on the card
  (``OnePass``) and the eager chain on the CPU.
* ``impl="cuda"`` (the counterpart of ``"pallas"``) mirrors the JAX
  ``pallas`` branch: ``matrixmultiplication`` calls K1
  (``kernels.matmul``), ``reduction`` K3 (``kernels.reduce_sum``) and
  ``vectoradd`` K4 (``kernels.elementwise``) where the JAX build calls
  ``matmul_pallas``, ``reduce_sum_pallas`` and ``elementwise_pallas``;
  ``simpleconvolution``'s is the shifts build whatever the variant
  (``appsdk.py:330``); the other four cases have no ``pallas`` branch, so
  ``impl`` changes nothing there.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.kernelcase import ArraySpec, KernelCase, register
from repro_torch.kernels.elementwise import elementwise
from repro_torch.kernels.matmul import matmul
from repro_torch.kernels.reduce_sum import reduce_sum

F32 = "float32"


def _dt(variant):
    return torch.bfloat16 if variant.get("compute_dtype") == "bf16" \
        else torch.float32


# ------------------------------------------------------ binomialoption ----
_STEPS = 128
_RISK_FREE, _VOL, _T = 0.02, 0.3, 1.0


def _f32_params():
    """The tree's scalars computed in f32, as JAX's weak-typed scalars are
    (Python's math would give f64 and move results by ~1e-7 relative), as
    Python floats holding those f32 values: u, the down-factor d, the
    up-probability p, the discount df, 1 - p, df·p and df·(1 - p)."""
    f32 = functools.partial(torch.tensor, dtype=torch.float32)
    dt = _T / _STEPS
    u = torch.exp(_VOL * torch.sqrt(f32(dt)))
    d = 1.0 / u
    p = (torch.exp(f32(_RISK_FREE * dt)) - d) / (u - d)
    df = torch.exp(f32(-_RISK_FREE * dt))
    q = 1 - p
    return tuple(float(t) for t in (u, d, p, df, q, df * p, df * q))


_U, _D, _P, _DF, _Q, _DFP, _DFQ = _f32_params()


def _leaves(S0, K):
    """Option values at expiry, [options, steps + 1]."""
    j = torch.arange(_STEPS + 1, dtype=torch.float32, device=S0.device)
    ST = S0[:, None] * _U ** (2 * j[None, :] - _STEPS)
    return torch.clamp_min(ST - K[:, None], 0.0)


def _binomial_ref(S0, K):
    """European call via CRR binomial tree, batched over options."""
    v = _leaves(S0, K)
    for _ in range(_STEPS):
        v = F.pad(_DF * (_P * v[:, 1:] + _Q * v[:, :-1]), (0, 1))
    return v[:, 0]


def _binomial_build(variant, impl="torch"):
    """One step of the tree a call group (the scan's body); ``unroll``
    unrolls ``lax.scan`` in the JAX build and has no PyTorch counterpart, so
    it does not change this build; ``fuse_probs`` folds the discount into
    the probabilities."""
    fuse = variant.get("fuse_probs", False)
    pu, pd = (_DFP, _DFQ) if fuse else (_P, _Q)

    def fn(S0, K):
        v = _leaves(S0, K)
        for _ in range(_STEPS):
            nxt = pu * v[:, 1:] + pd * v[:, :-1]
            if not fuse:
                nxt = _DF * nxt
            v = F.pad(nxt, (0, 1))
        return v[:, 0]
    return fn


register(KernelCase(
    name="binomialoption", suite="appsdk", family="scan",
    ref=_binomial_ref, build=_binomial_build,
    input_specs=lambda s: [ArraySpec((s,), F32, "uniform", 10, 100),
                           ArraySpec((s,), F32, "uniform", 10, 100)],
    variant_space={"unroll": [1, 2, 4, 8], "fuse_probs": [False, True]},
    baseline_variant={"unroll": 1, "fuse_probs": False},
    flops=lambda s: 4.0 * s * _STEPS * (_STEPS + 1) / 2,
    latency=lambda v, s: 3e-6 * _STEPS / max(v.get("unroll", 1), 1),
    scales=(1024, 4096, 16384, 65536)))


# --------------------------------------------------------- bitonicsort ----
def _bitonic_ref(x):
    return torch.sort(x, dim=-1).values


@functools.lru_cache(maxsize=64)
def _bitonic_stages(n: int, vectorized: bool, device: str):
    """Per (k, d) stage of the network on n keys, the index tensors the
    JAX build computes under jit: the direction mask of the reshaped
    exchange, or the partner indices and keep-min mask of the gather."""
    idx = torch.arange(n, device=device)
    stages = []
    for k in range(1, int(math.log2(n)) + 1):
        for jj in range(k - 1, -1, -1):
            d = 1 << jj
            if vectorized:
                lo_idx = idx.reshape(n // (2 * d), 2, d)[..., 0, :]
                stages.append((d, ((lo_idx >> k) & 1) == 0))
            else:
                partner = idx ^ d
                up = (idx & (1 << k)) == 0
                stages.append((partner, (idx < partner) == up))
    return stages


def _bitonic_build(variant, impl="torch"):
    if variant.get("use_native_sort"):
        return _bitonic_ref
    vectorized = variant.get("vectorized_exchange", False)

    def net(x):
        n = x.shape[-1]
        for a, b in _bitonic_stages(n, vectorized, str(x.device)):
            if vectorized:
                d, up = a, b
                y = x.reshape(-1, n // (2 * d), 2, d)
                lo_, hi_ = y[..., 0, :], y[..., 1, :]
                mn, mx = torch.minimum(lo_, hi_), torch.maximum(lo_, hi_)
                x = torch.stack([torch.where(up, mn, mx),
                                 torch.where(up, mx, mn)],
                                dim=-2).reshape(x.shape)
            else:
                partner, keep_min = a, b
                px = x[..., partner]
                x = torch.where(keep_min, torch.minimum(x, px),
                                torch.maximum(x, px))
        return x
    return net


register(KernelCase(
    name="bitonicsort", suite="appsdk", family="sort",
    ref=_bitonic_ref, build=_bitonic_build,
    input_specs=lambda s: [ArraySpec((s,), F32)],
    variant_space={"vectorized_exchange": [False, True],
                   "use_native_sort": [False, True]},
    baseline_variant={"vectorized_exchange": False, "use_native_sort": False},
    flops=lambda s: s * math.log2(max(s, 2)) ** 2,
    latency=lambda v, s: (5e-6 * math.log2(max(s, 2)) if v.get("use_native_sort")
                          else 2e-6 * math.log2(max(s, 2)) ** 2
                          * (1 if v.get("vectorized_exchange") else 3)),
    scales=(4096, 16384, 65536, 262144)))


# ------------------------------------------------------------ one pass ----
class OnePass:
    """A chain of passes run as one launch on the card: the counterpart of
    the JAX build's single ``jax.jit`` over the chain.  On a CUDA tensor the
    chain is captured once per (shape, dtype, device) as a CUDA graph and
    replayed: the input is copied into the graph's static input, and the
    caller gets a clone of its static output, so a later call never sees an
    earlier call's buffer.  On the CPU the chain runs eagerly.  ``fn`` takes
    and returns one tensor; tensors it caches (index tables) are made by the
    warm-up call, before capture, so they live outside the graph's pool."""

    def __init__(self, fn):
        self.fn = fn
        self.graphs = {}

    def __call__(self, x):
        if x.device.type != "cuda":
            return self.fn(x)
        key = (tuple(x.shape), x.dtype, x.device)
        if key not in self.graphs:
            self.graphs[key] = self._capture(x)
        graph, static_in, static_out = self.graphs[key]
        static_in.copy_(x)
        graph.replay()
        return static_out.clone()

    def _capture(self, x):
        static_in = x.clone()
        side = torch.cuda.Stream(device=x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):       # warm-up, as torch.cuda.graph asks
            self.fn(static_in)
        torch.cuda.current_stream(x.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = self.fn(static_in)
        return graph, static_in, static_out


# ----------------------------------------------------------- dwthaar1d ----
_SQRT2 = math.sqrt(2.0)


def _dwt_levels(n):
    return int(math.log2(n))


def _dwt_level(a):
    """One Haar level: (averages, details) of the pairs of ``a``."""
    pairs = a.reshape(-1, 2)
    return ((pairs[:, 0] + pairs[:, 1]) / _SQRT2,
            (pairs[:, 0] - pairs[:, 1]) / _SQRT2)


def _dwt_ref(x):
    out = []
    a = x
    for _ in range(_dwt_levels(x.shape[0])):
        a, d = _dwt_level(a)
        out.append(d)
    return torch.cat([a] + out[::-1])


def _dwt_build(variant, impl="torch"):
    """The baseline launches each level's passes in turn (one jit per level
    in the JAX build); ``one_pass`` runs every level as one graph on the
    card (one jit over all of them)."""
    return OnePass(_dwt_ref) if variant.get("one_pass") else _dwt_ref


register(KernelCase(
    name="dwthaar1d", suite="appsdk", family="stencil",
    ref=_dwt_ref, build=_dwt_build,
    input_specs=lambda s: [ArraySpec((s,), F32)],
    variant_space={"one_pass": [False, True]},
    baseline_variant={"one_pass": False},
    flops=lambda s: 4.0 * s,
    latency=lambda v, s: (2e-6 if v.get("one_pass") else 5e-6) * math.log2(max(s, 2)),
    scales=(16384, 65536, 262144, 1048576)))


# ---------------------------------------------------- fastwalshtransform --
def _fwt_reshape_stage(x, d):
    y = x.reshape(-1, 2, d)
    return torch.stack([y[:, 0] + y[:, 1], y[:, 0] - y[:, 1]],
                       dim=1).reshape(x.shape[0])


def _fwt_ref(x):
    for j in range(int(math.log2(x.shape[0]))):
        x = _fwt_reshape_stage(x, 1 << j)
    return x


@functools.lru_cache(maxsize=64)
def _fwt_gather(n: int, device: str):
    """Per stage j, the partner indices idx ^ d and the signs (+1 where
    bit j of idx is 0, else -1) that the JAX build computes under jit."""
    idx = torch.arange(n, device=device)
    out = []
    for j in range(int(math.log2(n))):
        d = 1 << j
        out.append((idx ^ d, torch.where((idx & d) == 0, 1.0, -1.0)))
    return out


def _fwt_gathered(x):
    for partner, sign in _fwt_gather(x.shape[0], str(x.device)):
        x = sign * x + x[partner]
    return x


def _fwt_build(variant, impl="torch"):
    """``reshape_butterfly`` replaces the partner gather by a reshape;
    ``one_pass`` runs every stage, in either form, as one graph on the card
    (one jit over the stages in the JAX build), where the baseline launches
    each stage's passes in turn."""
    run = _fwt_ref if variant.get("reshape_butterfly", False) \
        else _fwt_gathered
    return OnePass(run) if variant.get("one_pass", False) else run


register(KernelCase(
    name="fastwalshtransform", suite="appsdk", family="stencil",
    ref=_fwt_ref, build=_fwt_build,
    input_specs=lambda s: [ArraySpec((s,), F32)],
    variant_space={"reshape_butterfly": [False, True],
                   "one_pass": [False, True]},
    baseline_variant={"reshape_butterfly": False, "one_pass": False},
    flops=lambda s: 2.0 * s * math.log2(max(s, 2)),
    latency=lambda v, s: (2e-6 if v.get("one_pass") else 5e-6) * math.log2(max(s, 2)),
    scales=(16384, 65536, 262144, 1048576)))


# ------------------------------------------------- matrixmultiplication ---
def _mm_ref(A, B):
    return A @ B


def _mm_build(variant, impl="torch"):
    dt = _dt(variant)
    if impl == "cuda":
        b = dict(block_m=variant.get("block_m", 128),
                 block_n=variant.get("block_n", 128),
                 block_k=variant.get("block_k", 128))
        return lambda A, B: matmul(A.to(dt), B.to(dt), device=A.device.type,
                                   **b).float()
    return lambda A, B: (A.to(dt) @ B.to(dt)).float()


register(KernelCase(
    name="matrixmultiplication", suite="appsdk", family="matmul",
    ref=_mm_ref, build=_mm_build,
    input_specs=lambda s: [ArraySpec((s, s), F32), ArraySpec((s, s), F32)],
    variant_space={"block_m": [32, 64, 128, 256], "block_n": [32, 64, 128, 256],
                   "block_k": [32, 64, 128, 256],
                   "compute_dtype": ["f32", "bf16"]},
    baseline_variant={"block_m": 32, "block_n": 32, "block_k": 32,
                      "compute_dtype": "f32"},
    flops=lambda s: 2.0 * s ** 3,
    traffic=lambda v, s: 4.0 * (s * s * math.ceil(s / v.get("block_n", 32))
                                + s * s * math.ceil(s / v.get("block_m", 32))
                                + s * s),
    scales=(256, 384, 512, 768, 1024)))


# ------------------------------------------------------------ reduction ---
def _red_ref(x):
    return torch.sum(x, dtype=torch.float32)[None]


def _red_build(variant, impl="torch"):
    blk = variant.get("block", 4096)
    if impl == "cuda":
        return lambda x: reduce_sum(x, block=blk, keepdim=True,
                                    device=x.device.type)
    if variant.get("one_pass"):
        return _red_ref

    def p1(x):
        return torch.sum(x.reshape(-1, blk), dim=1, dtype=torch.float32)

    def p2(p):
        return torch.sum(p, dtype=torch.float32)[None]
    return lambda x: p2(p1(x))


register(KernelCase(
    name="reduction", suite="appsdk", family="reduction",
    ref=_red_ref, build=_red_build,
    input_specs=lambda s: [ArraySpec((s,), F32)],
    variant_space={"one_pass": [False, True], "block": [1024, 4096, 16384]},
    baseline_variant={"one_pass": False, "block": 1024},
    flops=lambda s: float(s),
    traffic=lambda v, s: (4.0 if v.get("one_pass") else 4.0 + 8.0 / max(
        v.get("block", 1024), 1)) * s,
    scales=(65536, 262144, 1048576, 4194304)))


# ---------------------------------------------------- simpleconvolution ---
_MASK = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32) / 16.0


def _conv_ref(img):
    """The 3x3 mask as nine shifted, weighted adds over the zero-padded
    image."""
    pad = F.pad(img, (1, 1, 1, 1))
    out = torch.zeros_like(img)
    for di in range(3):
        for dj in range(3):
            out = out + float(_MASK[di, dj]) * pad[di:di + img.shape[0],
                                                   dj:dj + img.shape[1]]
    return out


def _conv_separable(img):
    """The Gaussian mask is rank-1: [1,2,1]/4 ⊗ [1,2,1]/4."""
    k0, k1, k2 = 0.25, 0.5, 0.25
    pad = F.pad(img, (0, 0, 1, 1))
    v = k0 * pad[:-2] + k1 * pad[1:-1] + k2 * pad[2:]
    pad2 = F.pad(v, (1, 1))
    return k0 * pad2[:, :-2] + k1 * pad2[:, 1:-1] + k2 * pad2[:, 2:]


@functools.lru_cache(maxsize=8)
def _conv_weight(device: str):
    return torch.as_tensor(_MASK, device=device)[None, None]


def _conv_general(img):
    """The general convolution path, as ``lax.conv(..., "SAME")``: a
    cross-correlation with zero padding.  cuDNN would run an f32
    convolution in TF32 by default; it is asked for IEEE f32 here."""
    w = _conv_weight(str(img.device))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return F.conv2d(img[None, None], w, padding=1)[0, 0]
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _conv_build(variant, impl="torch"):
    method = variant.get("method", "xla_conv")
    if method == "shifts" or impl == "cuda":
        return _conv_ref
    if method == "separable":
        return _conv_separable
    return _conv_general


register(KernelCase(
    name="simpleconvolution", suite="appsdk", family="stencil",
    ref=_conv_ref, build=_conv_build,
    input_specs=lambda s: [ArraySpec((s, s), F32)],
    variant_space={"method": ["xla_conv", "shifts", "separable"]},
    baseline_variant={"method": "xla_conv"},
    flops=lambda s: 18.0 * s * s,
    traffic=lambda v, s: (3 if v.get("method") == "separable" else 4) * 4.0 * s * s,
    scales=(512, 1024, 2048, 4096)))


# ------------------------------------------------------------ vectoradd ---
def _add(x, y):
    """The map K4 runs: on torch tensors for the plain builds, compiled by
    Triton into the kernel for the ``cuda`` build."""
    return x + y


def _vadd_ref(a, b):
    return a + b


def _vadd_build(variant, impl="torch"):
    if impl == "cuda":
        blk = variant.get("block", 8192)
        return lambda a, b: elementwise(_add, a, b, block=blk,
                                        device=a.device.type)
    if variant.get("one_pass"):
        return _vadd_ref

    # SDK sample stages through intermediate buffers (extra passes)
    def p1(a):
        return a * 1.0

    def p2(b):
        return b * 1.0
    return lambda a, b: _add(p1(a), p2(b))


register(KernelCase(
    name="vectoradd", suite="appsdk", family="elementwise",
    ref=_vadd_ref, build=_vadd_build,
    input_specs=lambda s: [ArraySpec((s,), F32), ArraySpec((s,), F32)],
    variant_space={"one_pass": [False, True], "block": [4096, 8192, 16384]},
    baseline_variant={"one_pass": False, "block": 4096},
    flops=lambda s: float(s),
    traffic=lambda v, s: (3.0 if v.get("one_pass") else 7.0) * 4.0 * s,
    scales=(262144, 1048576, 4194304, 16777216)))
