"""HPC hotspot suite: the application's own hotspot kernels as KernelCases
(paper Table 4 — kernels extracted from a large application whose full
build is too expensive to re-run per candidate).

Port of ``repro.kernels.suites.hpc``; holds ``attention_prefill``
(``hpc.py:31-89``), whose ``app_site`` is the ``attention`` site the port's
LM consults, so ``core.integrate`` can reintegrate the winner and measure
the Integrated Speedup.  ``rwkv_wkv``, ``mamba_ssd`` and
``moe_grouped_gemm`` wait for ROADMAP queue 1 item 7.
"""
from __future__ import annotations

from repro_torch.core.kernelcase import ArraySpec, KernelCase, register
from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_attention import flash_attention

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
