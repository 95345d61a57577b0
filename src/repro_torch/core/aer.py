"""Diagnostics-guided Automatic Error Repair (paper §3.1 / §3.2).

When a candidate fails to build, compile, run, or pass FE, the framework
feeds the diagnostics back and repairs the candidate instead of discarding
it.  The paper sends (code + diagnostics) to the LLM; offline, the repair
rules below encode the same fixes the LLM applies — each rule inspects the
error text and the variant and returns a corrected variant (or None if it
doesn't apply).  ``LLMProposer.repair`` overrides this with a real
model-in-the-loop when an endpoint is configured.

Port of ``repro.core.aer``.  The rules and thresholds are the JAX
package's, but for one: VMEM overflow becomes shared-memory overflow.  K1's
and K5's wrappers refuse a tile whose shared memory exceeds what an H100
block may use, with a message naming "shared memory" and the bytes, and the
``_smem_overflow`` rule halves the largest block, as ``_vmem_overflow`` did.
Process-level faults (``WorkerFault``) arrive with the worker fabric
(ROADMAP queue 1, "The campaign fabric").
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from repro_torch.core.kernelcase import KernelCase, Variant
from repro_torch.core.profiler import SMEM_BYTES, variant_smem_bytes


@dataclass
class RepairRecord:
    stage: str            # build | compile | run | fe | worker
    error: str
    rule: str
    before: Variant
    after: Variant


def _largest_divisor_leq(n: int, b: int) -> int:
    b = min(b, n)
    for d in range(b, 0, -1):
        if n % d == 0:
            return d
    return 1


def _block_divisibility(case, variant, error, scale) -> Optional[Tuple[str, Variant]]:
    if not re.search(r"divi|grid|block|remainder|must be a multiple|"
                     r"not divisible|incompatible shapes", error, re.I):
        return None
    v = dict(variant)
    changed = False
    for key in ("block_m", "block_n", "block_k", "block"):
        if key in v and isinstance(v[key], int):
            fixed = _largest_divisor_leq(scale, v[key])
            if fixed != v[key]:
                v[key] = fixed
                changed = True
    return ("block_divisibility", v) if changed else None


def _smem_overflow(case, variant, error, scale) -> Optional[Tuple[str, Variant]]:
    over = re.search(r"shared memory|vmem|memory|resource exhausted|alloc",
                     error, re.I) \
        or variant_smem_bytes(variant, scale, case) > SMEM_BYTES
    if not over:
        return None
    v = dict(variant)
    blocks = [(k, v[k]) for k in ("block_m", "block_n", "block_k", "block")
              if isinstance(v.get(k), int)]
    if not blocks:
        return None
    key, val = max(blocks, key=lambda kv: kv[1])
    if val <= 8:
        return None
    v[key] = max(8, val // 2)
    return ("smem_halve_largest_block", v)


def _dtype_mismatch(case, variant, error, scale) -> Optional[Tuple[str, Variant]]:
    if not re.search(r"dtype|cannot be converted|type mismatch", error, re.I):
        return None
    if variant.get("compute_dtype") == "f32":
        return None
    return ("accumulate_in_f32", dict(variant, compute_dtype="f32"))


def _fe_precision(case, variant, error, scale) -> Optional[Tuple[str, Variant]]:
    """FE failure with a low-precision strategy → restore f32 accumulation."""
    if "FE" not in error:
        return None
    v = dict(variant)
    changed = False
    if v.get("compute_dtype") == "bf16":
        v["compute_dtype"] = "f32"
        changed = True
    if v.get("fast_math"):
        v["fast_math"] = False
        changed = True
    return ("fe_restore_precision", v) if changed else None


def _algorithmic_fallback(case, variant, error, scale) -> Optional[Tuple[str, Variant]]:
    """Last resort: drop the most aggressive algorithmic knob."""
    order = ("two_pass_fuse", "welford", "rsqrt_trick", "unroll",
             "fuse_epilogue", "one_pass")
    v = dict(variant)
    for key in order:
        if v.get(key):
            v[key] = False
            return (f"drop_{key}", v)
    return None


RULES: List[Callable] = [
    _block_divisibility, _smem_overflow, _dtype_mismatch,
    _fe_precision, _algorithmic_fallback,
]


class AER:
    """Stateful repairer: tracks what it already tried per candidate so the
    loop terminates."""

    def __init__(self, case: KernelCase, scale: int, max_repairs: int = 4):
        self.case = case
        self.scale = scale
        self.max_repairs = max_repairs
        self.records: List[RepairRecord] = []

    def repair(self, variant: Variant, error: str, stage: str
               ) -> Optional[Variant]:
        if len(self.records) >= self.max_repairs * 4:
            return None
        for rule in RULES:
            res = rule(self.case, variant, error, self.scale)
            if res is None:
                continue
            name, fixed = res
            if fixed == variant:
                continue
            self.records.append(RepairRecord(stage, error[:500], name,
                                             dict(variant), dict(fixed)))
            return fixed
        return None
