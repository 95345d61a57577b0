"""Bottleneck diagnosis: *why* is this variant slow?

The paper's feedback loop hands the proposer raw timings and counters;
this module turns them into a structured verdict the search can route on
(the Kernel Foundry / GEAK "identify_bottleneck" idea).  A ``Diagnosis``
is classified per (case, variant, scale) from whichever signals exist:

* analytic roofline terms (``launch/roofline.py``: compute_s / memory_s /
  collective_s per chip),
* ``profile_feedback`` counters (``arithmetic_intensity``,
  ``latency_fraction``, ``mxu_utilization``, ``vmem_bytes``),
* the wall-clock CI of the measurement that produced the timing
  (a wide CI discounts the verdict's confidence).

The verdict is wire-safe (plain dict round-trip) so it can ride through
``RoundLog``/``OptResult`` and the subprocess executors, and compact
enough to inline into an LLM prompt (``summary()``).

Port of ``repro.core.diagnosis``: the vocabulary, rules and thresholds are
the JAX package's; the defaults are the H100's (``repro_torch.hw``) instead
of the TPU's.  ``mxu_utilization`` reads as Hopper tile fill and the
``vmem`` fraction as K1's shared memory per block over the 232,448 bytes a
block may use (``core.profiler``); the field names stay, since the round
journal carries them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

from repro_torch import hw
from repro_torch.core.profiler import SMEM_BYTES

# The closed vocabulary.  "latency" covers serialization / launch overhead
# (sequential scans, many tiny kernels); "occupancy" covers under-filled
# tiles and shared-memory-overflow working sets; "balanced" means no term
# dominates enough to route on.
BOTTLENECKS = ("memory", "compute", "latency", "collective",
               "occupancy", "balanced")

# A tile fill below this makes idle lanes, not raw flops, the thing to fix.
MXU_UTIL_MIN = 0.70
# A working set this close to the shared-memory ceiling is one repair away
# from the AER overflow rule — shrink tiles before anything.
VMEM_FRACTION_MAX = 0.90
# Top-two roofline fractions closer than this → "balanced".
BALANCED_MARGIN = 0.10


def ridge_flop_per_byte() -> float:
    """H100 roofline ridge (dense bf16 over HBM): AI above this is
    compute-bound territory."""
    return hw.PEAK_FLOPS_BF16 / hw.HBM_BW


@dataclass
class Diagnosis:
    """One classified bottleneck + the ratios that justify it."""
    bottleneck: str                     # one of BOTTLENECKS
    compute_fraction: float = 0.0       # share of summed roofline terms
    memory_fraction: float = 0.0
    latency_fraction: float = 0.0
    collective_fraction: float = 0.0
    arithmetic_intensity: float = 0.0   # flop/byte of this variant
    ridge_flop_per_byte: float = 0.0    # platform ridge for context
    mxu_utilization: float = 1.0
    vmem_fraction: float = 0.0          # shared memory / per-block limit
    ci_rel: float = 0.0                 # rel. CI of the timing consumed
    confidence: float = 1.0             # margin of the verdict, CI-discounted

    def to_dict(self) -> Dict[str, Any]:
        return {
            "bottleneck": self.bottleneck,
            "compute_fraction": self.compute_fraction,
            "memory_fraction": self.memory_fraction,
            "latency_fraction": self.latency_fraction,
            "collective_fraction": self.collective_fraction,
            "arithmetic_intensity": self.arithmetic_intensity,
            "ridge_flop_per_byte": self.ridge_flop_per_byte,
            "mxu_utilization": self.mxu_utilization,
            "vmem_fraction": self.vmem_fraction,
            "ci_rel": self.ci_rel,
            "confidence": self.confidence,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Diagnosis":
        return cls(
            bottleneck=str(d.get("bottleneck", "balanced")),
            compute_fraction=float(d.get("compute_fraction", 0.0)),
            memory_fraction=float(d.get("memory_fraction", 0.0)),
            latency_fraction=float(d.get("latency_fraction", 0.0)),
            collective_fraction=float(d.get("collective_fraction", 0.0)),
            arithmetic_intensity=float(d.get("arithmetic_intensity", 0.0)),
            ridge_flop_per_byte=float(d.get("ridge_flop_per_byte", 0.0)),
            mxu_utilization=float(d.get("mxu_utilization", 1.0)),
            vmem_fraction=float(d.get("vmem_fraction", 0.0)),
            ci_rel=float(d.get("ci_rel", 0.0)),
            confidence=float(d.get("confidence", 1.0)),
        )

    def summary(self) -> str:
        """One line for the LLM prompt / journal readers."""
        return (
            f"{self.bottleneck}-bound "
            f"(compute {self.compute_fraction:.0%} / "
            f"memory {self.memory_fraction:.0%} / "
            f"latency {self.latency_fraction:.0%} / "
            f"collective {self.collective_fraction:.0%}; "
            f"AI {self.arithmetic_intensity:.0f} flop/B vs "
            f"ridge {self.ridge_flop_per_byte:.0f}; "
            f"tile fill {self.mxu_utilization:.0%}; "
            f"smem {self.vmem_fraction:.0%}; "
            f"confidence {self.confidence:.2f})")


def classify(compute_s: float, memory_s: float, latency_s: float = 0.0,
             collective_s: float = 0.0, *,
             mxu_utilization: float = 1.0, vmem_fraction: float = 0.0,
             arithmetic_intensity: float = 0.0,
             ci_rel: float = 0.0) -> Diagnosis:
    """Classify the bottleneck from roofline-style time terms.

    Priority order (each rule fires only when the signal is decisive):
      1. shared-memory overflow imminent → occupancy (tiles must shrink
         first);
      2. dominant latency / collective term → that class;
      3. compute-dominant but tiles badly under-filled → occupancy
         (alignment, not flops, is the lever);
      4. compute vs memory by dominant term, "balanced" when the top two
         fractions are within BALANCED_MARGIN.
    Confidence is the top-two margin, discounted by the timing's relative
    CI — a noisy measurement shouldn't route the search hard.
    """
    terms = {"compute": max(compute_s, 0.0), "memory": max(memory_s, 0.0),
             "latency": max(latency_s, 0.0),
             "collective": max(collective_s, 0.0)}
    total = sum(terms.values())
    if total <= 0.0:
        frac = {k: 0.0 for k in terms}
    else:
        frac = {k: v / total for k, v in terms.items()}
    ranked = sorted(frac, key=frac.get, reverse=True)
    top, second = ranked[0], ranked[1]
    margin = frac[top] - frac[second]

    if total <= 0.0:
        bottleneck, raw_conf = "balanced", 0.0
    elif vmem_fraction > VMEM_FRACTION_MAX:
        bottleneck, raw_conf = "occupancy", 1.0
    elif top == "latency":
        bottleneck, raw_conf = "latency", frac["latency"]
    elif top == "collective":
        bottleneck, raw_conf = "collective", frac["collective"]
    elif top == "compute" and mxu_utilization < MXU_UTIL_MIN:
        # flops dominate but the tiles are under-filled: fix alignment first
        bottleneck, raw_conf = "occupancy", 1.0 - mxu_utilization
    elif margin < BALANCED_MARGIN:
        bottleneck, raw_conf = "balanced", 1.0 - margin / BALANCED_MARGIN
    else:
        bottleneck, raw_conf = top, margin

    confidence = max(0.05, min(1.0, raw_conf) - max(ci_rel, 0.0))
    return Diagnosis(
        bottleneck=bottleneck,
        compute_fraction=frac["compute"], memory_fraction=frac["memory"],
        latency_fraction=frac["latency"],
        collective_fraction=frac["collective"],
        arithmetic_intensity=arithmetic_intensity,
        ridge_flop_per_byte=ridge_flop_per_byte(),
        mxu_utilization=mxu_utilization, vmem_fraction=vmem_fraction,
        ci_rel=ci_rel, confidence=confidence)


def diagnose_feedback(feedback: Mapping[str, float], *,
                      ci_rel: float = 0.0,
                      peak_flops: Optional[float] = None,
                      hbm_bw: Optional[float] = None) -> Diagnosis:
    """Classify from ``Platform.profile_feedback`` counters.

    Works on the minimal CPU feedback (flops / traffic_bytes / AI) and on
    the H100 platforms' extended set (mxu_utilization / vmem_bytes /
    latency_s); missing counters default to neutral values.
    """
    peak = peak_flops if peak_flops is not None else hw.PEAK_FLOPS_BF16
    bw = hbm_bw if hbm_bw is not None else hw.HBM_BW
    fl = float(feedback.get("flops", 0.0))
    tb = float(feedback.get("traffic_bytes", 0.0))
    util = float(feedback.get("mxu_utilization", 1.0))
    compute_s = fl / peak / max(util, 0.05)
    memory_s = tb / bw
    latency_s = float(feedback.get("latency_s", 0.0))
    collective_s = float(feedback.get("collective_s", 0.0))
    ai = float(feedback.get("arithmetic_intensity",
                            fl / max(tb, 1.0)))
    vmem_fraction = float(feedback.get("vmem_bytes", 0.0)) / SMEM_BYTES
    return classify(compute_s, memory_s, latency_s, collective_s,
                    mxu_utilization=util, vmem_fraction=vmem_fraction,
                    arithmetic_intensity=ai, ci_rel=ci_rel)
