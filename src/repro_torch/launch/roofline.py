"""Roofline terms of a dry-run cell, from the counter of ``launch.hlo_cost``.

Port of ``repro.launch.roofline``, with one NVIDIA H100 SXM's figures
(``repro_torch.hw``) in place of the TPU v5e's:

compute_s    = flops (per rank) / 989e12      dense bf16 tensor cores
memory_s     = bytes (per rank) / 3.35e12     HBM3
collective_s = collective bytes (per rank) / 50e9
                                              one 400 Gb/s NDR port a GPU

The counter runs one rank's program, so its flops and bytes are per rank
(the JAX package reads the same from the SPMD-partitioned module).  Its
collective bytes are the ring model's (all-gather → result, all-reduce →
2 × operand, reduce-scatter and all-to-all → operand).  There is no HLO
text, so ``parse_collectives`` has no counterpart: the counter records
the collectives as it sees them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch import hw


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)
    ops: List[Tuple[str, int]] = field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


@dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float           # ideal-fusion (compulsory) HBM traffic
    collective_bytes_per_chip: float
    n_chips: int
    model_flops_total: float        # 6·N·D (active params)
    collectives: Optional[CollectiveStats] = None
    bytes_per_chip_upper: float = 0.0  # one kernel an op (eager)

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / hw.PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_per_chip / hw.HBM_BW

    @property
    def memory_s_upper(self) -> float:
        return self.bytes_per_chip_upper / hw.HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_chip / hw.LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline lower bound on step time (terms fully overlapped)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_chip * self.n_chips
        return self.model_flops_total / total if total else 0.0

    @property
    def model_flops_utilization(self) -> float:
        """MFU at the roofline bound (the score we hillclimb)."""
        peak = self.n_chips * hw.PEAK_FLOPS_BF16
        return (self.model_flops_total / peak) / self.step_s if self.step_s else 0.0

    def diagnose(self):
        """Classify the bottleneck of this cell (core.diagnosis vocab).
        Dry-run cells have no wall-clock CI and no launch-latency model,
        so latency_s=0 — the classifier splits compute/memory/collective."""
        from repro_torch.core.diagnosis import classify
        return classify(self.compute_s, self.memory_s, 0.0,
                        self.collective_s,
                        arithmetic_intensity=(
                            self.flops_per_chip / self.bytes_per_chip
                            if self.bytes_per_chip else 0.0))

    def to_dict(self) -> Dict:
        d = {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "bytes_per_chip_upper": self.bytes_per_chip_upper,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "n_chips": self.n_chips,
            "model_flops_total": self.model_flops_total,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "memory_s_upper": self.memory_s_upper,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_s": self.step_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.model_flops_utilization,
            "diagnosis": self.diagnose().to_dict(),
        }
        if self.collectives is not None:
            d["collective_bytes_by_kind"] = self.collectives.bytes_by_kind
            d["collective_count_by_kind"] = self.collectives.count_by_kind
        return d


def from_cost(cost, *, n_chips: int, model_flops_total: float) -> Roofline:
    """The terms of a ``launch.hlo_cost.Cost`` counted on one rank."""
    st = CollectiveStats(
        bytes_by_kind={k: int(v) for k, v in cost.coll_bytes.items()},
        count_by_kind={k: int(v) for k, v in cost.coll_count.items()})
    return Roofline(flops_per_chip=cost.flops,
                    bytes_per_chip=cost.hbm_bytes_ideal,
                    collective_bytes_per_chip=cost.collective_bytes,
                    n_chips=n_chips, model_flops_total=model_flops_total,
                    collectives=st, bytes_per_chip_upper=cost.hbm_bytes)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D (D = tokens processed per step)."""
    _, active = cfg.param_counts()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.family == "encdec":
            tokens += shape.global_batch * cfg.encoder.n_frames
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        if cfg.family == "encdec":
            tokens += shape.global_batch * cfg.encoder.n_frames
        return 2.0 * active * tokens          # forward only
    # decode: one token per sequence, forward only
    return 2.0 * active * shape.global_batch
