"""Input Data Generator (paper §3.1.2).

A copy of ``repro.core.datagen`` (pure numpy): the same specs and seed give
bit-identical arrays in both packages, which is what the parity tests feed
to each side.

Generates inputs matching the kernel's input pattern so MEP evaluation is
repeatable and representative, under the data-size constraint
S_data ≤ S_max (eq. 2) which in turn keeps T_overall ≤ T_max.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from repro_torch.core.kernelcase import ArraySpec


@dataclass(frozen=True)
class DataBudget:
    s_max_bytes: int = 256 * 1024 * 1024   # S_max

    def admits(self, specs: Sequence[ArraySpec]) -> bool:
        return sum(s.nbytes for s in specs) <= self.s_max_bytes


def generate(specs: Sequence[ArraySpec], seed: int) -> List[np.ndarray]:
    """Deterministic, pattern-matched inputs."""
    rng = np.random.default_rng(seed)
    out: List[np.ndarray] = []
    for s in specs:
        if s.kind == "normal":
            a = rng.standard_normal(s.shape).astype(s.dtype)
        elif s.kind == "uniform":
            a = rng.uniform(s.minval, s.maxval, s.shape).astype(s.dtype)
        elif s.kind == "positive":
            a = (np.abs(rng.standard_normal(s.shape)) + 0.1).astype(s.dtype)
        elif s.kind == "int":
            a = rng.integers(int(s.minval), int(s.maxval) or 100,
                             s.shape).astype(s.dtype)
        elif s.kind == "tokens":
            a = rng.integers(0, int(s.maxval) or 32000, s.shape).astype(s.dtype)
        elif s.kind == "sorted":
            a = np.sort(rng.standard_normal(s.shape).astype(s.dtype), axis=-1)
        elif s.kind == "symmetric":
            m = rng.standard_normal(s.shape).astype(s.dtype)
            a = (m + np.swapaxes(m, -1, -2)) / 2
        elif s.kind == "spd":
            n = s.shape[-1]
            m = rng.standard_normal(s.shape).astype(s.dtype)
            a = (m @ np.swapaxes(m, -1, -2) / np.sqrt(n)
                 + np.eye(n) * n ** 0.5).astype(s.dtype)
        else:
            raise ValueError(f"unknown generator kind {s.kind!r}")
        out.append(a)
    return out


def data_bytes(specs: Sequence[ArraySpec]) -> int:
    return sum(s.nbytes for s in specs)
