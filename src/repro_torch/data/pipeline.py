"""Deterministic synthetic data pipeline.

Port of ``repro.data.pipeline``.  Every row of a step's global batch is
drawn from numpy generators keyed by (seed, step, row), so a restart or a
replay of a step reproduces its batch bit for bit, and the stream equals
the JAX package's.  ``make_global_batch`` puts the batch on a device as
int32 tensors; with a ``sharding`` (a ``sharding.Layout`` of the [B, S]
batch) each rank draws only its rows, and the ranks' slices joined are
the unsharded batch.  Recorded (``repro_torch.tracing``), a call is a
``data.draw`` span and a ``data.copy`` span, both the host's: the copy
from pageable memory waits for the stream, then stages the rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


@dataclass
class SyntheticLMData:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0

    def _row(self, step: int, row: int) -> np.ndarray:
        # mostly-periodic stream: a motif drawn from a small persistent bank
        # (stable across steps, so even a reduced model demonstrably learns
        # — loss drops well below ln(V)) plus per-step noise
        v = self.cfg.vocab_size
        bank_rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 7919, (step + row) % 16]))
        motif = bank_rng.integers(0, v, 8)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, row]))
        reps = int(np.ceil((self.seq_len + 1) / len(motif)))
        stream = np.tile(motif, reps)[: self.seq_len + 1]
        noise = rng.integers(0, v, self.seq_len + 1)
        return np.where(rng.random(self.seq_len + 1) < 0.9, stream, noise)

    def host_batch(self, step: int, lo: int, hi: int) -> Dict[str, np.ndarray]:
        rows = np.stack([self._row(step, r) for r in range(lo, hi)])
        return {"tokens": rows[:, :-1].astype(np.int32),
                "targets": rows[:, 1:].astype(np.int32)}

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        return self.host_batch(step, 0, self.global_batch)


def make_global_batch(data: SyntheticLMData, step: int, device="cuda",
                      sharding=None) -> Dict[str, torch.Tensor]:
    """The global batch of ``step`` as int32 tensors on ``device``; with
    ``sharding`` (the ``Layout`` of a [B, S] batch) this rank's piece of
    it, drawing only its own rows."""
    dev = resolve_device(device)
    with tracing.span("data.draw") as span:
        if sharding is None:
            batch = data.batch(step)
        else:
            (lo, hi), (s0, s1) = sharding.bounds((data.global_batch,
                                                  data.seq_len))
            batch = {k: a[:, s0:s1]
                     for k, a in data.host_batch(step, lo, hi).items()}
        span.set(rows=len(batch["tokens"]))
    with tracing.span("data.copy") as span:
        if tracing.on():
            span.set(bytes=sum(a.nbytes for a in batch.values()))
        return {name: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for name, a in batch.items()}
