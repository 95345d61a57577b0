"""The synthetic token stream a training cell feeds, drawn again on the
benchmark's side.

A copy of the rule of the program's ``SyntheticLMData``: each row is a
motif of 8 tokens from a bank keyed by (seed, (step + row) mod 16), tiled
over the row, with 10% of its tokens replaced by uniform noise keyed by
(seed, step, row).  So every row of every step differs, and the run's
seed sets them all.  The train driver compares the program's batches with
these exactly.
"""
from __future__ import annotations

import numpy as np


def row(vocab: int, seq_len: int, seed: int, step: int, r: int) -> np.ndarray:
    bank = np.random.default_rng(
        np.random.SeedSequence([seed, 7919, (step + r) % 16]))
    motif = bank.integers(0, vocab, 8)
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, r]))
    reps = -(-(seq_len + 1) // len(motif))
    stream = np.tile(motif, reps)[:seq_len + 1]
    noise = rng.integers(0, vocab, seq_len + 1)
    return np.where(rng.random(seq_len + 1) < 0.9, stream, noise)


def batch(vocab: int, seq_len: int, rows: int, seed: int, step: int):
    """(tokens, targets), each [rows, seq_len] int64."""
    x = np.stack([row(vocab, seq_len, seed, step, r) for r in range(rows)])
    return x[:, :-1].astype(np.int64), x[:, 1:].astype(np.int64)
