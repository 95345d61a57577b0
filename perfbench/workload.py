"""The one generator of traffic: it reads a mix's parameters (a file of
``traffic/``) and a run's seed.

Lengths are drawn stratified: a block of ``block`` (prompt, output) pairs
holds the distribution's quantiles at (i + 0.5) / block, paired by a fixed
permutation (the mix's ``pairing_seed``).  Each client sends block after
block, each in an order fixed by the mix; the seed deals these sequences
to the clients, so every seed sends the same sizes at the same moments of
a closed loop, in another order among its clients.  Prompt tokens are
uniform over the vocabulary, drawn from the seed.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np


def quantiles(spec: Dict, n: int) -> List[int]:
    """``n`` stratified whole lengths of the distribution ``spec``:
    ``lognormal`` (``median``, ``sigma``) or ``uniform``, clipped to
    [``min``, ``max``]."""
    lo, hi = spec["min"], spec["max"]
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            x = math.exp(math.log(spec["median"])
                         + spec["sigma"] * NormalDist().inv_cdf(u))
        elif spec["dist"] == "uniform":
            x = lo + (hi - lo) * u
        else:
            raise ValueError(f"unknown distribution {spec['dist']!r}")
        out.append(int(round(min(max(x, lo), hi))))
    return out


def _rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *tags]))


class Requests:
    """The endless requests of a serving mix's clients under one seed.

    Client c sends the block's sizes in orders fixed by the mix (one per
    block), so in a closed loop, where each completion sends its client's
    next request, the steps' work does not depend on the seed; the seed
    deals these sequences to the clients and draws the prompt tokens."""

    def __init__(self, mix: Dict, vocab: int, seed: int):
        n = mix["block"]
        prompts = quantiles(mix["prompt"], n)
        outputs = quantiles(mix["output"], n)
        pair = np.random.default_rng(mix["pairing_seed"]).permutation(n)
        self.sizes: List[Tuple[int, int]] = [(prompts[i], outputs[pair[i]])
                                             for i in range(n)]
        self.mix_seed, self.vocab, self.seed = mix["pairing_seed"], vocab, seed
        self.deal = _rng(seed, 1).permutation(mix["clients"])
        self.sent = [0] * mix["clients"]
        self._orders: Dict[Tuple[int, int], np.ndarray] = {}

    def next(self, client: int) -> Tuple[np.ndarray, int]:
        """(prompt tokens, tokens to generate) of ``client``'s next
        request."""
        k = self.sent[client]
        self.sent[client] += 1
        seq = int(self.deal[client])
        block, j = divmod(k, len(self.sizes))
        if (seq, block) not in self._orders:
            self._orders[(seq, block)] = _rng(
                self.mix_seed, seq, block).permutation(len(self.sizes))
        plen, out = self.sizes[self._orders[(seq, block)][j]]
        prompt = _rng(self.seed, 2, client, k).integers(0, self.vocab, plen)
        return prompt.astype(np.int64), out
