"""The traffic generator: seeded, repeatable, the same sizes for every
seed."""
import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

import workload  # noqa: E402

MIXES = {p.stem: json.loads(p.read_text())
         for p in (HERE / "traffic").glob("*.json")}
SERVE_MIXES = {k: v for k, v in MIXES.items() if v["kind"] == "closed_loop"}


def _take(mix, seed, n, vocab=1000, client=0):
    gen = workload.Requests(mix, vocab, seed)
    return [gen.next(client) for _ in range(n)]


def _sequences(mix, seed, n):
    """Each client's first ``n`` sizes."""
    gen = workload.Requests(mix, 1000, seed)
    return [[(len(p), m) for p, m in (gen.next(c) for _ in range(n))]
            for c in range(mix["clients"])]


def test_same_seed_repeats_exactly():
    for mix in SERVE_MIXES.values():
        a = _take(mix, 2 ** 31 + 7, 150)
        b = _take(mix, 2 ** 31 + 7, 150)
        assert all(np.array_equal(p, q) and m == n
                   for (p, m), (q, n) in zip(a, b))


def test_every_seed_deals_the_same_sequences_to_its_clients():
    for mix in SERVE_MIXES.values():
        a = _sequences(mix, 1, 70)
        b = _sequences(mix, 2, 70)
        assert sorted(a) == sorted(b) and a != b
        k = mix["block"]
        for seq in a:          # each block holds the block's sizes
            assert Counter(seq[:k]) == Counter(_sequences(mix, 3, k)[0])


def test_lengths_stay_in_their_ranges_and_fit_the_cache():
    for mix in SERVE_MIXES.values():
        for p, m in _take(mix, 5, mix["block"]):
            assert mix["prompt"]["min"] <= len(p) <= mix["prompt"]["max"]
            assert mix["output"]["min"] <= m <= mix["output"]["max"]
            assert len(p) + m <= mix["max_len"]


def test_lognormal_quantiles_hold_the_median():
    spec = {"dist": "lognormal", "median": 200, "sigma": 0.8, "min": 32,
            "max": 768}
    q = workload.quantiles(spec, 64)
    assert q == sorted(q)
    assert 190 <= np.median(q) <= 210
    assert min(q) >= 32 and max(q) <= 768


def test_uniform_quantiles_are_even():
    q = workload.quantiles({"dist": "uniform", "min": 0, "max": 100}, 4)
    assert q == [12, 38, 62, 88]


def test_tokens_lie_in_the_vocabulary():
    for mix in SERVE_MIXES.values():
        for p, _ in _take(mix, 9, 20, vocab=37):
            assert p.min() >= 0 and p.max() < 37
