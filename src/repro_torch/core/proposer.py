"""Candidate generation behind a Proposer interface.

Port of ``repro.core.proposer`` for the heuristic and direct proposers: the
move sets are the JAX package's, including the snapping of tiles to
multiples of 128, so the same feedback gives the same proposals; only
``_valid`` differs, checking K1's shared memory per block instead of the
TPU's VMEM.  ``LLMProposer``/``LLMBatcher`` and the population personae
wait (ROADMAP queue 1 item 9): no machine here has an LLM endpoint.

The paper drives candidate generation with OpenAI o3 plus prompt feedback.
This container is offline, so the default ``HeuristicProposer`` emulates the
LLM's role: it consumes the same inputs the paper's prompts carry (kernel
metadata, profiler feedback, PPI hints, error diagnostics) and emits up to N
candidate variants per round, mixing

  * PPI hints (round 1 priority — the paper's inheritance injection),
  * profile-guided moves (memory-bound → bigger reuse tiles / fusion;
    compute-bound → MXU-aligned blocks / bf16 storage),
  * algorithmic recipes from the case's variant space,
  * seeded stochastic exploration (the LLM's sampling temperature).

``DirectProposer`` reproduces the paper's
"Direct LLM Optimization" baseline: one best-practice shot, no feedback
loop.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.core.diagnosis import Diagnosis
from repro_torch.core.kernelcase import KernelCase, Variant
from repro_torch.core.patterns import PatternStore
from repro_torch.core.profiler import SMEM_BYTES, variant_smem_bytes


@dataclass
class RoundState:
    round: int
    baseline_variant: Variant
    baseline_time_s: float
    feedback: Dict[str, float]
    history: List[Dict[str, Any]] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)
    # PPI hint deltas snapshotted by the search loop at the round
    # boundary (one journal read per round, and exactly what the round
    # record journals); None → the proposer queries its own store
    hints: Optional[List[Dict[str, Any]]] = None
    # bottleneck verdict for the incumbent variant (core.diagnosis),
    # computed by the search loop at the round boundary; None → the
    # proposer falls back to raw-counter thresholds
    diagnosis: Optional[Diagnosis] = None


class Proposer:
    name = "abstract"
    # identity of the repair policy evaluate() will apply — part of the
    # EvalCache key, so proposers sharing the default AER-only repair
    # (heuristic, direct) dedup against each other, while a proposer
    # with its own repair (LLM) gets isolated cache entries
    repair_key = "aer"

    def propose(self, case: KernelCase, state: RoundState, n: int
                ) -> List[Variant]:
        raise NotImplementedError

    def repair(self, case: KernelCase, variant: Variant, error: str
               ) -> Optional[Variant]:
        return None   # default: defer to the AER rule set

    def to_spec(self) -> Dict[str, Any]:
        """Wire form: enough for a worker process to rebuild an equivalent
        proposer via ``proposer_from_spec``.  Stateful custom proposers
        (tests, notebooks) don't serialize — they raise here, which the
        subprocess executors surface before spawning anything."""
        raise TypeError(
            f"proposer {type(self).__name__!r} is not wire-safe; "
            f"out-of-process executors need heuristic/direct/llm (or a "
            f"proposer that overrides to_spec)")


def proposer_from_spec(spec: Dict[str, Any], *,
                       patterns: Optional[PatternStore] = None
                       ) -> "Proposer":
    """Rebuild a proposer from its wire form (inverse of ``to_spec``)."""
    kind = spec["kind"]
    if kind == "heuristic":
        return HeuristicProposer(int(spec.get("seed", 0)), patterns,
                                 spec.get("platform", "cpu"),
                                 diagnose=bool(spec.get("diagnose", True)))
    if kind == "direct":
        return DirectProposer()
    if kind == "llm":
        raise NotImplementedError("the LLM proposer is not ported yet "
                                  "(ROADMAP queue 1 item 9)")
    raise ValueError(f"unknown proposer kind {kind!r}")


def _valid(case: KernelCase, v: Variant) -> bool:
    return variant_smem_bytes(v) <= SMEM_BYTES


class HeuristicProposer(Proposer):
    name = "heuristic"

    # restructure flags the latency route flips on, in priority order
    _LATENCY_FLAGS = ("chunked", "one_pass", "precompute_coeffs",
                      "vectorized_exchange", "use_native_sort")

    def __init__(self, seed: int = 0, patterns: Optional[PatternStore] = None,
                 platform: str = "cpu", *, diagnose: bool = True):
        self.seed = seed
        self.rng = random.Random(seed)
        self.patterns = patterns
        self.platform = platform
        # False → ignore RoundState.diagnosis and use the legacy raw
        # thresholds (the undiagnosed baseline benchmarks compare against)
        self.diagnose = diagnose

    def to_spec(self):
        return {"kind": self.name, "seed": self.seed,
                "platform": self.platform, "diagnose": self.diagnose}

    # -- the "LLM" ---------------------------------------------------------
    def propose(self, case, state, n):
        out: List[Variant] = []
        seen = {tuple(sorted(state.baseline_variant.items()))}
        seen.update(tuple(sorted(h["variant"].items()))
                    for h in state.history)

        def push(v: Variant):
            key = tuple(sorted(v.items()))
            if key not in seen and _valid(case, v):
                seen.add(key)
                out.append(v)

        base = dict(state.baseline_variant)
        diag = state.diagnosis if self.diagnose else None

        # 0. the canonical recipe leads round 0 (the LLM's first shot —
        # guarantees the iterative loop dominates the Direct baseline,
        # whose variant this is)
        if state.round == 0:
            recipe0 = dict(base)
            for key, best in (("block_m", 128), ("block_n", 128),
                              ("block_k", 128), ("block", 256),
                              ("compute_dtype", "bf16"),
                              ("fuse_epilogue", True)):
                if key in case.variant_space and best in case.variant_space[key]:
                    recipe0[key] = best
            push(recipe0)

        # 1. Performance Pattern Inheritance hints (paper §3.2)
        hints = state.hints
        if hints is None and self.patterns is not None:
            hints = self.patterns.suggest(
                case, self.platform,
                bottleneck=diag.bottleneck if diag else "")
        for delta in hints or []:
            v = dict(base)
            v.update({k: val for k, val in delta.items()
                      if k in case.variant_space})
            push(v)

        # 2. profile-guided moves: diagnosis-routed when a verdict is on
        # the round state, legacy raw-counter thresholds otherwise
        if diag is not None:
            self._routed_moves(case, base, diag, push)
        else:
            self._legacy_moves(case, state, base, push)

        # 3. canonical recipes (what a strong LLM proposes round 1)
        recipe = dict(base)
        for key, best in (("block_m", 128), ("block_n", 128),
                          ("block_k", 128), ("block", 256),
                          ("compute_dtype", "bf16"), ("fuse_epilogue", True),
                          ("one_pass", True), ("unroll", 2)):
            if key in case.variant_space and best in case.variant_space[key]:
                recipe[key] = best
        push(recipe)

        # 4. stochastic exploration (sampling temperature)
        tries = 0
        while len(out) < n and tries < 50:
            tries += 1
            v = dict(base)
            for key, choices in case.variant_space.items():
                if self.rng.random() < 0.4:
                    v[key] = self.rng.choice(choices)
            push(v)
        return out[:n]

    # -- move sets ---------------------------------------------------------
    def _legacy_moves(self, case, state, base, push):
        """Pre-diagnosis heuristics: one AI ridge threshold plus a
        latency_fraction cutoff, stepping every key a couple of choices
        at a time (kept verbatim as the undiagnosed baseline
        ``table10_diagnosis`` compares against)."""
        ai = state.feedback.get("arithmetic_intensity", 0.0)
        memory_bound = ai < 240.0   # v5e ridge: 197e12/819e9 ≈ 240 flop/byte
        # serialization-bound → restructure the scan first (chunking,
        # unrolling, precomputation, vectorized exchanges)
        if state.feedback.get("latency_fraction", 0.0) > 0.5:
            for key in self._LATENCY_FLAGS:
                if key in case.variant_space and not base.get(key):
                    push(dict(base, **{key: True}))
            for key in ("chunk", "unroll", "block_cols"):
                if key in case.variant_space:
                    for c in case.variant_space[key]:
                        if c != base.get(key):
                            push(dict(base, **{key: c}))
        for key, choices in case.variant_space.items():
            cur = base.get(key)
            if cur not in choices:
                continue
            idx = choices.index(cur)
            if memory_bound:
                # bigger tiles / fusion / lower-precision storage first
                ordered = list(choices[idx + 1:]) + list(choices[:idx])
            else:
                ordered = [c for c in choices if c != cur]
            for cand in ordered[:2]:
                push(dict(base, **{key: cand}))

    def _routed_moves(self, case, base, diag, push):
        """Diagnosis-routed move sets: each bottleneck class gets the
        levers that move its dominant term, combined into one decisive
        recipe first, then single-lever probes, then neighbor steps as
        the tail explorer."""
        route = diag.bottleneck
        if route == "latency":
            self._moves_latency(case, base, push)
        elif route == "memory":
            self._moves_memory(case, base, push)
        elif route in ("compute", "occupancy"):
            self._moves_mxu(case, base, push,
                            shrink=route == "occupancy"
                            and diag.vmem_fraction > 0.9)
        elif route == "collective":
            self._moves_collective(case, base, push)
        # balanced (or anything unrecognized): neighbor probes on every
        # key, both directions — also the tail explorer for every route
        self._neighbor_probes(case, base, push)

    def _aligned_choices(self, case, key):
        return [c for c in case.variant_space.get(key, ())
                if isinstance(c, int) and c % 128 == 0]

    def _combined(self, case, base, push, moves):
        space = case.variant_space
        v = dict(base)
        v.update({k: val for k, val in moves
                  if k in space and val in space[k]})
        if v != base:
            push(v)
        return v

    def _moves_latency(self, case, base, push):
        # serialization: restructure first, then depth levers ON TOP
        # of the restructure (a chunk size means nothing until the
        # kernel is chunked); unroll sweeps largest-first since more
        # unrolling always removes serial steps, chunk sweeps in
        # order since its optimum is interior
        space = case.variant_space
        flags = {k: True for k in self._LATENCY_FLAGS
                 if k in space and not base.get(k)}
        if flags:
            push(dict(base, **flags))
        for key in ("unroll", "chunk", "block_cols"):
            if key in space:
                sweep = list(space[key])
                if key == "unroll":
                    sweep = sweep[::-1]
                for c in sweep:
                    if c != base.get(key):
                        push(dict(base, **flags, **{key: c}))
        for key in flags:                # single-lever fallbacks
            push(dict(base, **{key: True}))

    def _moves_memory(self, case, base, push):
        # cut HBM traffic: lower-precision storage + every
        # traffic-restructure flag + the biggest MXU-aligned reuse
        # tiles, as ONE candidate
        space = case.variant_space
        restructure = [(k, True) for k in
                       ("fuse_epilogue", "one_pass", "rank1_trick",
                        "moment_trick", "chunked", "reshape_butterfly")
                       if k in space and not base.get(k)]
        moves = [("compute_dtype", "bf16")] + restructure
        moves += [(key, max(al)) for key in
                  ("block_m", "block_n", "block_k", "block_q", "block")
                  if (al := self._aligned_choices(case, key))]
        big = self._combined(case, base, push, moves)
        # leave-one-out over the restructure flags: a flag that
        # helps alone can hurt combined (e.g. one_pass vs the
        # rank1 restructure), so probe each removal of the recipe
        for key, _ in restructure:
            v = dict(big)
            v[key] = base.get(key, space[key][0])
            if v != big:
                push(v)
        # single-lever probes of the same moves
        for key, val in moves:
            if key in space and val in space[key] \
                    and base.get(key) != val:
                push(dict(base, **{key: val}))
        # one tile step below the combined recipe in case the
        # traffic model prefers a mid-size tile
        for key in ("block_m", "block_n", "block_k", "block_q", "block"):
            cur = big.get(key)
            if key in space and cur in space[key]:
                i = space[key].index(cur)
                if i > 0:
                    push(dict(big, **{key: space[key][i - 1]}))

    def _moves_mxu(self, case, base, push, *, shrink=False):
        # fill the MXU: snap every tile to 128-aligned (bf16 doubles
        # the peak); occupancy with a VMEM-overflow cause shrinks the
        # working set instead of just aligning it
        space = case.variant_space
        moves = [("compute_dtype", "bf16")]
        for key in ("block_m", "block_n", "block_k", "block_q", "block"):
            al = self._aligned_choices(case, key)
            if al:
                moves.append((key, min(al) if shrink else
                              min(al, key=lambda c: (c != 128, c))))
        self._combined(case, base, push, moves)
        for key, val in moves:
            if key in space and val in space[key] \
                    and base.get(key) != val:
                push(dict(base, **{key: val}))
        if "fuse_epilogue" in space and not base.get("fuse_epilogue"):
            push(dict(base, fuse_epilogue=True))

    def _moves_collective(self, case, base, push):
        # shrink exchanged bytes / overlap: vectorized exchanges,
        # fused single-pass structure, lower-precision payloads
        space = case.variant_space
        self._combined(case, base, push,
                       [("vectorized_exchange", True), ("one_pass", True),
                        ("compute_dtype", "bf16")])
        for key in ("vectorized_exchange", "one_pass", "chunked"):
            if key in space and not base.get(key):
                push(dict(base, **{key: True}))

    def _neighbor_probes(self, case, base, push, keys=None):
        for key, choices in case.variant_space.items():
            if keys is not None and key not in keys:
                continue
            cur = base.get(key)
            if cur not in choices:
                continue
            idx = choices.index(cur)
            for j in (idx + 1, idx - 1):
                if 0 <= j < len(choices):
                    push(dict(base, **{key: choices[j]}))


class DirectProposer(Proposer):
    """Paper's 'Direct LLM Optimization' baseline: single one-shot candidate
    built from best practices, no performance feedback, no iteration."""
    name = "direct"

    def to_spec(self):
        return {"kind": self.name}

    def propose(self, case, state, n):
        v = dict(state.baseline_variant)
        for key, best in (("block_m", 128), ("block_n", 128),
                          ("block_k", 128), ("block", 256),
                          ("compute_dtype", "bf16"),
                          ("fuse_epilogue", True)):
            if key in case.variant_space and best in case.variant_space[key]:
                v[key] = best
        return [v]


def make_proposer(kind: str, *, seed: int = 0,
                  patterns: Optional[PatternStore] = None,
                  platform: str = "cpu") -> Proposer:
    if kind == "heuristic":
        return HeuristicProposer(seed, patterns, platform)
    if kind == "direct":
        return DirectProposer()
    if kind == "llm":
        raise NotImplementedError("the LLM proposer is not ported yet "
                                  "(ROADMAP queue 1 item 9)")
    raise ValueError(kind)
