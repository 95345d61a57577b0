"""Candidate generation behind a Proposer interface.

Port of ``repro.core.proposer``: the move sets are the JAX package's,
including the snapping of tiles to multiples of 128, so the same feedback
gives the same proposals; ``_valid`` checks K1's shared memory per block
instead of the TPU's VMEM.  The LLM prompts name the H100 (tensor-core
tile fill, shared memory a block) where the reference names the TPU (MXU
alignment, VMEM fit); the persona markers and the JSON contract are the
reference's.

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

``LLMProposer`` is the real client: point REPRO_LLM_ENDPOINT at an
OpenAI-compatible server and it sends the kernel source + feedback and
parses returned variants.  ``DirectProposer`` reproduces the paper's
"Direct LLM Optimization" baseline: one best-practice shot, no feedback
loop.
"""
from __future__ import annotations

import json
import os
import random
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.diagnosis import Diagnosis
from repro_torch.core.kernelcase import KernelCase, Variant
from repro_torch.core.patterns import PatternStore
from repro_torch.core.profiler import SMEM_BYTES, variant_smem_bytes


class ProposalError(RuntimeError):
    """An LLM reply that cannot become candidates: refusal-shaped text
    with no JSON span, unparseable JSON, or values outside the case's
    variant space.  Raised instead of silently evaluating garbage; the
    ``ProposalError: ...`` string is stable for AER classification."""


# expert personae for population search (core.population): each clones
# the base proposer into a specialist whose move set / prompt is
# restricted to one optimization dimension
PERSONAE = ("tiling", "memory", "fusion", "sync")

# variant-space keys each persona's stochastic tail may perturb; keys
# absent from a case's space are ignored
_PERSONA_KEYS = {
    "tiling": ("block_m", "block_n", "block_k", "block_q", "block",
               "block_cols", "chunk", "unroll"),
    "memory": ("compute_dtype", "fuse_epilogue", "one_pass", "chunked",
               "rank1_trick", "moment_trick", "block_m", "block_n",
               "block_k", "block"),
    "fusion": ("fuse_epilogue", "one_pass", "rank1_trick", "moment_trick",
               "reshape_butterfly", "precompute_coeffs"),
    "sync": ("chunked", "one_pass", "precompute_coeffs",
             "vectorized_exchange", "use_native_sort", "unroll", "chunk",
             "block_cols"),
}


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

    def with_persona(self, persona: str, idx: int = 0) -> Optional["Proposer"]:
        """Clone this proposer as the given expert persona (population
        search).  ``idx`` is the persona's position in the wave, used for
        deterministic seed derivation.  None → this proposer kind has no
        persona support and the caller falls back to the greedy loop."""
        return None


def persona_proposers(base: "Proposer", personae) -> Optional[List["Proposer"]]:
    """One persona-parameterized clone of ``base`` per expert, or None
    when the proposer kind supports no personae (e.g. DirectProposer) —
    population search then degrades to the greedy loop."""
    out: List[Proposer] = []
    for i, p in enumerate(personae):
        clone = base.with_persona(p, i)
        if clone is None:
            return None
        out.append(clone)
    return out or None


def proposer_from_spec(spec: Dict[str, Any], *,
                       patterns: Optional[PatternStore] = None
                       ) -> "Proposer":
    """Rebuild a proposer from its wire form (inverse of ``to_spec``)."""
    kind = spec["kind"]
    if kind == "heuristic":
        return HeuristicProposer(int(spec.get("seed", 0)), patterns,
                                 spec.get("platform", "cpu"),
                                 diagnose=bool(spec.get("diagnose", True)),
                                 persona=spec.get("persona", ""))
    if kind == "direct":
        return DirectProposer()
    if kind == "llm":
        return LLMProposer(patterns, spec.get("platform", "cpu"),
                           persona=spec.get("persona", ""))
    raise ValueError(f"unknown proposer kind {kind!r}")


def _valid(case: KernelCase, v: Variant) -> bool:
    return variant_smem_bytes(v) <= SMEM_BYTES


def _json_span(text: str, open_ch: str, close_ch: str, *, what: str):
    """Parse the outermost ``open_ch…close_ch`` span of an LLM reply.
    A refusal-shaped reply (no span at all) or malformed JSON raises
    ``ProposalError`` instead of slicing with find() == -1 — which used
    to silently parse garbage like ``text[-1:end]``."""
    start, end = text.find(open_ch), text.rfind(close_ch)
    if start < 0 or end <= start:
        raise ProposalError(
            f"no JSON {what} in LLM reply (refusal-shaped?): "
            f"{text[:160]!r}")
    try:
        return json.loads(text[start:end + 1])
    except ValueError as e:
        raise ProposalError(
            f"malformed JSON {what} in LLM reply: {e}") from None


def _validated(case: KernelCase, cand: Dict[str, Any]) -> Dict[str, Any]:
    """Keep the candidate's in-space keys; a known key with a value
    outside its choices raises (the model hallucinated a knob setting —
    evaluating it would fail far from the cause)."""
    out: Dict[str, Any] = {}
    for k, val in cand.items():
        if k not in case.variant_space:
            continue        # unknown keys are dropped, as before
        choices = case.variant_space[k]
        if val not in choices:
            raise ProposalError(
                f"value {val!r} for {k!r} is outside "
                f"{case.name}'s variant space choices {list(choices)}")
        out[k] = val
    return out


class HeuristicProposer(Proposer):
    name = "heuristic"

    # restructure flags the latency route flips on, in priority order
    _LATENCY_FLAGS = ("chunked", "one_pass", "precompute_coeffs",
                      "vectorized_exchange", "use_native_sort")

    def __init__(self, seed: int = 0, patterns: Optional[PatternStore] = None,
                 platform: str = "cpu", *, diagnose: bool = True,
                 persona: str = ""):
        self.seed = seed
        self.rng = random.Random(seed)
        self.patterns = patterns
        self.platform = platform
        # False → ignore RoundState.diagnosis and use the legacy raw
        # thresholds (the undiagnosed baseline benchmarks compare against)
        self.diagnose = diagnose
        # non-empty → expert mode: propose() emits only this persona's
        # move set (population search fans a wave across K personae)
        self.persona = persona

    def to_spec(self):
        return {"kind": self.name, "seed": self.seed,
                "platform": self.platform, "diagnose": self.diagnose,
                "persona": self.persona}

    def with_persona(self, persona, idx=0):
        # arithmetic seed offset, NOT hash(): PYTHONHASHSEED varies across
        # worker processes and would break executor conformance
        return HeuristicProposer(self.seed + 7919 * (idx + 1), self.patterns,
                                 self.platform, diagnose=self.diagnose,
                                 persona=persona)

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

        # expert mode (population search): only this persona's move set
        # plus a persona-restricted stochastic tail — the engine handles
        # seeds/migrants and cross-persona dedup
        if self.persona:
            for delta in state.hints or []:
                v = dict(base)
                v.update({k: val for k, val in delta.items()
                          if k in case.variant_space})
                push(v)
            self._persona_moves(case, base, diag, push)
            keys = [k for k in _PERSONA_KEYS.get(self.persona, ())
                    if k in case.variant_space] \
                or list(case.variant_space)
            tries = 0
            while len(out) < n and tries < 50:
                tries += 1
                v = dict(base)
                for key in keys:
                    if self.rng.random() < 0.5:
                        v[key] = self.rng.choice(case.variant_space[key])
                push(v)
            return out[:n]

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
        the tail explorer.  The per-route bodies double as the persona
        move sets for population search (``_persona_moves``)."""
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

    def _moves_fusion(self, case, base, push):
        # restructure levers only: all-on recipe, leave-one-out probes
        # (interacting flags — one_pass vs rank1_trick), then singles
        space = case.variant_space
        flags = [k for k in ("fuse_epilogue", "one_pass", "rank1_trick",
                             "moment_trick", "reshape_butterfly",
                             "precompute_coeffs")
                 if k in space and not base.get(k)]
        if not flags:
            return
        push(dict(base, **{k: True for k in flags}))
        if len(flags) > 1:
            for drop in flags:
                push(dict(base, **{k: True for k in flags if k != drop}))
        for k in flags:
            push(dict(base, **{k: True}))

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

    def _persona_moves(self, case, base, diag, push):
        """One expert's move set (population search).  Reuses the routed
        bodies: the persona decides WHICH levers, the diagnosis only
        refines HOW (e.g. occupancy shrinks tiles instead of growing)."""
        p = self.persona
        if p == "tiling":
            self._moves_mxu(case, base, push,
                            shrink=diag is not None
                            and diag.bottleneck == "occupancy"
                            and diag.vmem_fraction > 0.9)
            # exhaustive largest-first tile sweeps beyond the 128 snap
            space = case.variant_space
            for key in ("block_m", "block_n", "block_k", "block_q",
                        "block", "block_cols", "chunk"):
                if key in space:
                    for c in list(space[key])[::-1]:
                        if c != base.get(key):
                            push(dict(base, **{key: c}))
        elif p == "memory":
            self._moves_memory(case, base, push)
        elif p == "fusion":
            self._moves_fusion(case, base, push)
        elif p == "sync":
            self._moves_latency(case, base, push)
            self._moves_collective(case, base, push)
        self._neighbor_probes(case, base, push,
                              keys=_PERSONA_KEYS.get(p))


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


class OfflineError(RuntimeError):
    pass


def chat_completion(prompt: str, *, endpoint: Optional[str], model: str,
                    api_key: str = "", timeout_s: float = 60.0) -> str:
    """One OpenAI-compatible /chat/completions call (the only transport
    both ``LLMProposer`` and ``LLMBatcher`` use)."""
    if not endpoint:
        raise OfflineError(
            "LLMProposer needs REPRO_LLM_ENDPOINT; offline runs use "
            "HeuristicProposer")
    body = json.dumps({
        "model": model,
        "messages": [{"role": "user", "content": prompt}],
    }).encode()
    req = urllib.request.Request(
        endpoint, data=body,
        headers={"Content-Type": "application/json",
                 "Authorization": f"Bearer {api_key}"})
    with urllib.request.urlopen(req, timeout=timeout_s) as r:
        data = json.load(r)
    return data["choices"][0]["message"]["content"]


class LLMBatcher:
    """Coalesces round prompts from concurrent campaign cases (or the
    personae of one population wave) into one endpoint call.

    Each case's proposer calls ``submit(prompt)`` from its own worker
    thread; the batcher holds the prompt until either every *active*
    participant of the current round has one pending (or ``max_batch`` is
    reached), or ``linger_s`` elapses — then ONE request carrying all
    pending prompts as tagged sections goes to the endpoint, and the
    per-tag answers are handed back to the blocked submitters.  Campaign
    workers ``register()`` on job start and ``unregister()`` on job end,
    so the dispatch threshold tracks how many cases can still contribute
    a prompt — the last live case never waits out the linger timer.

    In-process executors share one batcher across their worker threads;
    subprocess and remote workers each coalesce within their own process
    only.
    """

    HEADER = ("You are optimizing {n} independent H100 kernels. Each "
              "section below is one kernel's request, tagged `### id`. "
              "Answer ALL of them in ONE strict-JSON object mapping each "
              "id to that section's answer (for proposal sections: the "
              "JSON list of variant dicts).\n")

    def __init__(self, transport: Optional[Callable[[str], str]] = None, *,
                 max_batch: int = 8, linger_s: float = 0.05,
                 timeout_s: float = 60.0):
        self._transport = transport or (lambda prompt: chat_completion(
            prompt, endpoint=os.environ.get("REPRO_LLM_ENDPOINT"),
            model=os.environ.get("REPRO_LLM_MODEL", "o3"),
            api_key=os.environ.get("REPRO_LLM_API_KEY", ""),
            timeout_s=timeout_s))
        self.max_batch = max(1, max_batch)
        self.linger_s = linger_s
        self.calls = 0               # endpoint calls actually issued
        self.coalesced = 0           # prompts answered by those calls
        self._cv = threading.Condition()
        self._active = 0             # registered participants still running
        self._seq = 0
        self._pending: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------
    def register(self) -> None:
        with self._cv:
            self._active += 1

    def unregister(self) -> None:
        with self._cv:
            self._active = max(0, self._active - 1)
            self._cv.notify_all()

    # ------------------------------------------------------------------
    def _target(self) -> int:
        return min(max(self._active, 1), self.max_batch)

    def submit(self, prompt: str) -> str:
        """Block until this prompt's answer arrives (with the batch it
        was coalesced into); returns the answer text for this prompt."""
        with self._cv:
            item = {"id": f"k{self._seq}", "prompt": prompt,
                    "done": False, "text": None, "err": None}
            self._seq += 1
            self._pending.append(item)
            self._cv.notify_all()
            deadline = time.monotonic() + self.linger_s
            while not item["done"]:
                leader = self._pending and self._pending[0] is item
                if leader and (len(self._pending) >= self._target()
                               or time.monotonic() >= deadline):
                    batch = self._pending
                    self._pending = []
                    self._dispatch(batch)      # releases _cv during I/O
                    self._cv.notify_all()
                    continue
                timeout = max(0.0, deadline - time.monotonic()) \
                    if leader else None
                self._cv.wait(timeout=timeout if leader else 0.25)
            if item["err"] is not None:
                raise item["err"]
            return item["text"]

    def _dispatch(self, batch: List[Dict[str, Any]]) -> None:
        # caller holds _cv; drop it across the network round-trip
        self._cv.release()
        try:
            try:
                if len(batch) == 1:
                    answers = {batch[0]["id"]: self._transport(
                        batch[0]["prompt"])}
                else:
                    prompt = self.HEADER.format(n=len(batch)) + "".join(
                        f"\n### {it['id']}\n{it['prompt']}\n"
                        for it in batch)
                    text = self._transport(prompt)
                    obj = json.loads(text[text.find("{"):
                                          text.rfind("}") + 1])
                    answers = {it["id"]: json.dumps(obj[it["id"]])
                               for it in batch}
                self.calls += 1
                self.coalesced += len(batch)
                err = None
            except Exception as e:  # noqa: BLE001 — fail the whole batch
                answers, err = {}, e
        finally:
            self._cv.acquire()
        for it in batch:
            it["text"] = answers.get(it["id"])
            it["err"] = err if it["text"] is None else None
            it["done"] = True


class LLMProposer(Proposer):
    """Model-in-the-loop candidate generation (the paper's actual setup).
    Requires REPRO_LLM_ENDPOINT (OpenAI-compatible /chat/completions) and
    optionally REPRO_LLM_MODEL / REPRO_LLM_API_KEY."""
    name = "llm"
    repair_key = "llm"           # model-dependent repairs: isolate in cache

    PROMPT = """You are optimizing an NVIDIA H100 kernel. Case: {name} (family
{family}). Current variant: {variant}. Variant space: {space}.
Profiler feedback: {feedback}. Diagnosis: {diagnosis}.
Prior effective patterns: {hints}.
Recent errors: {errors}.
Reply with a JSON list of up to {n} variant dicts drawn from the space."""

    # persona preambles for population search: the same round prompt,
    # but the model is told which expert it is and which levers are its
    PERSONA_PROMPTS = {
        "tiling": ("As the TILING expert, restrict yourself to block/"
                   "tile/grid-shape knobs (block_m/n/k/q, block, chunk, "
                   "unroll): tensor-core tile fill and shared memory a "
                   "block.\n"),
        "memory": ("As the MEMORY-LAYOUT expert, cut HBM traffic: "
                   "storage dtype, reuse-tile sizes, and traffic-"
                   "restructuring flags.\n"),
        "fusion": ("As the FUSION/RESTRUCTURE expert, fuse epilogues and "
                   "restructure passes (one_pass, rank1/moment tricks, "
                   "precomputation).\n"),
        "sync": ("As the SYNCHRONIZATION/LATENCY expert, remove serial "
                 "steps: chunked scans, unrolling, vectorized exchanges, "
                 "native sorts.\n"),
    }

    def __init__(self, patterns: Optional[PatternStore] = None,
                 platform: str = "cpu", timeout_s: float = 60.0,
                 batcher: Optional[LLMBatcher] = None, persona: str = ""):
        self.endpoint = os.environ.get("REPRO_LLM_ENDPOINT")
        self.model = os.environ.get("REPRO_LLM_MODEL", "o3")
        self.api_key = os.environ.get("REPRO_LLM_API_KEY", "")
        self.patterns = patterns
        self.platform = platform
        self.timeout_s = timeout_s
        # attached by the campaign executor so concurrent cases' round
        # prompts coalesce into one endpoint call
        self.batcher = batcher
        self.persona = persona

    def to_spec(self):
        return {"kind": self.name, "platform": self.platform,
                "persona": self.persona}

    def with_persona(self, persona, idx=0):
        # clones share self.batcher, so one generation wave of K persona
        # prompts coalesces into a single endpoint call
        return LLMProposer(self.patterns, self.platform, self.timeout_s,
                           batcher=self.batcher, persona=persona)

    def _chat(self, prompt: str) -> str:
        return chat_completion(prompt, endpoint=self.endpoint,
                               model=self.model, api_key=self.api_key,
                               timeout_s=self.timeout_s)

    def _round_text(self, prompt: str) -> str:
        if self.batcher is not None:
            return self.batcher.submit(prompt)
        return self._chat(prompt)

    def propose(self, case, state, n):
        diag = state.diagnosis
        hints = state.hints
        if hints is None:
            hints = (self.patterns.suggest(
                case, self.platform,
                bottleneck=diag.bottleneck if diag else "")
                if self.patterns else [])
        prompt = self.PERSONA_PROMPTS.get(self.persona, "") + \
            self.PROMPT.format(
                name=case.name, family=case.family,
                variant=state.baseline_variant, space=case.variant_space,
                feedback=state.feedback,
                diagnosis=diag.summary() if diag else "n/a",
                hints=hints, errors=state.errors[-3:], n=n)
        text = self._round_text(prompt)
        cands = _json_span(text, "[", "]", what="variant list")
        if not isinstance(cands, list):
            raise ProposalError(
                f"LLM reply parsed to {type(cands).__name__}, "
                f"expected a list of variant dicts")
        out = []
        for c in cands[:n]:
            if not isinstance(c, dict):
                raise ProposalError(
                    f"LLM candidate is {type(c).__name__}, expected a "
                    f"variant dict")
            v = dict(state.baseline_variant)
            v.update(_validated(case, c))
            out.append(v)
        return out

    def repair(self, case, variant, error):
        prompt = (f"Kernel {case.name} variant {variant} failed with:\n"
                  f"{error[:800]}\nReply with a single corrected variant "
                  f"dict from space {case.variant_space}.")
        try:
            text = self._chat(prompt)
            fix = _json_span(text, "{", "}", what="variant dict")
            v = dict(variant)
            v.update(_validated(case, fix))
            return v
        except OfflineError:
            raise
        except Exception:
            # ProposalError included: a garbage or out-of-space repair
            # reply defers to the deterministic AER rule set
            return None


def make_proposer(kind: str, *, seed: int = 0,
                  patterns: Optional[PatternStore] = None,
                  platform: str = "cpu") -> Proposer:
    if kind == "heuristic":
        return HeuristicProposer(seed, patterns, platform)
    if kind == "direct":
        return DirectProposer()
    if kind == "llm":
        return LLMProposer(patterns, platform)
    raise ValueError(kind)
