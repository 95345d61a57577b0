"""Population search: multi-expert proposer personae with tournament
racing and island migration.

Port of ``repro.core.population``, record for record: the same personae,
tournament draws, insertion order, migration events and journal fields, so
a ``patterns.jsonl`` or round journal written by either package reads in
the other.  On a measured card platform (``h100``) every evaluation and
every timed window stays on the calling thread; only LLM personae's
prompts run in threads, and those threads block on the batcher alone.

The paper's §3.2 loop advances ONE lineage per kernel: each round the
incumbent proposes N children and the argmin replaces it.  That leaves
the adaptive measurement engine underused — incumbent racing
makes a losing candidate nearly free to kill (it is retired at r_min
reps), yet the greedy loop only ever races a handful of variants.  This
module runs an evolutionary population per case instead, following the
Kernel Foundry / OpenEvolve shape (PAPERS.md, SNIPPETS.md §2):

* a ``Population`` of up to ``size`` individuals (variant + fitness +
  persona lineage), seeded from the baseline, the PPI hints, and the
  diagnosis verdict;
* each generation fans proposals out to K expert **personae** — tiling,
  memory-layout, fusion/restructure, synchronization/latency — cloned
  from the job's proposer (``proposer.persona_proposers``).  Persona
  order is diagnosis-matched (the expert for the diagnosed bottleneck
  proposes first, against the champion); LLM personae submit their
  prompts concurrently so the shared ``LLMBatcher`` coalesces the wave
  into one endpoint call;
* **tournament-by-racing** selection: every challenger is timed with
  ``incumbent_s`` set to a tournament-sampled opponent, so the
  measurement engine retires losers at r_min reps (``raced_out`` →
  a recorded kill, never an argmin entry).  Survivors that beat their
  opponent join the population immediately (steady-state insertion,
  truncated back to ``size``);
* **island migration**: each generation imports the top cross-case
  deltas from the shared ``PatternStore`` journal
  (``suggest_migrants`` — bottleneck-tagged, acceptance-ranked, never
  the case's own history) and exports its improvements right back
  (``patterns.record`` at generation end), so concurrent cases evolve
  as islands exchanging winners mid-campaign.

Determinism: all stochastic choices flow from ``random.Random`` seeded
with the (case, job seed) string — never ``hash()``, never wall clock —
so runs of the same campaign produce identical winner records on
analytic platforms.
"""
from __future__ import annotations

import os
import random
import threading
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.diagnosis import Diagnosis, diagnose_feedback
from repro_torch.core.kernelcase import KernelCase, Variant
from repro_torch.core.optimizer import OptConfig, OptResult, RoundLog
from repro_torch.core.patterns import Pattern, PatternStore
from repro_torch.core.proposer import (LLMBatcher, LLMProposer, Proposer,
                                 PERSONAE, RoundState)

# pseudo-personae for non-expert wave entries: PPI seeds (generation 0)
# and cross-case migrants — journaled alongside the expert personae
SEED_PERSONA = "seed"
MIGRANT_PERSONA = "migrant"

# which expert leads the wave for each diagnosed bottleneck; personae
# not listed keep their configured order after the matched ones
_BOTTLENECK_ORDER = {
    "memory": ("memory", "tiling", "fusion", "sync"),
    "compute": ("tiling", "memory", "fusion", "sync"),
    "occupancy": ("tiling", "memory", "fusion", "sync"),
    "latency": ("sync", "fusion", "tiling", "memory"),
    "collective": ("sync", "memory", "tiling", "fusion"),
}


@dataclass(frozen=True)
class PopulationConfig:
    """Knobs for the per-case evolutionary search (campaign-level via
    ``Campaign(population=...)``, per-job via ``OptConfig.population``)."""
    size: int = 4             # individuals kept (truncation selection)
    generations: int = 6      # generation cap (the eq. 5 D analogue)
    per_persona: int = 2      # candidates each expert proposes per wave
    personae: Tuple[str, ...] = PERSONAE
    tournament: int = 2       # opponents sampled per challenger (t-way)
    migrate: bool = True      # island migration through the PatternStore
    max_migrants: int = 2     # cross-case deltas imported per generation
    patience: int = 2         # non-improving generations before stopping

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["personae"] = list(self.personae)
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "PopulationConfig":
        d = dict(d)
        d["personae"] = tuple(d.get("personae") or PERSONAE)
        return PopulationConfig(**d)


@dataclass
class Individual:
    """One population member: a variant with its measured fitness and
    provenance (which persona bred it, in which generation)."""
    variant: Variant
    fitness: float
    persona: str = ""
    born: int = -1            # generation it joined (-1 → baseline)
    ci_rel: float = 0.0       # rel. CI of the timing behind fitness
    lineage: Tuple[str, ...] = ()   # persona chain from the baseline


def _vkey(v: Variant) -> Tuple:
    return tuple(sorted((k, repr(val)) for k, val in v.items()))


class Population:
    """The per-case evolutionary engine ``workers.run_case_job`` hands
    control to when a ``PopulationConfig`` is active and the job's
    proposer supports personae.  One instance per (case, job)."""

    def __init__(self, case: KernelCase, platform, mep, evaluator,
                 cfg: OptConfig, pcfg: PopulationConfig,
                 proposers: List[Proposer], *,
                 patterns: Optional[PatternStore] = None,
                 db=None, campaign_id: str = "", job_name: str = "",
                 seed: int = 0):
        self.case = case
        self.platform = platform
        self.mep = mep
        self.evaluator = evaluator
        self.cfg = cfg
        self.pcfg = pcfg
        self.proposers = proposers        # persona clones, config order
        self.patterns = patterns
        self.db = db
        self.campaign_id = campaign_id
        self.job_name = job_name or case.name
        # str seeding is PYTHONHASHSEED-independent (sha512 path), so
        # worker processes draw identical tournament samples
        self.rng = random.Random(f"{case.name}/{seed}/population")
        self._feedback_memo: Dict[Tuple, Dict[str, float]] = {}

    # ------------------------------------------------------------------
    def _feedback(self, variant: Variant) -> Dict[str, float]:
        key = _vkey(variant)
        if key not in self._feedback_memo:
            self._feedback_memo[key] = self.platform.profile_feedback(
                self.case, variant, self.mep.scale)
        return self._feedback_memo[key]

    def _ordered(self, bottleneck: str) -> List[Proposer]:
        prio = {p: i for i, p in enumerate(
            _BOTTLENECK_ORDER.get(bottleneck, ()))}
        return sorted(self.proposers,
                      key=lambda pr: prio.get(
                          getattr(pr, "persona", ""), len(prio)))

    def _opponent(self, pop: List[Individual]) -> Individual:
        """t-way tournament: sample ``tournament`` members, the fittest
        is the racing opponent.  Sampling over a sorted population means
        the min index is the fittest — no timing reads, no wall clock."""
        t = max(1, min(self.pcfg.tournament, len(pop)))
        idx = self.rng.sample(range(len(pop)), t)
        return pop[min(idx)]

    def _insert(self, pop: List[Individual], ind: Individual) -> None:
        pop.append(ind)
        pop.sort(key=lambda i: (i.fitness, _vkey(i.variant)))
        del pop[max(1, self.pcfg.size):]

    def _applied(self, base: Variant, delta: Dict[str, Any]) -> Variant:
        v = dict(base)
        v.update({k: val for k, val in delta.items()
                  if k in self.case.variant_space
                  and val in self.case.variant_space[k]})
        return v

    # ------------------------------------------------------------------
    def _propose_wave(self, g: int, ordered: List[Proposer],
                      pop: List[Individual], diag: Diagnosis,
                      history: List[Dict[str, Any]], errors: List[str]
                      ) -> List[Tuple[str, Individual, List[Variant],
                                      Optional[Exception]]]:
        """One generation's expert proposals: persona i mutates the
        i-th fittest individual (wrapping), so a grown population
        spreads the wave across lineages instead of piling onto the
        champion.  LLM personae run concurrently so their prompts
        coalesce through the shared ``LLMBatcher`` into one endpoint
        call; a persona whose reply fails (``ProposalError``) is
        isolated — its slot reports the error, the wave continues."""
        parents = [pop[i % len(pop)] for i in range(len(ordered))]
        out: List = [None] * len(ordered)

        def run_one(i: int) -> None:
            prop, parent = ordered[i], parents[i]
            state = RoundState(
                round=g, baseline_variant=parent.variant,
                baseline_time_s=parent.fitness,
                feedback=self._feedback(parent.variant),
                history=history, errors=errors,
                hints=[],          # seeds/migrants are engine-managed
                diagnosis=diag)
            persona = getattr(prop, "persona", "") or "expert"
            try:
                vs = prop.propose(self.case, state, self.pcfg.per_persona)
                out[i] = (persona, parent, list(vs), None)
            except Exception as e:  # noqa: BLE001 — persona isolation
                out[i] = (persona, parent, [], e)

        threaded = sum(1 for p in ordered
                       if isinstance(p, LLMProposer)
                       and p.batcher is not None) >= 2
        if threaded:
            threads = [threading.Thread(target=run_one, args=(i,),
                                        name=f"persona-{i}", daemon=True)
                       for i in range(len(ordered))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            for i in range(len(ordered)):
                run_one(i)
        return out

    def _wave_batcher(self) -> Optional[LLMBatcher]:
        """Make one generation wave of K persona prompts coalesce: when
        the base proposer carried no executor batcher, the clones get a
        private one sized to the wave; either way every LLM persona
        registers as an active participant for the search's duration."""
        llm = [p for p in self.proposers if isinstance(p, LLMProposer)]
        if len(llm) < 2:
            return None
        batcher = llm[0].batcher
        created = None
        if batcher is None:
            batcher = created = LLMBatcher(max_batch=len(llm))
        for p in llm:
            p.batcher = batcher
            batcher.register()
        return created or batcher

    def _release_batcher(self, batcher: Optional[LLMBatcher]) -> None:
        if batcher is None:
            return
        for p in self.proposers:
            if isinstance(p, LLMProposer) and p.batcher is batcher:
                batcher.unregister()

    # ------------------------------------------------------------------
    def search(self, res: OptResult, baseline_v: Variant, t_base: float,
               *, stop_event: Optional[threading.Event] = None) -> str:
        """Run the evolutionary loop; fills ``res`` (rounds = one
        ``RoundLog`` per generation, persona/racing/migration evidence,
        best variant/time, stop reason) and returns the last diagnosed
        bottleneck (for the job-end pattern record)."""
        case, cfg, pcfg = self.case, self.cfg, self.pcfg
        pop: List[Individual] = [Individual(dict(baseline_v), t_base,
                                            persona="baseline")]
        seen = {_vkey(baseline_v)}     # cross-persona/generation dedup
        history: List[Dict[str, Any]] = []
        errors: List[str] = []
        stall = 0
        last_bottleneck = ""
        batcher = self._wave_batcher()
        try:
            for g in range(pcfg.generations):
                if stop_event is not None and stop_event.is_set():
                    res.stop_reason = "stop requested"
                    res.mep_log.append(f"gen {g}: stopped (stop requested)")
                    break
                champion = pop[0]
                prev_best = champion.fitness
                diag = diagnose_feedback(self._feedback(champion.variant),
                                         ci_rel=champion.ci_rel)
                last_bottleneck = diag.bottleneck
                rl = RoundLog(round=g, baseline_time_s=prev_best,
                              diagnosis=diag.to_dict())

                # -- assemble the generation: seeds, migrants, experts --
                # entries: (persona, parent, variant, Pattern|None)
                entries: List[Tuple[str, Individual, Variant,
                                    Optional[Pattern]]] = []
                if g == 0 and self.patterns is not None:
                    for p in self.patterns.suggest_patterns(
                            case, self.platform.name,
                            bottleneck=diag.bottleneck):
                        entries.append((SEED_PERSONA, champion,
                                        self._applied(champion.variant,
                                                      p.delta), p))
                elif pcfg.migrate and self.patterns is not None:
                    for p in self.patterns.suggest_migrants(
                            case, self.platform.name,
                            max_hints=pcfg.max_migrants,
                            bottleneck=diag.bottleneck):
                        entries.append((MIGRANT_PERSONA, champion,
                                        self._applied(champion.variant,
                                                      p.delta), p))
                ordered = self._ordered(diag.bottleneck)
                for persona, parent, vs, err in self._propose_wave(
                        g, ordered, pop, diag, history, errors):
                    if err is not None:
                        errors.append(f"{persona}: {type(err).__name__}: "
                                      f"{err}")
                        st = rl.personae.setdefault(
                            persona, {"proposed": 0, "evaluated": 0,
                                      "raced": 0, "joined": 0})
                        st.setdefault("errors", 0)
                        st["errors"] += 1
                        continue
                    for v in vs:
                        entries.append((persona, parent, v, None))

                # -- cross-persona dedup guard: one paid eval per key --
                wave = []
                for persona, parent, v, pat in entries:
                    st = rl.personae.setdefault(
                        persona, {"proposed": 0, "evaluated": 0,
                                  "raced": 0, "joined": 0})
                    st["proposed"] += 1
                    key = _vkey(v)
                    if key in seen:
                        continue
                    seen.add(key)
                    wave.append((persona, parent, v, pat))

                stop = ""
                if not wave:
                    stop = "wave exhausted (no novel candidates)"

                # -- tournament-by-racing evaluation ------------------
                outcomes: List[Tuple[str, Optional[Pattern], bool]] = []
                for persona, parent, v, pat in wave:
                    if stop_event is not None and stop_event.is_set():
                        stop = "stop requested"
                        break
                    opponent = self._opponent(pop)
                    cl = self.evaluator.evaluate(
                        v, incumbent_s=opponent.fitness)
                    cl.persona = persona
                    rl.candidates.append(cl)
                    st = rl.personae[persona]
                    st["evaluated"] += 1
                    history.append({"variant": cl.variant,
                                    "time_s": cl.time_s,
                                    "status": cl.status,
                                    "raced_out": cl.raced_out,
                                    "persona": persona})
                    joined = False
                    if cl.status != "ok":
                        errors.append(cl.error)
                    elif cl.raced_out:
                        # the tournament's cheap kill: retired at r_min
                        # reps, a loss by construction — never argmin
                        st["raced"] += 1
                        rl.raced_kills += 1
                    else:
                        joined = cl.time_s < opponent.fitness \
                            or len(pop) < pcfg.size
                        if joined:
                            st["joined"] += 1
                            ci_rel = cl.ci_half_width_s / cl.time_s \
                                if cl.time_s else 0.0
                            self._insert(pop, Individual(
                                dict(cl.variant), cl.time_s,
                                persona=persona, born=g, ci_rel=ci_rel,
                                lineage=parent.lineage + (persona,)))
                    if pat is not None:
                        rl.migrations.append({
                            "source": pat.source_kernel,
                            "delta": dict(pat.delta), "gain": pat.gain,
                            "bottleneck": pat.bottleneck,
                            "persona": persona, "joined": joined})
                        if persona == MIGRANT_PERSONA:
                            res.migrations_in += 1
                            res.migrations_joined += int(joined)
                    outcomes.append((persona, pat, joined))

                # -- generation bookkeeping ---------------------------
                feasible = [c for c in rl.candidates
                            if c.status == "ok" and not c.raced_out]
                rl.best_time_s = min((c.time_s for c in feasible),
                                     default=float("inf"))
                best = pop[0]
                gain = prev_best / best.fitness if best.fitness \
                    else float("inf")
                rl.improved = gain > 1.0 + cfg.improve_eps

                # seed/migrant acceptance evidence (greedy-compatible
                # hint records + the store's acceptance ledger)
                for persona, pat, joined in outcomes:
                    if pat is None:
                        continue
                    accepted = rl.improved and all(
                        best.variant.get(k) == val
                        for k, val in pat.delta.items())
                    rl.hints.append({"delta": dict(pat.delta),
                                     "source": pat.source_kernel,
                                     "gain": pat.gain,
                                     "bottleneck": diag.bottleneck,
                                     "accepted": accepted,
                                     "pid": pat.pid, "ns": pat.ns})
                    res.hints_suggested += 1
                    res.hints_accepted += int(accepted)
                    if self.patterns is not None:
                        self.patterns.record_hint_outcome(
                            case, self.platform.name, pat, won=accepted,
                            bottleneck=diag.bottleneck)

                if rl.improved:
                    stall = 0
                    if self.patterns is not None:
                        # export the improvement mid-campaign: this IS
                        # the outbound migration — concurrent cases'
                        # next generations import it via
                        # suggest_migrants
                        exported = self.patterns.record(
                            case, self.platform.name, baseline_v,
                            best.variant,
                            t_base / best.fitness if best.fitness
                            else float("inf"),
                            bottleneck=diag.bottleneck)
                        if exported is not None:
                            res.migrations_out += 1
                else:
                    stall += 1
                if not stop and stall >= max(1, pcfg.patience):
                    stop = (f"no improvement for {stall} "
                            f"generation(s) (patience)")
                rl.stop_reason = stop
                res.rounds.append(rl)
                self._journal(rl, g, pop, stop)
                res.mep_log.append(
                    f"gen {g}: best {best.fitness * 1e6:.2f}us "
                    f"(pop {len(pop)}, {len(rl.candidates)} evaluated, "
                    f"{rl.raced_kills} raced out, "
                    f"{len(rl.migrations)} migrants)")
                if stop:
                    res.stop_reason = stop
                    break
            if not res.stop_reason:
                res.stop_reason = \
                    f"generations={pcfg.generations} exhausted"
        finally:
            self._release_batcher(batcher)

        res.best_variant = dict(pop[0].variant)
        res.best_time_s = pop[0].fitness
        for rl in res.rounds:
            res.raced_kills += rl.raced_kills
            for persona, st in rl.personae.items():
                agg = res.persona_stats.setdefault(
                    persona, {"proposed": 0, "evaluated": 0,
                              "raced": 0, "joined": 0})
                for k, n in st.items():
                    agg[k] = agg.get(k, 0) + n
        champ = pop[0]
        if champ.lineage:
            res.mep_log.append(
                f"population: champion bred by {champ.persona!r} "
                f"gen {champ.born} (lineage {' -> '.join(champ.lineage)})")
        return last_bottleneck

    # ------------------------------------------------------------------
    def _journal(self, rl: RoundLog, g: int, pop: List[Individual],
                 stop: str) -> None:
        """One ResultsDB record per generation, carrying the population
        evidence (persona provenance, raced-kill counts, migration
        events) through whatever executor runs this job — the wire-path
        acceptance gate reads these back from the journal file."""
        if not self.db:
            return
        from repro_torch.core.evalcache import this_host
        self.db.append(
            "round", campaign=self.campaign_id, job=self.job_name,
            case=self.case.name, round=g, worker=os.getpid(),
            host=this_host(),
            baseline_time_s=rl.baseline_time_s,
            best_time_s=rl.best_time_s, improved=rl.improved,
            stop_reason=stop, diagnosis=rl.diagnosis,
            ppi_hints=[dict(h) for h in rl.hints],
            personae={k: dict(v) for k, v in rl.personae.items()},
            raced_kills=rl.raced_kills,
            migrations=[dict(m) for m in rl.migrations],
            population=[{"variant": i.variant, "fitness": i.fitness,
                         "persona": i.persona, "born": i.born}
                        for i in pop],
            candidates=[{"variant": c.variant, "status": c.status,
                         "time_s": c.time_s, "cached": c.cached,
                         "reps": c.reps,
                         "ci_half_width_s": c.ci_half_width_s,
                         "raced_out": c.raced_out,
                         "persona": c.persona}
                        for c in rl.candidates])
