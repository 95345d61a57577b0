"""Campaign workers: the per-case search loop and the in-process executor.

Port of the in-process part of ``repro.core.workers`` (``workers.py:100-390``
and ``InProcessExecutor``, ``:506-588``).  A campaign hands its ``CaseJob``s
to an ``Executor`` and never touches an MEP directly; ``run_case_job`` is
the paper's §3.2 round loop for one kernel.  The subprocess, remote and
chaos executors, population search and the LLM batcher wait for ROADMAP
queue 1 item 9.

On the ``h100`` platform every thread of a campaign launches on the
device's default stream, so another thread's FE kernels could land inside
a timed CUDA-event window; the timing lease serialises only the timed
slices.  A campaign there runs with ``max_workers=1`` (``Campaign``).
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.aer import AER
from repro_torch.core.diagnosis import diagnose_feedback
from repro_torch.core.evalcache import EvalCache, ResultsDB, this_host
from repro_torch.core.kernelcase import KernelCase
from repro_torch.core.measure import MeasureConfig, resolve_lease
from repro_torch.core.mep import MEP, MEPConstraints, build_mep
from repro_torch.core.optimizer import Evaluator, OptConfig, OptResult, RoundLog
from repro_torch.core.patterns import Pattern, PatternStore
from repro_torch.core.profiler import Platform
from repro_torch.core.proposer import Proposer, RoundState


@dataclass
class CaseJob:
    """One unit of campaign work: optimize ``case`` with ``proposer``."""
    case: KernelCase
    proposer: Proposer
    # default_factory, NOT a shared instance: OptConfig is mutable, so a
    # class-level default would alias per-job config mutation (setting
    # one job's cfg.measure would silently set every defaulted job's)
    cfg: OptConfig = field(default_factory=OptConfig)
    constraints: MEPConstraints = field(default_factory=MEPConstraints)
    seed: int = 0
    mep: Optional[MEP] = None       # pre-built MEP (else built & shared)
    label: str = ""                 # distinguishes jobs on the same case

    @property
    def name(self) -> str:
        return self.label or self.case.name


@dataclass
class WorkerContext:
    """Everything an executor needs beside the jobs themselves — the
    scheduler-owned shared state.  Executors must reach MEPs only
    through ``run_case_job``; the scheduler never builds one."""
    platform: Platform
    cache: Optional[EvalCache] = None
    patterns: Optional[PatternStore] = None
    db: Optional[ResultsDB] = None
    # campaign-level default measurement policy (per-job cfg.measure
    # wins) and the cross-process timing lease file shared by every
    # worker timing this campaign's wall-clock sections
    measure: Optional[MeasureConfig] = None
    lease_path: Optional[str] = None


# ---------------------------------------------------------------------------
# the paper's §3.2 search loop for ONE kernel — the unit an executor runs
# ---------------------------------------------------------------------------
def run_case_job(job: CaseJob, platform: Platform, *,
                 campaign_id: str = "",
                 cache: Optional[EvalCache] = None,
                 patterns: Optional[PatternStore] = None,
                 db: Optional[ResultsDB] = None,
                 mep: Optional[MEP] = None,
                 measure: Optional[MeasureConfig] = None,
                 lease_path: Optional[str] = None
                 ) -> OptResult:
    """Round loop (eq. 5): propose → evaluate (build→FE→time, AER-wrapped,
    cache-served) → argmin, with the uniform early stop.  Serial per
    case; concurrency happens across cases, in whichever executor —
    measured platforms included, because wall-clock sections serialize
    on the campaign's timing lease (``lease_path``), not on worker
    exclusivity.  A ``cfg.population`` raises: population search is not
    ported yet."""
    t_start = time.time()
    case, proposer, cfg = job.case, job.proposer, job.cfg
    if cfg.population is not None:
        raise NotImplementedError("population search is not ported yet "
                                  "(ROADMAP queue 1 item 9)")
    # measurement policy: per-job cfg wins over the campaign default;
    # the campaign's lease path is folded in either way
    mcfg = resolve_lease(cfg.measure or measure, lease_path)
    if mep is None:
        # the auto-sizing probes carry the lease too: a worker's probe
        # must not wall-clock over another worker's leased eq. 3 slices
        mep = job.mep or build_mep(case, platform,
                                   constraints=job.constraints,
                                   seed=job.seed,
                                   budget=mcfg)
    aer = AER(case, mep.scale)
    evaluator = Evaluator(mep, case, platform.name, aer, proposer,
                          cfg, cache=cache,
                          measured=not getattr(platform,
                                               "concurrency_safe", False),
                          measure_cfg=mcfg)

    baseline_v = dict(case.baseline_variant)
    t_base = evaluator.measure_baseline(baseline_v)
    best_v, best_t = baseline_v, t_base
    res = OptResult(case.name, platform.name, proposer.name,
                    baseline_v, t_base, best_v, best_t,
                    mep_log=list(mep.log))

    last_bottleneck = _greedy_rounds(
        job, platform, res, evaluator, mep, baseline_v, t_base,
        campaign_id=campaign_id, patterns=patterns, db=db)
    best_v = res.best_variant
    if not res.stop_reason:
        res.stop_reason = f"d_rounds={cfg.d_rounds} exhausted"

    res.aer_records = len(aer.records)
    res.cache_hits, res.cache_misses = evaluator.hits, evaluator.misses
    res.timing_reps = evaluator.timing_reps
    res.timing_reps_fixed = evaluator.timing_reps_fixed
    res.raced_out = evaluator.raced
    if evaluator.timing_reps and \
            evaluator.timing_reps < evaluator.timing_reps_fixed:
        res.mep_log.append(
            f"measurement: {evaluator.timing_reps} reps paid vs "
            f"{evaluator.timing_reps_fixed} fixed-R "
            f"({res.rep_savings:.2f}x savings, "
            f"{evaluator.raced} raced out)")
    res.wall_s = time.time() - t_start
    if patterns is not None:
        patterns.record(case, platform.name, baseline_v, best_v,
                        res.speedup, bottleneck=last_bottleneck)
    if db:
        db.append("case_result", campaign=campaign_id,
                  job=job.name, host=this_host(), **res.to_dict())
    return res


def _greedy_rounds(job: CaseJob, platform: Platform, res: OptResult,
                   evaluator: Evaluator, mep: MEP, baseline_v, t_base, *,
                   campaign_id: str, patterns, db) -> str:
    """The paper's greedy one-variant-per-round loop.  Fills ``res``
    rounds/best/stop_reason and returns the last diagnosed bottleneck."""
    case, proposer, cfg = job.case, job.proposer, job.cfg
    history: List[Dict[str, Any]] = []
    errors: List[str] = []
    best_v, best_t = dict(baseline_v), t_base
    best_ci_rel = 0.0           # rel. CI of the timing behind best_t
    last_bottleneck = ""
    for d in range(cfg.d_rounds):
        # diagnose the incumbent: WHY is it slow?  The verdict routes
        # the proposer's move set, picks the PPI hint bucket, tags the
        # round journal, and stamps this round's recorded patterns
        feedback = platform.profile_feedback(case, best_v, mep.scale)
        diag = diagnose_feedback(feedback, ci_rel=best_ci_rel)
        last_bottleneck = diag.bottleneck
        hints: Optional[List[Pattern]] = None
        if patterns is not None:
            # round boundary: fold other workers' journal appends in, so
            # a win recorded by a concurrent case — possibly in another
            # process — reaches this round's proposal wave (§3.2 PPI).
            # ONE snapshot per round: the proposer consumes exactly the
            # hint deltas the round record journals below
            hints = patterns.suggest_patterns(case, platform.name,
                                              bottleneck=diag.bottleneck)
        state = RoundState(
            round=d, baseline_variant=best_v, baseline_time_s=best_t,
            feedback=feedback,
            history=history, errors=errors,
            hints=None if hints is None
            else [dict(p.delta) for p in hints],
            diagnosis=diag)
        cands = proposer.propose(case, state, cfg.n_candidates)
        rl = RoundLog(round=d, baseline_time_s=best_t,
                      diagnosis=diag.to_dict())
        for v in cands:
            # the current best is the incumbent: timing a candidate
            # aborts once its optimistic lower bound provably loses
            cl = evaluator.evaluate(v, incumbent_s=best_t)
            rl.candidates.append(cl)
            # raced_out is marked in the proposer-visible history too: a
            # truncated trimmed mean must not read as a near-miss full
            # measurement when later rounds steer proposals
            history.append({"variant": cl.variant, "time_s": cl.time_s,
                            "status": cl.status,
                            "raced_out": cl.raced_out})
            if cl.status != "ok":
                errors.append(cl.error)
        # a raced-out candidate is a loss by construction (its partial
        # trimmed mean is not a full eq. 3 measurement): it never enters
        # the argmin, so it can never become a winner
        feasible = [c for c in rl.candidates
                    if c.status == "ok" and not c.raced_out]
        raced = [c for c in rl.candidates if c.raced_out]
        # eq. 5 argmin + uniform early stop: ANY round (round 0
        # included) that fails to improve by > eps ends the loop,
        # with the reason logged.
        stop = ""
        if not feasible:
            stop = ("all candidates raced out (none can beat the "
                    "incumbent)") if raced else "no feasible candidates"
        else:
            winner = min(feasible, key=lambda c: c.time_s)
            rl.best_time_s = winner.time_s
            gain = best_t / winner.time_s if winner.time_s else float("inf")
            if winner.time_s < best_t:
                best_v, best_t = winner.variant, winner.time_s
                best_ci_rel = winner.ci_half_width_s / winner.time_s \
                    if winner.time_s else 0.0
            rl.improved = gain > 1.0 + cfg.improve_eps
            if not rl.improved:
                if gain <= 1.0:
                    stop = (f"winner did not beat baseline "
                            f"(gain {gain:.4f}x)")
                else:
                    stop = (f"round gain {gain:.4f}x below threshold "
                            f"{1.0 + cfg.improve_eps:.4f}x")
        rl.stop_reason = stop
        # per-hint acceptance evidence: did each suggested delta end up
        # in the round winner?  Journaled into the RoundLog AND fed back
        # to the store's acceptance ledger, so repeatedly-useless hints
        # decay out of future suggestion waves
        for p in hints or []:
            accepted = rl.improved and all(
                best_v.get(k) == val for k, val in p.delta.items())
            rl.hints.append({"delta": dict(p.delta),
                             "source": p.source_kernel, "gain": p.gain,
                             "bottleneck": diag.bottleneck,
                             "accepted": accepted,
                             "pid": p.pid, "ns": p.ns})
            res.hints_suggested += 1
            res.hints_accepted += int(accepted)
            if patterns is not None:
                patterns.record_hint_outcome(case, platform.name, p,
                                             won=accepted,
                                             bottleneck=diag.bottleneck)
        res.rounds.append(rl)
        if rl.improved and patterns is not None:
            # record the round's cumulative win immediately (not at job
            # end): concurrent cases' next rounds inherit it mid-campaign
            patterns.record(case, platform.name, baseline_v, best_v,
                            t_base / best_t if best_t else float("inf"),
                            bottleneck=diag.bottleneck)
        if db:
            db.append(
                "round", campaign=campaign_id, job=job.name,
                case=case.name, round=d, worker=os.getpid(),
                host=this_host(),
                baseline_time_s=rl.baseline_time_s,
                best_time_s=rl.best_time_s, improved=rl.improved,
                stop_reason=stop,
                diagnosis=rl.diagnosis,
                ppi_hints=[dict(h) for h in rl.hints],
                candidates=[{"variant": c.variant, "status": c.status,
                             "time_s": c.time_s, "cached": c.cached,
                             "reps": c.reps,
                             "ci_half_width_s": c.ci_half_width_s,
                             "raced_out": c.raced_out}
                            for c in rl.candidates])
        if stop:
            res.mep_log.append(f"round {d}: stopped ({stop})")
            res.stop_reason = stop
            break
    res.best_variant, res.best_time_s = best_v, best_t
    return last_bottleneck


class Executor:
    """Transport-agnostic evaluation backend.  ``run`` maps jobs to
    outcomes (``OptResult`` or the ``Exception`` that killed the job),
    in job order; it must not raise for a single job's failure."""

    name = "abstract"

    def run(self, jobs: List[CaseJob], ctx: WorkerContext, *,
            campaign_id: str = "") -> List[Any]:
        raise NotImplementedError

    def close(self) -> None:
        """Release any long-lived resources (persistent workers)."""


class InProcessExecutor(Executor):
    """Bounded thread pool in the scheduler's process — the default, and
    the reference semantics every other transport must match."""

    name = "inprocess"

    def __init__(self, max_workers: int = 4):
        self.max_workers = max(1, max_workers)
        self._mep_lock = threading.Lock()
        self._mep_locks: Dict[Tuple, threading.Lock] = {}
        self._meps: Dict[Tuple, MEP] = {}

    # ------------------------------------------------------------------
    def _get_mep(self, job: CaseJob, ctx: WorkerContext) -> MEP:
        # a pre-built MEP may be pinned to a non-default (e.g. observed
        # traffic) scale, so its scale is part of the dedup identity
        key = (job.case.name, ctx.platform.name, job.seed, job.constraints,
               job.mep.scale if job.mep else None)
        with self._mep_lock:
            lk = self._mep_locks.setdefault(key, threading.Lock())
        with lk:
            if key not in self._meps:
                self._meps[key] = job.mep or build_mep(
                    job.case, ctx.platform, constraints=job.constraints,
                    seed=job.seed,
                    budget=resolve_lease(job.cfg.measure or ctx.measure,
                                         ctx.lease_path))
            return self._meps[key]

    def run(self, jobs, ctx, *, campaign_id=""):
        from concurrent.futures import ThreadPoolExecutor

        def guarded(job: CaseJob):
            try:
                mep = self._get_mep(job, ctx)
                return run_case_job(
                    job, ctx.platform, campaign_id=campaign_id,
                    cache=ctx.cache, patterns=ctx.patterns, db=ctx.db,
                    mep=mep,
                    measure=ctx.measure, lease_path=ctx.lease_path)
            except Exception as e:  # noqa: BLE001 — isolate job failures
                return e

        if self.max_workers == 1 or len(jobs) == 1:
            return [guarded(j) for j in jobs]
        with ThreadPoolExecutor(self.max_workers) as ex:
            return [f.result() for f in [ex.submit(guarded, j)
                                         for j in jobs]]


