"""Out-of-process evaluation fabric: transport-agnostic campaign workers.

Port of ``repro.core.workers``.  A campaign hands its ``CaseJob``s to an
``Executor`` and never touches an MEP directly:

* ``InProcessExecutor``   — a bounded thread pool (default).  MEPs are
  deduped per (case, platform, seed, constraints, scale).
* ``SubprocessExecutor``  — one MEP per worker *process*.  Jobs travel
  as serialized eval specs (``job_to_spec``) over a line-JSON pipe to
  ``python -m repro_torch.core.worker_main`` workers; results come back
  as full ``OptResult`` wire dicts.  The shared ``EvalCache`` JSONL, the
  ``PatternStore`` journal and the ``ResultsDB`` journal are the only
  shared state.
* ``LocalClusterExecutor`` — N persistent subprocess workers, routed by
  case affinity with work-stealing.
* ``RemoteExecutor``        — the same protocol over TCP to
  ``python -m repro_torch.core.remote_worker`` servers (``socket`` and
  ``spawn`` transports) or over ssh-piped stdio (``ssh``), with per-host
  health, quarantine and journal replication (``core.replicate``).

The spec, the reply, the journal lines and the ``REPRO_CHAOS`` plan keep
the reference's keys and shapes, so either package reads what the other
wrote.  Workers are fresh interpreters started by ``Popen`` that import
``torch`` and nothing of JAX.

On the card, worker processes run in separate CUDA contexts that the GPU
time-slices, so another worker's launches could land inside a timed
CUDA-event window; the host-scoped timing lease cannot see that.  Every
stretch of a worker's device work on a measured card platform (``h100``,
``h100-torch``) is therefore held under the card's device lease
(``measure.DeviceLease``: one file per physical card, whatever the host
alias), and each hold is journaled as a ``device_lease`` record.
Analytic (``h100-model``) and CPU platforms fan out as in the reference.

Process-level crashes, timeouts and connection failures become
``WorkerFault``s (kind crash|timeout|connect) with automatic worker
replacement and retry; ``RemoteExecutor`` quarantines a host whose slots
keep faulting and probes it back with pings under backoff, journaling
``host_quarantined`` / ``host_readmitted`` / ``job_rerouted``.  The
scripted fault harness (``core.chaos``) drives these paths.

With ``REPRO_LAUNCH_LOG`` naming a file, each worker appends one line per
job with its kernel launches (by body and by device-lease hold) and the
distinct calls the suites made of each kernel: what a card run holds
against the plain versions, outside the spec wire.
"""
from __future__ import annotations

import atexit
import json
import os
import select
import shlex
import socket
import subprocess
import sys
import tempfile
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

from repro_torch.core.aer import AER, WorkerFault
from repro_torch.core.chaos import ChaosInjector, FaultPlan
from repro_torch.core.diagnosis import diagnose_feedback
from repro_torch.core.evalcache import (EvalCache, ResultsDB, append_jsonl,
                                        json_safe, this_host)
from repro_torch.core.kernelcase import KernelCase
from repro_torch.core.measure import (MeasureConfig, default_lease_path,
                                      lease_journal, resolve_lease)
from repro_torch.core.mep import MEP, MEPConstraints, build_mep
from repro_torch.core.optimizer import (Evaluator, OptConfig, OptResult,
                                        RoundLog)
from repro_torch.core.patterns import Pattern, PatternStore
from repro_torch.core.population import Population, PopulationConfig
from repro_torch.core.profiler import (Platform, platform_from_name,
                                       platform_to_name)
from repro_torch.core.proposer import (LLMBatcher, LLMProposer, Proposer,
                                       RoundState, persona_proposers,
                                       proposer_from_spec)




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
    verbose: bool = False
    # campaign-level default measurement policy (per-job cfg.measure
    # wins) and the cross-process timing lease file shared by every
    # worker timing this campaign's wall-clock sections
    measure: Optional[MeasureConfig] = None
    lease_path: Optional[str] = None
    # when lease_path was *derived* (not caller-pinned), the derivation
    # coordinates ({"cache": ..., "scope": ...}) travel in the spec so a
    # worker on another host re-resolves the lease with its own
    # hostname — a lease arbitrates ONE machine's CPUs, never a fleet's
    lease_scope: Optional[Dict[str, Any]] = None
    # campaign-level default population-search policy (per-job
    # cfg.population wins); None → the greedy §3.2 loop
    population: Optional[PopulationConfig] = None


# ---------------------------------------------------------------------------
# the paper's §3.2 search loop for ONE kernel — the unit every executor
# runs, in a pool thread (in-process) or a worker process (subprocess)
# ---------------------------------------------------------------------------
def run_case_job(job: CaseJob, platform: Platform, *,
                 campaign_id: str = "",
                 cache: Optional[EvalCache] = None,
                 patterns: Optional[PatternStore] = None,
                 db: Optional[ResultsDB] = None,
                 stop_event: Optional[threading.Event] = None,
                 verbose: bool = False,
                 mep: Optional[MEP] = None,
                 scale: Optional[int] = None,
                 measure: Optional[MeasureConfig] = None,
                 lease_path: Optional[str] = None,
                 population: Optional[PopulationConfig] = None
                 ) -> OptResult:
    """Round loop (eq. 5): propose → evaluate (build→FE→time, AER-wrapped,
    cache-served) → argmin, with the uniform early stop.  Serial per
    case; concurrency happens across cases, in whichever executor —
    measured platforms included, because wall-clock sections serialize
    on the campaign's timing lease (``lease_path``), not on worker
    exclusivity.

    With a ``PopulationConfig`` active (per-job ``cfg.population`` wins
    over the campaign-level ``population``) and a persona-capable
    proposer, the greedy loop is replaced by the evolutionary engine in
    ``repro_torch.core.population`` — expert persona waves, tournament-by-
    racing selection, island migration through the PatternStore.

    With a ``db``, every device-lease hold the job takes on the card is
    journaled there (``device_lease`` records carrying the campaign and
    the job)."""
    with lease_journal(db, campaign=campaign_id, job=job.name):
        return _run_case_job(job, platform, campaign_id=campaign_id,
                             cache=cache, patterns=patterns, db=db,
                             stop_event=stop_event, verbose=verbose,
                             mep=mep, scale=scale, measure=measure,
                             lease_path=lease_path, population=population)


def _run_case_job(job: CaseJob, platform: Platform, *, campaign_id, cache,
                  patterns, db, stop_event, verbose, mep, scale, measure,
                  lease_path, population) -> OptResult:
    t_start = time.time()
    case, proposer, cfg = job.case, job.proposer, job.cfg
    # measurement policy: per-job cfg wins over the campaign default;
    # the campaign's lease path is folded in either way
    mcfg = resolve_lease(cfg.measure or measure, lease_path)
    if mep is None:
        # the auto-sizing probes carry the lease too: a worker's probe
        # must not wall-clock over another worker's leased eq. 3 slices
        mep = job.mep or build_mep(case, platform,
                                   constraints=job.constraints,
                                   seed=job.seed, scale=scale,
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

    history: List[Dict[str, Any]] = []
    errors: List[str] = []
    pcfg = cfg.population if cfg.population is not None else population
    clones = persona_proposers(proposer, pcfg.personae) \
        if pcfg is not None else None
    if clones:
        # population search: expert persona waves + tournament racing +
        # island migration (core.population).  A proposer kind without
        # persona support (e.g. DirectProposer) falls through to the
        # greedy loop below.
        engine = Population(case, platform, mep, evaluator, cfg, pcfg,
                            clones, patterns=patterns, db=db,
                            campaign_id=campaign_id, job_name=job.name,
                            seed=job.seed)
        last_bottleneck = engine.search(res, baseline_v, t_base,
                                        stop_event=stop_event)
        best_v, best_t = res.best_variant, res.best_time_s
    else:
        last_bottleneck = _greedy_rounds(
            job, platform, res, evaluator, mep, baseline_v, t_base,
            campaign_id=campaign_id, patterns=patterns, db=db,
            stop_event=stop_event, history=history, errors=errors)
        best_v, best_t = res.best_variant, res.best_time_s
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
    if verbose:
        print(f"# campaign {job.name}: {res.best_time_s * 1e6:.2f}us, "
              f"{res.speedup:.2f}x over baseline, "
              f"{len(res.rounds)} rounds, {res.cache_hits} cache hits "
              f"[{res.stop_reason}]", flush=True)
    return res


def _greedy_rounds(job: CaseJob, platform: Platform, res: OptResult,
                   evaluator: Evaluator, mep: MEP, baseline_v, t_base, *,
                   campaign_id: str, patterns, db, stop_event,
                   history: List[Dict[str, Any]], errors: List[str]
                   ) -> str:
    """The paper's greedy one-variant-per-round loop (the pre-population
    baseline, still the default).  Fills ``res`` rounds/best/stop_reason
    and returns the last diagnosed bottleneck."""
    case, proposer, cfg = job.case, job.proposer, job.cfg
    best_v, best_t = dict(baseline_v), t_base
    best_ci_rel = 0.0           # rel. CI of the timing behind best_t
    last_bottleneck = ""
    for d in range(cfg.d_rounds):
        if stop_event is not None and stop_event.is_set():
            res.stop_reason = "stop requested"
            res.mep_log.append(f"round {d}: stopped (stop requested)")
            break
        # diagnose the incumbent: WHY is it slow?  The verdict routes
        # the proposer's move set, picks the PPI hint bucket, tags the
        # round journal, and stamps this round's recorded patterns
        feedback = platform.profile_feedback(case, best_v, mep.scale)
        diag = diagnose_feedback(feedback, ci_rel=best_ci_rel)
        last_bottleneck = diag.bottleneck
        hints: Optional[List[Pattern]] = None
        if patterns is not None and getattr(cfg, "ppi", True):
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


# ---------------------------------------------------------------------------
# wire form
# ---------------------------------------------------------------------------
def job_to_spec(job: CaseJob, ctx: WorkerContext, campaign_id: str
                ) -> Dict[str, Any]:
    """Serialize one CaseJob + the shared-state coordinates into the eval
    spec a worker process consumes.  Raises TypeError/ValueError up
    front for anything that cannot cross the process boundary."""
    if ctx.cache is not None and not ctx.cache.path:
        raise ValueError(
            "subprocess executors need a file-backed EvalCache (or none): "
            "an in-memory cache cannot be shared across processes")
    # cross-process timing lease: every worker timing this campaign's
    # wall-clock sections ON THE SAME HOST must serialize on the same
    # arbiter file.  The campaign provides one (next to its cache,
    # host-scoped); for direct executor users the same rule is
    # re-derived here, campaign-scoped — a measured platform must never
    # fan out lease-less.  ``lease_scope`` ships the derivation
    # coordinates so a worker on ANOTHER host re-resolves the lease with
    # its own hostname instead of contending with (or, worse, silently
    # sharing eq. 3 slices with) the scheduler's host.
    lease = ctx.lease_path
    lease_scope = ctx.lease_scope
    if lease is None and not getattr(ctx.platform, "concurrency_safe",
                                     False):
        cache_path = ctx.cache.path if ctx.cache is not None else None
        lease = default_lease_path(cache_path, scope=campaign_id)
        lease_scope = {"cache": cache_path, "scope": campaign_id}
    return {
        "job": {
            "case": job.case.to_dict(),
            "proposer": job.proposer.to_spec(),
            "cfg": job.cfg.to_dict(),
            "constraints": job.constraints.to_dict(),
            "seed": job.seed,
            "label": job.label,
            # a pre-built MEP may be pinned to a non-default (observed
            # traffic) scale; the worker rebuilds at the same pin
            "scale": job.mep.scale if job.mep else None,
        },
        "platform": platform_to_name(ctx.platform),
        # a host-derived (default) namespace ships as None: the worker
        # re-derives it locally, so measured records taken on host B are
        # stamped host B and never replay as if timed on host A.  Only a
        # caller-pinned namespace crosses the wire verbatim.
        "cache": None if ctx.cache is None else {
            "path": ctx.cache.path,
            "ns": ctx.cache.namespace
            if getattr(ctx.cache, "ns_explicit", True) else None,
            "ttl_s": ctx.cache.ttl_s},
        # a file-backed PatternStore ships its coordinates so workers
        # record and suggest against the shared journal; an in-memory
        # store stays scheduler-side (recording on job completion only)
        "patterns": ctx.patterns.to_spec()
        if ctx.patterns is not None and ctx.patterns.path else None,
        "db": ctx.db.path if ctx.db else None,
        "measure": ctx.measure.to_dict() if ctx.measure else None,
        "population": ctx.population.to_dict()
        if ctx.population else None,
        "lease": lease,
        "lease_scope": lease_scope,
        "host": this_host(),
        "campaign": campaign_id,
        "verbose": ctx.verbose,
        "stop": False,
    }


def job_from_spec(spec: Dict[str, Any]) -> Tuple[CaseJob, Optional[int]]:
    """Worker-side inverse of ``job_to_spec`` (job part only); returns the
    job plus the pinned MEP scale (None → auto-sized)."""
    j = spec["job"]
    job = CaseJob(
        case=KernelCase.from_dict(j["case"]),
        proposer=proposer_from_spec(j["proposer"]),
        cfg=OptConfig.from_dict(j["cfg"]),
        constraints=MEPConstraints.from_dict(j["constraints"]),
        seed=int(j.get("seed", 0)),
        label=j.get("label", ""))
    scale = j.get("scale")
    return job, (int(scale) if scale is not None else None)


def lease_for_spec(spec: Dict[str, Any]) -> Optional[str]:
    """The timing-lease path THIS host must use for ``spec``.  A lease
    arbitrates contention for one machine's CPUs: when the spec was
    built on another host (``spec["host"]``) and its lease path was
    *derived* (``lease_scope`` present) rather than caller-pinned, the
    worker re-derives it with its own hostname — sharing host A's
    arbiter file from host B would serialize the fleet's wall-clock
    slices against each other without protecting anything."""
    lease = spec.get("lease")
    scope = spec.get("lease_scope")
    if scope is not None and spec.get("host") \
            and spec["host"] != this_host():
        return default_lease_path(scope.get("cache"),
                                  scope=str(scope.get("scope") or ""))
    return lease


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------
class Executor:
    """Transport-agnostic evaluation backend.  ``run`` maps jobs to
    outcomes (``OptResult`` or the ``Exception`` that killed the job),
    in job order; it must not raise for a single job's failure."""

    name = "abstract"

    def run(self, jobs: List[CaseJob], ctx: WorkerContext, *,
            campaign_id: str = "",
            stop: Optional[threading.Event] = None) -> List[Any]:
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

    def _attach_batcher(self, jobs: List[CaseJob],
                        ctx: Optional[WorkerContext] = None
                        ) -> Optional[LLMBatcher]:
        """Coalesce LLM round prompts across the campaign's concurrent
        cases: all LLM proposers without their own batcher share one.
        Population jobs contribute one prompt per persona per wave, so
        ``max_batch`` is sized to the sum of the jobs' wave widths."""
        if ctx is None:      # run() stashes it; tests wrap 1-arg
            ctx = getattr(self, "_batch_ctx", None)
        props, width = [], 0
        for j in jobs:
            if not (isinstance(j.proposer, LLMProposer)
                    and j.proposer.batcher is None):
                continue
            props.append(j.proposer)
            pcfg = j.cfg.population if j.cfg.population is not None \
                else (ctx.population if ctx is not None else None)
            width += len(pcfg.personae) if pcfg is not None else 1
        if len(props) < 2 or self.max_workers < 2:
            return None
        batcher = LLMBatcher(max_batch=max(width, len(props)))
        for p in props:
            p.batcher = batcher
            batcher.register()
        return batcher

    def run(self, jobs, ctx, *, campaign_id="", stop=None):
        from concurrent.futures import ThreadPoolExecutor
        self._batch_ctx = ctx
        batcher = self._attach_batcher(jobs)

        def guarded(job: CaseJob):
            try:
                mep = self._get_mep(job, ctx)
                return run_case_job(
                    job, ctx.platform, campaign_id=campaign_id,
                    cache=ctx.cache, patterns=ctx.patterns, db=ctx.db,
                    stop_event=stop, verbose=ctx.verbose, mep=mep,
                    measure=ctx.measure, lease_path=ctx.lease_path,
                    population=ctx.population)
            except Exception as e:  # noqa: BLE001 — isolate job failures
                return e
            finally:
                if batcher is not None and \
                        getattr(job.proposer, "batcher", None) is batcher:
                    batcher.unregister()

        if self.max_workers == 1 or len(jobs) == 1:
            return [guarded(j) for j in jobs]
        with ThreadPoolExecutor(self.max_workers) as ex:
            return [f.result() for f in [ex.submit(guarded, j)
                                         for j in jobs]]


# ---------------------------------------------------------------------------
class _LineChannel:
    """One endpoint of the line-JSON spec protocol over a byte stream.
    The buffer holds raw *bytes*; a line is decoded only once its
    terminating newline has arrived, so a multi-byte UTF-8 sequence
    split across read chunks can never be torn (decoding chunk
    boundaries with ``errors="replace"`` used to corrupt it)."""

    _buf: bytes = b""

    # transport hooks ---------------------------------------------------
    def _fd(self) -> int:
        raise NotImplementedError

    def alive(self) -> bool:
        raise NotImplementedError

    def diagnostic(self) -> str:
        return "peer closed"

    # ------------------------------------------------------------------
    def recv(self, timeout_s: Optional[float]) -> Dict[str, Any]:
        """Read one protocol line; raises TimeoutError / EOFError."""
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        fd = self._fd()
        while True:
            nl = self._buf.find(b"\n")
            if nl >= 0:
                line, self._buf = self._buf[:nl], self._buf[nl + 1:]
                if line.strip():
                    return json.loads(line.decode("utf-8",
                                                  errors="replace"))
                continue
            wait = None if deadline is None else deadline - time.monotonic()
            if wait is not None and wait <= 0:
                raise TimeoutError(f"no result within {timeout_s}s")
            ready, _, _ = select.select([fd], [], [],
                                        min(wait, 1.0) if wait else 1.0)
            if not ready:
                if not self.alive() and not self._buf:
                    raise EOFError(self.diagnostic())
                continue
            chunk = os.read(fd, 65536)
            if not chunk:
                raise EOFError(self.diagnostic())
            self._buf += chunk


class _WorkerProc(_LineChannel):
    """One worker subprocess + its pipe protocol.  stderr goes to a temp
    file whose tail becomes the fault diagnostic on crash.  The stdio
    pipes are opened in *binary* mode: ``recv`` reads the raw fd (via
    ``_LineChannel``), and a ``text=True`` TextIOWrapper sitting on the
    same fd could strand bytes in its own buffer where the fd-level
    reader would never see them."""

    def __init__(self, cmd: List[str], env: Dict[str, str], slot: Any):
        self.slot = slot
        self._buf = b""
        self.log = tempfile.NamedTemporaryFile(
            mode="w+b", prefix=f"repro-worker{slot}-", suffix=".log",
            delete=False)
        self.proc = subprocess.Popen(
            cmd, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.log)

    def _fd(self) -> int:
        return self.proc.stdout.fileno()

    def alive(self) -> bool:
        return self.proc.poll() is None

    def send(self, spec: Dict[str, Any]) -> None:
        self.proc.stdin.write((json.dumps(spec) + "\n").encode())
        self.proc.stdin.flush()

    def diagnostic(self) -> str:
        code = self.proc.poll()
        tail = ""
        try:
            self.log.flush()
            with open(self.log.name, "rb") as f:
                f.seek(max(0, os.fstat(f.fileno()).st_size - 2000))
                tail = f.read().decode(errors="replace").strip()
        except OSError:
            pass
        return f"exit={code}" + (f"; stderr tail:\n{tail}" if tail else "")

    def kill(self) -> None:
        try:
            if self.alive():
                self.proc.kill()
            self.proc.wait(timeout=5)
        except (OSError, subprocess.TimeoutExpired):
            pass
        for h in (self.proc.stdin, self.proc.stdout, self.log):
            try:
                h.close()
            except OSError:
                pass
        try:
            os.unlink(self.log.name)
        except OSError:
            pass


class _ConnectError(OSError):
    """Connection *establishment* failed (server down, refused, or the
    bounded connect timeout elapsed) — distinct from a crash of a live
    worker, so it surfaces as ``WorkerFault(kind="connect")``."""


def backoff_schedule(base_s: float, max_s: float,
                     attempts: int) -> List[float]:
    """Deterministic (jitter-free) exponential backoff delays:
    ``base, 2*base, 4*base, ...`` capped at ``max_s``.  Jitter-free on
    purpose — the chaos harness asserts reconnect timing, and a single
    scheduler reconnecting to its own fleet has no thundering herd to
    spread."""
    return [min(base_s * (2 ** i), max_s) for i in range(max(0, attempts))]


class _SocketWorker(_LineChannel):
    """Scheduler-side handle for one remote worker slot: the exact spec
    protocol ``_WorkerProc`` speaks over pipes, over a TCP connection to
    a ``repro_torch.core.remote_worker`` server.  One connection per slot —
    the server serves each connection in its own thread, so a host's
    slots evaluate concurrently."""

    def __init__(self, address: str, slot: Any, *,
                 connect_timeout_s: float = 30.0):
        self.slot = slot
        self.address = address
        self._buf = b""
        host, port = address.rsplit(":", 1)
        try:
            # bounded: a standing server that is down must fail fast as
            # a connect fault, not block dispatch for the OS TCP timeout
            self.sock = socket.create_connection((host, int(port)),
                                                 timeout=connect_timeout_s)
        except OSError as e:
            raise _ConnectError(f"connect {address}: {e}") from e
        self.sock.setblocking(True)
        self._closed = False

    def _fd(self) -> int:
        return self.sock.fileno()

    def alive(self) -> bool:
        return not self._closed

    def send(self, spec: Dict[str, Any]) -> None:
        self.sock.sendall((json.dumps(spec) + "\n").encode())

    def diagnostic(self) -> str:
        return f"remote worker {self.address} closed the connection"

    def kill(self) -> None:
        self._closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def _worker_cmd() -> List[str]:
    """Spawn command for the port's stdio worker: a fresh interpreter
    running ``repro_torch.core.worker_main`` (``_worker_env`` puts the
    port's ``src`` on its path)."""
    return [sys.executable, "-u", "-m", "repro_torch.core.worker_main"]


def _worker_env() -> Dict[str, str]:
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    parts = [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                     if p and p != src]
    env["PYTHONPATH"] = os.pathsep.join(parts)
    return env


class _AffinityRouter:
    """Case→host affinity work router for the multi-slot executors.

    Consumers call ``get(host)``; the router prefers (1) a queued job
    whose case this host already claimed — whoever evaluated a case's
    first job holds the warm MEP build and jit/eval caches — then (2) a
    job on an unclaimed case (claiming it for this host), then (3)
    stealing any queued job so no slot idles while work remains.  A
    steal does *not* reassign the claim: the original host keeps its
    warmth for later jobs on the case.  ``get(None)`` is plain FIFO
    (single-host executors).  ``close()`` wakes all consumers with
    ``None``."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._pending: List[Tuple] = []     # (idx, job, spec, attempt)
        self._claims: Dict[str, Any] = {}   # case name → claiming host
        self._closed = False

    def put(self, item: Tuple) -> None:
        with self._cv:
            self._pending.append(item)
            self._cv.notify_all()

    def claim_of(self, case: str) -> Any:
        with self._cv:
            return self._claims.get(case)

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    def release_host(self, host: Any) -> List[str]:
        """Drop every case→host claim ``host`` holds (quarantine path):
        the next host to pull a job on those cases claims them fresh —
        affinity warmth is worthless on a host that stopped answering.
        Returns the released case names."""
        with self._cv:
            released = [c for c, h in self._claims.items() if h == host]
            for c in released:
                del self._claims[c]
            self._cv.notify_all()
            return released

    def get(self, host: Any) -> Optional[Tuple]:
        with self._cv:
            while True:
                if self._pending:
                    pick = None
                    if host is not None:
                        unclaimed = None
                        for it in self._pending:
                            owner = self._claims.get(it[1].case.name)
                            if owner == host:
                                pick = it
                                break
                            if unclaimed is None and owner is None:
                                unclaimed = it
                        if pick is None:
                            pick = unclaimed   # may still be None → steal
                    if pick is None:
                        pick = self._pending[0]
                    self._pending.remove(pick)
                    if host is not None:
                        self._claims.setdefault(pick[1].case.name, host)
                    return pick
                if self._closed:
                    return None
                self._cv.wait(timeout=0.5)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()


class SubprocessExecutor(Executor):
    """One MEP per worker process: N workers each pull serialized eval
    specs off a work router, evaluate them in their own interpreter
    (their own GIL, their own jit caches), and ship ``OptResult`` wire
    dicts back.  Crashes and timeouts become ``WorkerFault``s with
    automatic worker replacement; the cache/journal files are the only
    shared state."""

    name = "subprocess"
    persistent = False        # workers live for one run() call
    affinity = False          # enable case→host routing (_slot_host)

    def __init__(self, workers: Optional[int] = None, *,
                 timeout_s: Optional[float] = None, retries: int = 1,
                 chaos: Optional[FaultPlan] = None):
        if workers is None:
            workers = int(os.environ.get(
                "REPRO_CAMPAIGN_WORKERS", str(os.cpu_count() or 2)))
        self.workers = max(1, workers)
        if timeout_s is None:
            env = os.environ.get("REPRO_WORKER_TIMEOUT_S", "")
            timeout_s = float(env) if env else None
        self.timeout_s = timeout_s
        self.retries = max(0, retries)
        # scripted fault plan shipped to spawned workers/servers via the
        # REPRO_CHAOS env var (repro_torch.core.chaos) — None in production
        self.chaos = chaos
        from collections import deque
        self.dispatch_log = deque(maxlen=4096)          # (job, slot)
        self._procs: Dict[Any, _WorkerProc] = {}        # slot → process
        self._slot_locks: Dict[Any, threading.Lock] = {}
        self._lock = threading.Lock()

    # -- overridable routing hook (kept for custom executors) --
    def _slots_for(self, ctx: WorkerContext, n_jobs: int) -> List[Any]:
        # measured platforms fan out like analytic ones: their
        # wall-clock sections serialize on the campaign's cross-process
        # timing lease (job_to_spec guarantees every spec carries one),
        # so worker exclusivity is no longer needed to protect eq. 3
        return list(range(min(self.workers, max(1, n_jobs))))

    def _slot_lock(self, slot: Any) -> threading.Lock:
        # one protocol exchange at a time per worker process, even when
        # a persistent executor serves overlapping campaigns
        with self._lock:
            return self._slot_locks.setdefault(slot, threading.Lock())

    def _slot_host(self, slot: Any) -> Any:
        """Affinity unit for the router.  Each local worker process has
        its own jit/eval caches, so locally the *slot* is the unit;
        RemoteExecutor maps slots to their host label instead."""
        return slot

    def _spec_for_slot(self, spec: Dict[str, Any],
                       slot: Any) -> Dict[str, Any]:
        """Per-slot spec rewriting hook (RemoteExecutor remaps journal
        paths for hosts that don't share the scheduler's filesystem)."""
        return spec

    def _inject(self, job: CaseJob, spec: Dict[str, Any]) -> None:
        """Test-only fault injection hook: jobs may carry an ``inject``
        attribute (set by tests) that the worker honors before
        evaluating."""
        inject = getattr(job, "inject", None)
        if inject:
            spec["inject"] = inject

    # -- fault-tolerance hooks (RemoteExecutor overrides) --------------
    def _slot_gate(self, slot: Any, router: "_AffinityRouter",
                   ctx: WorkerContext, campaign_id: str) -> bool:
        """Health gate a slot passes before pulling work.  Returning
        False makes the slot loop come around again without dequeuing
        (the gate is responsible for pacing — sleep/probe inside);
        RemoteExecutor holds quarantined hosts here and probes them
        back to health.  The local fabric has no per-slot health."""
        return True

    def _note_ok(self, slot: Any) -> None:
        """A dispatch on ``slot`` completed a protocol exchange."""

    def _note_fault(self, slot: Any, job: CaseJob, kind: str,
                    router: "_AffinityRouter", ctx: WorkerContext,
                    campaign_id: str) -> None:
        """A dispatch on ``slot`` faulted (called before the retry is
        re-queued, so a quarantining override releases the host's
        claims first and the retry lands on a healthy host)."""

    def _note_dispatch(self, slot: Any, job: CaseJob, ctx: WorkerContext,
                       campaign_id: str) -> None:
        """``job`` is about to be dispatched on ``slot``."""

    def run(self, jobs, ctx, *, campaign_id="", stop=None):
        # serialize everything first: a non-wire-safe job must fail the
        # campaign before any process is spawned
        specs = []
        for job in jobs:
            spec = job_to_spec(job, ctx, campaign_id)
            self._inject(job, spec)
            specs.append(spec)

        if not jobs:
            return []
        outcomes: List[Any] = [None] * len(jobs)
        slots = self._slots_for(ctx, len(jobs))
        router = _AffinityRouter()
        for i, (job, spec) in enumerate(zip(jobs, specs)):
            router.put((i, job, spec, 0))
        remaining = [len(jobs)]

        def finish(idx: int, outcome: Any) -> None:
            outcomes[idx] = outcome
            with self._lock:
                remaining[0] -= 1
                if remaining[0] == 0:
                    router.close()

        def fault(idx, job, spec, attempt, kind, detail, slot):
            """AER worker-fault handling: journal, replace the worker,
            retry on the fresh one, surface WorkerFault when spent."""
            if ctx.db:
                try:
                    ctx.db.append("worker_fault", campaign=campaign_id,
                                  job=job.name, fault=kind,
                                  attempt=attempt + 1, slot=str(slot),
                                  detail=str(detail)[:500])
                except OSError:
                    pass     # a full disk must not turn a retry into a hang
            if attempt < self.retries:
                router.put((idx, job, spec, attempt + 1))
            else:
                finish(idx, WorkerFault(kind, job.name, str(detail)[:500],
                                        attempts=attempt + 1))

        def dispatch(slot, idx, job, spec, attempt) -> None:
            if stop is not None and stop.is_set():
                spec = dict(spec, stop=True)
            spec = self._spec_for_slot(spec, slot)
            self.dispatch_log.append((job.name, slot))
            self._note_dispatch(slot, job, ctx, campaign_id)
            try:
                with self._slot_lock(slot):
                    worker = self._ensure_worker(slot, ctx)
                    worker.send(spec)
                    reply = worker.recv(self.timeout_s)
            except TimeoutError as e:
                self._replace_worker(slot)
                self._note_fault(slot, job, "timeout", router, ctx,
                                 campaign_id)
                fault(idx, job, spec, attempt, "timeout", e, slot)
                return
            except _ConnectError as e:
                self._replace_worker(slot)
                self._note_fault(slot, job, "connect", router, ctx,
                                 campaign_id)
                fault(idx, job, spec, attempt, "connect", e, slot)
                return
            except (EOFError, OSError, BrokenPipeError, ValueError) as e:
                self._replace_worker(slot)
                self._note_fault(slot, job, "crash", router, ctx,
                                 campaign_id)
                fault(idx, job, spec, attempt, "crash", e, slot)
                return
            self._note_ok(slot)
            if reply.get("ok"):
                res = OptResult.from_dict(reply["result"])
                if ctx.patterns is not None and not ctx.patterns.path:
                    # in-memory store couldn't cross the process
                    # boundary: fall back to recording on completion
                    # (a file-backed store was shipped in the spec and
                    # already recorded worker-side, round by round)
                    ctx.patterns.record(job.case, ctx.platform.name,
                                        res.baseline_variant,
                                        res.best_variant, res.speedup)
                finish(idx, res)
            else:
                finish(idx, RuntimeError(
                    f"{reply.get('type', 'Error')}: "
                    f"{reply.get('error', 'worker error')}"))

        def slot_loop(slot: Any) -> None:
            host = self._slot_host(slot) if self.affinity else None
            while True:
                if not self._slot_gate(slot, router, ctx, campaign_id):
                    continue         # gate paces (sleeps/probes) itself
                item = router.get(host)
                if item is None:
                    return
                idx, job, spec, attempt = item
                try:
                    dispatch(slot, idx, job, spec, attempt)
                except Exception as e:  # noqa: BLE001 — a scheduler-side
                    # error (bad reply shape, pattern-store I/O) must fail
                    # THIS job, not strand the whole campaign in get()
                    finish(idx, e)

        threads = [threading.Thread(target=slot_loop, args=(s,),
                                    name=f"exec-slot{s}", daemon=True)
                   for s in slots]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if ctx.cache is not None:
                ctx.cache.reload()   # fold workers' entries into our view
            if ctx.patterns is not None and ctx.patterns.path:
                ctx.patterns.reload()  # fold workers' patterns too
        finally:
            # exception-safe: a one-shot fabric must not leak worker
            # processes when a reload (or a start) raises
            if not self.persistent:
                self.close()
        return outcomes

    def warm(self, slots: Optional[List[Any]] = None,
             timeout_s: float = 120.0) -> None:
        """Pre-spawn the worker processes and wait until each answers a
        protocol ping (interpreter + torch import done).  A persistent
        fabric (LocalClusterExecutor, the serving autotuner) calls this
        once so campaign wall-clock measures evaluation, not startup.

        A worker dying mid-ping goes through the same replace-and-retry
        path ``run`` uses — the dead process is killed and respawned and
        the ping retried, honoring the retry budget — instead of leaving
        a dead slot behind and raising raw EOFError at the caller.  A
        slot that cannot come up surfaces as ``WorkerFault``.  Every
        slot's process is started before the first ping, so the slots'
        interpreters start up side by side."""
        slots = list(slots if slots is not None else range(self.workers))
        self._start_all(slots)
        for slot in slots:
            last: Optional[BaseException] = None
            for attempt in range(self.retries + 1):
                try:
                    with self._slot_lock(slot):
                        w = self._ensure_worker(slot, None)
                        w.send({"ping": True})
                        w.recv(timeout_s)
                    last = None
                    break
                except (TimeoutError, EOFError, OSError,
                        BrokenPipeError, ValueError) as e:
                    last = e
                    self._replace_worker(slot)
            if last is not None:
                kind = "timeout" if isinstance(last, TimeoutError) \
                    else ("connect" if isinstance(last, _ConnectError)
                          else "crash")
                raise WorkerFault(kind, f"warm:{slot}", str(last)[:500],
                                  attempts=self.retries + 1)

    def _start_all(self, slots: List[Any]) -> None:
        """Start every slot's worker without waiting for any (a start
        that fails is left to the ping's replace-and-retry path)."""
        for slot in slots:
            try:
                self._ensure_worker(slot, None)
            except OSError:
                pass

    # ------------------------------------------------------------------
    def _ensure_worker(self, slot: int, ctx: Optional[WorkerContext]
                       ) -> _WorkerProc:
        with self._lock:
            w = self._procs.get(slot)
            if w is None or not w.alive():
                env = _worker_env()
                if self.chaos is not None:
                    self.chaos.to_env(env)
                w = _WorkerProc(_worker_cmd(), env, slot)
                self._procs[slot] = w
            return w

    def _replace_worker(self, slot: int) -> None:
        with self._lock:
            w = self._procs.pop(slot, None)
        if w is not None:
            w.kill()

    def close(self) -> None:
        with self._lock:
            procs, self._procs = list(self._procs.values()), {}
        for w in procs:
            w.kill()

    def __del__(self):  # best-effort cleanup for persistent executors
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class LocalClusterExecutor(SubprocessExecutor):
    """N persistent subprocess workers.  Workers stay alive across
    ``run`` calls (campaign after campaign), so repeated autotune cycles
    don't re-pay interpreter+torch startup.  Measured (wall-clock)
    platforms fan out across the whole pool — the pinned exclusive slot
    they used to get is gone; the cross-process timing lease serializes
    only the wall-clock slices while build/compile/FE/LLM work overlaps
    freely.  Slot routing is affinity-aware: jobs on a case prefer the
    worker process that already served that case (warm jit/eval caches),
    with work-stealing as the fallback."""

    name = "local-cluster"
    persistent = True
    affinity = True


# ---------------------------------------------------------------------------
# networked fleet
# ---------------------------------------------------------------------------
@dataclass
class FleetHost:
    """One machine in a campaign fleet.  The configured ``name`` IS the
    host's fleet-wide identity: it ships to the worker as
    ``REPRO_HOST_ALIAS``, so the measured-cache namespace, the timing
    lease, and every journal's ``host`` provenance key on it (stable
    across DHCP renames, and distinct for simulated loopback hosts).

    Transports:

    * ``spawn``  — the executor launches ``repro_torch.core.remote_worker`` as
      a local loopback server and connects over TCP: a *simulated* fleet
      host for CI/benchmarks that exercises the exact socket + per-host
      namespace/lease code paths of a real one.
    * ``socket`` — connect to an already-running
      ``repro_torch.core.remote_worker`` at ``address`` (``"host:port"``).
    * ``ssh``    — spawn the stdio worker on the remote machine through
      ``ssh`` (reusing ``_WorkerProc``: ssh pipes stdio across the
      wire); ``ssh`` is the target (``user@host``), ``python`` the
      remote interpreter, ``workdir`` an optional remote repo checkout
      to run from (its ``src/`` is put on PYTHONPATH).

    ``slots`` is how many jobs the host evaluates concurrently (one
    socket connection / ssh pipe per slot).  ``cache_path`` /
    ``patterns_path`` / ``db_path`` remap the spec's journal paths for
    hosts that do NOT share the scheduler's filesystem; the executor's
    ``repro_torch.core.replicate`` loop then tail-ships appends both ways
    (unset → shared filesystem, no rewriting)."""
    name: str
    transport: str = "spawn"          # spawn | socket | ssh
    address: str = ""                 # socket: "host:port"
    ssh: str = ""                     # ssh: "user@host"
    python: str = ""                  # ssh: remote interpreter
    workdir: str = ""                 # ssh: remote repo checkout
    slots: int = 1
    cache_path: str = ""
    patterns_path: str = ""
    db_path: str = ""
    # bounded TCP connect for socket/spawn transports: a standing server
    # that is down fails fast as WorkerFault(kind="connect") instead of
    # blocking dispatch for the OS TCP timeout
    connect_timeout_s: float = 10.0

    @staticmethod
    def from_dict(d: Union[str, Dict[str, Any]]) -> "FleetHost":
        if isinstance(d, str):
            return FleetHost(name=d)          # shorthand: spawn, 1 slot
        return FleetHost(**d)


def _remote_worker_cmd() -> List[str]:
    """Spawn command for the port's TCP worker server."""
    return [sys.executable, "-u", "-m", "repro_torch.core.remote_worker"]


def _ssh_worker_cmd(host: "FleetHost") -> List[str]:
    """ssh command whose stdio IS the worker pipe: `_WorkerProc` with a
    remote spawn command.  BatchMode keeps a missing key from hanging
    the fabric on a password prompt."""
    py = host.python or "python3"
    inner = f"{py} -u -m repro_torch.core.worker_main"
    env = f"REPRO_HOST_ALIAS={shlex.quote(host.name)}"
    if host.workdir:
        wd = shlex.quote(host.workdir)
        remote = (f"cd {wd} && env {env} "
                  f"PYTHONPATH={wd}/src:\"$PYTHONPATH\" {inner}")
    else:
        remote = f"env {env} {inner}"
    return ["ssh", "-o", "BatchMode=yes", host.ssh, remote]


class _ServerProc:
    """A spawned loopback ``repro_torch.core.remote_worker`` server: one per
    spawn
    host, shared by all that host's slots.  stderr goes to a temp log
    (torch chatter + diagnostics); the bound port is read from the
    ``READY <port>`` stdout line."""

    def __init__(self, host: "FleetHost", timeout_s: float = 120.0,
                 chaos: Optional[FaultPlan] = None):
        self.host = host
        self.log = tempfile.NamedTemporaryFile(
            mode="w+b", prefix=f"repro-fleet-{host.name}-", suffix=".log",
            delete=False)
        env = _worker_env()
        env["REPRO_HOST_ALIAS"] = host.name
        if chaos is not None:
            chaos.to_env(env)
        self.proc = subprocess.Popen(
            _remote_worker_cmd() + ["--port", "0", "--alias", host.name],
            env=env, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=self.log)
        self.port = self._read_ready(timeout_s)

    def _read_ready(self, timeout_s: float) -> int:
        deadline = time.monotonic() + timeout_s
        fd = self.proc.stdout.fileno()
        buf = b""
        while True:
            nl = buf.find(b"\n")
            if nl >= 0:
                line, buf = buf[:nl], buf[nl + 1:]
                if line.startswith(b"READY "):
                    return int(line.split()[1])
                continue          # chatter on stdout before READY
            wait = deadline - time.monotonic()
            if wait <= 0:
                self.kill()
                raise TimeoutError(
                    f"fleet host {self.host.name}: server not READY "
                    f"within {timeout_s}s")
            ready, _, _ = select.select([fd], [], [], min(wait, 1.0))
            if not ready:
                if self.proc.poll() is not None:
                    raise EOFError(
                        f"fleet host {self.host.name}: server exited "
                        f"{self.proc.poll()} before READY")
                continue
            chunk = os.read(fd, 65536)
            if not chunk:
                raise EOFError(
                    f"fleet host {self.host.name}: server closed stdout "
                    f"before READY (exit={self.proc.poll()})")
            buf += chunk

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        try:
            if self.alive():
                self.proc.terminate()
            self.proc.wait(timeout=5)
        except (OSError, subprocess.TimeoutExpired):
            try:
                self.proc.kill()
            except OSError:
                pass
        for h in (self.proc.stdout, self.log):
            try:
                h.close()
            except OSError:
                pass
        try:
            os.unlink(self.log.name)
        except OSError:
            pass


class RemoteExecutor(SubprocessExecutor):
    """The eval-spec protocol over the network: one campaign saturating
    N hosts.  Slots are ``(host, i)`` pairs; each slot speaks the exact
    line-JSON protocol ``_WorkerProc`` uses over pipes — over a TCP
    connection to a ``repro_torch.core.remote_worker`` server (``socket`` /
    ``spawn`` transports) or over an ssh-piped stdio worker (``ssh``).

    Per-host resolution happens in the spec wire form, not here: a
    host-derived cache/pattern namespace ships as None and is re-derived
    worker-side under the host's ``REPRO_HOST_ALIAS`` (so measured
    records carry the host that timed them and never replay elsewhere),
    and a derived lease path is re-derived per host from ``lease_scope``
    (a lease arbitrates ONE machine's CPUs).  Journals are shared via a
    common filesystem, or — for hosts with ``cache_path`` /
    ``patterns_path`` / ``db_path`` remaps — by the
    ``repro_torch.core.replicate`` tail-ship loop, which pumps O_APPEND lines
    both ways between the scheduler's journals and each host's (both
    stores merge on replay, so replication is just tail-ship + replay).

    Routing is host-affinity-aware (``_AffinityRouter``): jobs on a case
    prefer the host that already built its MEP and holds warm jit/eval
    caches, with cross-host work-stealing so no slot idles."""

    name = "remote"
    persistent = True
    affinity = True

    def __init__(self, hosts: List[Union[str, Dict[str, Any], FleetHost]],
                 *, timeout_s: Optional[float] = None, retries: int = 1,
                 server_timeout_s: float = 120.0,
                 backoff_base_s: float = 0.05, backoff_max_s: float = 2.0,
                 backoff_attempts: int = 4,
                 quarantine_after: int = 3,
                 probe_base_s: float = 0.5, probe_max_s: float = 5.0,
                 chaos: Optional[FaultPlan] = None):
        hosts = [h if isinstance(h, FleetHost) else FleetHost.from_dict(h)
                 for h in hosts]
        if not hosts:
            raise ValueError("RemoteExecutor needs at least one FleetHost")
        names = [h.name for h in hosts]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate fleet host names: {names}")
        for h in hosts:
            if h.transport not in ("spawn", "socket", "ssh"):
                raise ValueError(
                    f"fleet host {h.name}: unknown transport "
                    f"{h.transport!r} (spawn|socket|ssh)")
            if h.transport == "socket" and ":" not in h.address:
                raise ValueError(f"fleet host {h.name}: socket transport "
                                 f"needs address='host:port'")
            if h.transport == "ssh" and not h.ssh:
                raise ValueError(f"fleet host {h.name}: ssh transport "
                                 f"needs ssh='user@host'")
        super().__init__(sum(max(1, h.slots) for h in hosts),
                         timeout_s=timeout_s, retries=retries, chaos=chaos)
        self.hosts: Dict[str, FleetHost] = {h.name: h for h in hosts}
        self.server_timeout_s = server_timeout_s
        # reconnect/backoff knobs: a dead slot connection is
        # re-established under a deterministic exponential schedule
        # instead of staying dead until the next dispatch
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.backoff_attempts = max(0, backoff_attempts)
        # health/quarantine knobs: quarantine_after consecutive faults
        # sideline a host (while ≥1 healthy host remains); probes pace
        # on their own backoff schedule until the host answers a ping
        self.quarantine_after = max(1, quarantine_after)
        self.probe_base_s = probe_base_s
        self.probe_max_s = probe_max_s
        self._servers: Dict[str, _ServerProc] = {}
        self._server_lock = threading.Lock()
        self._host_locks: Dict[str, threading.Lock] = {}
        self._replicator = None       # lazy repro_torch.core.replicate.Replicator
        self._health_lock = threading.Lock()
        self._consec_faults: Dict[str, int] = {}
        self._quarantined: Dict[str, float] = {}   # host → next probe t
        self._probe_idx: Dict[str, int] = {}       # host → probe attempt
        self._rerouted: Dict[str, str] = {}        # case → origin host
        self._ever_connected: set = set()          # slots once connected
        self.reconnects = 0
        self.quarantines = 0
        self.readmissions = 0
        self.reroutes = 0
        # interpreter-exit backstop: spawned servers must die even when
        # a crashed campaign never reaches close().  A weakref keeps
        # atexit's registry from pinning the executor alive.
        ref = weakref.ref(self)

        def _cleanup(ref=ref):
            ex = ref()
            if ex is not None:
                try:
                    ex.close()
                except Exception:  # noqa: BLE001 — interpreter teardown
                    pass
        atexit.register(_cleanup)

    # -- health/fault telemetry ----------------------------------------
    def fleet_events(self) -> Dict[str, int]:
        """Lifetime fault-tolerance counters (journaled by the campaign
        into its ``campaign_end`` record)."""
        with self._health_lock:
            return {"reconnects": self.reconnects,
                    "quarantines": self.quarantines,
                    "readmissions": self.readmissions,
                    "reroutes": self.reroutes}

    def _journal(self, ctx: Optional[WorkerContext], campaign_id: str,
                 kind: str, **fields: Any) -> None:
        if ctx is not None and ctx.db is not None:
            try:
                ctx.db.append(kind, campaign=campaign_id, **fields)
            except OSError:
                pass    # a full disk must not turn degradation into a hang

    def _note_ok(self, slot: Tuple[str, int]) -> None:
        with self._health_lock:
            self._consec_faults[slot[0]] = 0

    def _note_fault(self, slot, job, kind, router, ctx, campaign_id):
        host = slot[0]
        with self._health_lock:
            self._consec_faults[host] = \
                self._consec_faults.get(host, 0) + 1
            n = self._consec_faults[host]
            if host in self._quarantined or n < self.quarantine_after:
                return
            healthy = [h for h in self.hosts
                       if h != host and h not in self._quarantined]
            if not healthy:
                return    # never quarantine the last healthy host
            self._quarantined[host] = time.monotonic()
            self._probe_idx[host] = 0
            self.quarantines += 1
        released = router.release_host(host)
        with self._health_lock:
            for c in set(released) | {job.case.name}:
                self._rerouted[c] = host
        self._journal(ctx, campaign_id, "host_quarantined", host=host,
                      fault=kind, job=job.name, consecutive_faults=n,
                      released_cases=sorted(released))

    def _note_dispatch(self, slot, job, ctx, campaign_id):
        case = job.case.name
        with self._health_lock:
            origin = self._rerouted.pop(case, None)
            if origin is None or origin == slot[0]:
                return
            self.reroutes += 1
        self._journal(ctx, campaign_id, "job_rerouted", job=job.name,
                      case=case, origin=origin, host=slot[0])

    def _probe_delay(self, attempt: int) -> float:
        sched = backoff_schedule(self.probe_base_s, self.probe_max_s,
                                 attempt + 1)
        return sched[-1] if sched else self.probe_base_s

    def _slot_gate(self, slot, router, ctx, campaign_id) -> bool:
        host = slot[0]
        if router.closed:
            return True    # let get() drain and release the slot thread
        with self._health_lock:
            since = self._quarantined.get(host)
            if since is None:
                return True
            attempt = self._probe_idx.get(host, 0)
            due = since + self._probe_delay(attempt)
            wait = due - time.monotonic()
        if wait > 0:
            time.sleep(min(wait, 0.1))
            return False
        # probe: re-establish this slot's connection and ping it.  For a
        # spawn host this respawns the dead server (READY re-handshake
        # in _server_port) — exactly the recovery a readmission needs.
        try:
            with self._slot_lock(slot):
                w = self._ensure_worker(slot, ctx)
                w.send({"ping": True})
                w.recv(min(self.server_timeout_s, 30.0))
        except (TimeoutError, EOFError, OSError, BrokenPipeError,
                ValueError):
            self._replace_worker(slot)
            with self._health_lock:
                if host in self._quarantined:
                    self._probe_idx[host] = \
                        self._probe_idx.get(host, 0) + 1
                    self._quarantined[host] = time.monotonic()
            return False
        with self._health_lock:
            if host not in self._quarantined:
                return True    # another slot's probe already readmitted
            del self._quarantined[host]
            self._probe_idx.pop(host, None)
            self._consec_faults[host] = 0
            self.readmissions += 1
        self._journal(ctx, campaign_id, "host_readmitted", host=host)
        return True

    # -- slots ---------------------------------------------------------
    def _all_slots(self) -> List[Tuple[str, int]]:
        """Host slots interleaved round-robin, so a job list shorter
        than the fleet still spreads across hosts."""
        cols = [[(h.name, i) for i in range(max(1, h.slots))]
                for h in self.hosts.values()]
        out: List[Tuple[str, int]] = []
        depth = max(len(c) for c in cols)
        for i in range(depth):
            out.extend(c[i] for c in cols if i < len(c))
        return out

    def _slots_for(self, ctx: WorkerContext, n_jobs: int
                   ) -> List[Tuple[str, int]]:
        slots = self._all_slots()
        return slots[:max(1, n_jobs)] if n_jobs < len(slots) else slots

    def _slot_host(self, slot: Tuple[str, int]) -> str:
        return slot[0]

    # -- per-host spec rewriting ---------------------------------------
    def _spec_for_slot(self, spec: Dict[str, Any],
                       slot: Tuple[str, int]) -> Dict[str, Any]:
        host = self.hosts[slot[0]]
        if not (host.cache_path or host.patterns_path or host.db_path):
            return spec            # shared filesystem: nothing to remap
        spec = dict(spec)
        if host.cache_path and spec.get("cache"):
            spec["cache"] = dict(spec["cache"], path=host.cache_path)
            if spec.get("lease_scope"):
                # the derived lease keys on the cache path: keep the
                # worker's re-derivation anchored to ITS journal file
                spec["lease_scope"] = dict(spec["lease_scope"],
                                           cache=host.cache_path)
        if host.patterns_path and spec.get("patterns"):
            spec["patterns"] = dict(spec["patterns"],
                                    path=host.patterns_path)
        if host.db_path and spec.get("db"):
            spec["db"] = host.db_path
        return spec

    # -- journal replication -------------------------------------------
    def _ensure_replicator(self, ctx: WorkerContext):
        pairs: List[Tuple[str, str]] = []
        for h in self.hosts.values():
            if h.cache_path and ctx.cache is not None and ctx.cache.path:
                pairs.append((ctx.cache.path, h.cache_path))
            if h.patterns_path and ctx.patterns is not None \
                    and ctx.patterns.path:
                pairs.append((ctx.patterns.path, h.patterns_path))
            if h.db_path and ctx.db is not None:
                pairs.append((ctx.db.path, h.db_path))
        if not pairs:
            return None
        with self._server_lock:
            if self._replicator is None:
                from repro_torch.core.replicate import Replicator
                self._replicator = Replicator()
                self._replicator.start()
            for a, b in pairs:
                self._replicator.add(a, b)
        return self._replicator

    def run(self, jobs, ctx, *, campaign_id="", stop=None):
        with self._health_lock:
            self._rerouted.clear()
        repl = self._ensure_replicator(ctx)
        try:
            return super().run(jobs, ctx, campaign_id=campaign_id,
                               stop=stop)
        finally:
            if repl is not None:
                # final drain: every append a host made during the
                # campaign is home before the scheduler reads winners
                repl.pump()
                if ctx.cache is not None:
                    ctx.cache.reload()
                if ctx.patterns is not None and ctx.patterns.path:
                    ctx.patterns.reload()

    # -- transports ----------------------------------------------------
    def _server_port(self, host: FleetHost) -> int:
        # one lock a host: hosts' servers start side by side
        with self._server_lock:
            lock = self._host_locks.setdefault(host.name, threading.Lock())
        with lock:
            with self._server_lock:
                srv = self._servers.get(host.name)
            if srv is None or not srv.alive():
                if srv is not None:
                    srv.kill()
                srv = _ServerProc(host, timeout_s=self.server_timeout_s,
                                  chaos=self.chaos)
                with self._server_lock:
                    self._servers[host.name] = srv
            return srv.port

    def _connect(self, slot: Tuple[str, int]):
        host = self.hosts[slot[0]]
        if host.transport == "ssh":
            return _WorkerProc(_ssh_worker_cmd(host), dict(os.environ),
                               slot)
        if host.transport == "socket":
            address = host.address
        elif host.transport == "spawn":
            address = f"127.0.0.1:{self._server_port(host)}"
        else:
            raise ValueError(f"fleet host {host.name}: unknown transport "
                             f"{host.transport!r} (spawn|socket|ssh)")
        return _SocketWorker(address, slot,
                             connect_timeout_s=host.connect_timeout_s)

    def _ensure_worker(self, slot: Tuple[str, int],
                       ctx: Optional[WorkerContext]):
        # connect OUTSIDE self._lock: a slow server start must not block
        # other hosts' slots (the per-slot protocol lock in dispatch()
        # already serializes re-entry for this slot)
        with self._lock:
            w = self._procs.get(slot)
            if w is not None and w.alive():
                return w
        # reconnect with deterministic exponential backoff: a spawn
        # server mid-restart (or a standing server bouncing) answers a
        # later attempt, so one blip doesn't burn a whole job retry
        delays = backoff_schedule(self.backoff_base_s, self.backoff_max_s,
                                  self.backoff_attempts)
        last: Optional[BaseException] = None
        w = None
        for i in range(len(delays) + 1):
            try:
                w = self._connect(slot)
                break
            except (EOFError, TimeoutError, OSError) as e:
                last = e        # _ConnectError is an OSError subclass
                if i < len(delays):
                    time.sleep(delays[i])
        if w is None:
            raise _ConnectError(
                f"slot {slot}: connect failed after "
                f"{len(delays) + 1} attempts: {last}") from last
        with self._health_lock:
            if slot in self._ever_connected:
                self.reconnects += 1
            else:
                self._ever_connected.add(slot)
        with self._lock:
            self._procs[slot] = w
        return w

    def warm(self, slots=None, timeout_s: float = 120.0) -> None:
        super().warm(self._all_slots() if slots is None else slots,
                     timeout_s)

    def _start_all(self, slots) -> None:
        """Start the spawn hosts' servers side by side (each waits for its
        own ``READY``); connections are made by the pings."""
        names = {s[0] for s in slots
                 if self.hosts[s[0]].transport == "spawn"}
        threads = [threading.Thread(target=self._try_server,
                                    args=(self.hosts[n],), daemon=True)
                   for n in sorted(names)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def _try_server(self, host: FleetHost) -> None:
        try:
            self._server_port(host)
        except (EOFError, TimeoutError, OSError):
            pass          # the ping's connect path retries and reports

    def close(self) -> None:
        with self._server_lock:
            repl, self._replicator = self._replicator, None
        if repl is not None:
            repl.stop()           # stop() takes a final drain pump
        super().close()           # closes slot connections / ssh pipes
        with self._server_lock:
            servers, self._servers = list(self._servers.values()), {}
        for srv in servers:
            srv.kill()


def make_executor(kind: Optional[str], *, workers: Optional[int] = None,
                  timeout_s: Optional[float] = None,
                  hosts: Optional[List[Any]] = None) -> Executor:
    """Executor factory behind the ``--executor=`` / ``executor=`` knobs
    (None → REPRO_CAMPAIGN_EXECUTOR, default in-process).  ``remote``
    takes its fleet from ``hosts`` (FleetHost / dict / name strings) or
    the ``REPRO_FLEET_HOSTS`` env var (a JSON list of the same)."""
    if kind is None:
        kind = os.environ.get("REPRO_CAMPAIGN_EXECUTOR", "inprocess")
    kind = kind.replace("_", "-")
    if kind in ("inprocess", "in-process", "thread"):
        if workers is None:
            workers = int(os.environ.get("REPRO_CAMPAIGN_WORKERS", "4"))
        return InProcessExecutor(workers)
    if kind == "subprocess":
        return SubprocessExecutor(workers, timeout_s=timeout_s)
    if kind in ("local-cluster", "cluster"):
        return LocalClusterExecutor(workers, timeout_s=timeout_s)
    if kind in ("remote", "fleet"):
        if hosts is None:
            env = os.environ.get("REPRO_FLEET_HOSTS", "")
            if not env:
                raise ValueError(
                    "remote executor needs hosts=[...] or "
                    "REPRO_FLEET_HOSTS (JSON list of FleetHost dicts "
                    "or name strings)")
            hosts = json.loads(env)
        return RemoteExecutor(hosts, timeout_s=timeout_s)
    raise ValueError(f"unknown executor {kind!r}; choose from "
                     f"inprocess, subprocess, local-cluster, remote")


# ---------------------------------------------------------------------------
# worker process entry point (``python -m repro_torch.core.worker_main``)
# ---------------------------------------------------------------------------
def _apply_inject(inject: Dict[str, Any]) -> None:
    """Test-only fault hooks: ``crash`` exits immediately;
    ``crash_once_flag`` crashes only if the flag file is absent (creating
    it first, so the retried attempt on the replacement worker succeeds);
    ``sleep_s`` stalls mid-eval to exercise the timeout path."""
    if inject.get("crash"):
        os._exit(int(inject.get("exit_code", 41)))
    flag = inject.get("crash_once_flag")
    if flag:
        if not os.path.exists(flag):
            with open(flag, "w") as f:
                f.write("crashed once\n")
            os._exit(int(inject.get("exit_code", 42)))
    if inject.get("sleep_s"):
        time.sleep(float(inject["sleep_s"]))


# ---------------------------------------------------------------------------
# launch log: what a worker launched, outside the spec wire
# ---------------------------------------------------------------------------
LAUNCH_LOG_ENV = "REPRO_LAUNCH_LOG"
# kernel wrapper → (module, attribute); a wrapper counts its own launches
_KERNELS = {"matmul": ("repro_torch.kernels.matmul", "matmul"),
            "flash_attention": ("repro_torch.kernels.flash_attention",
                                "flash_attention"),
            "wkv": ("repro_torch.kernels.rwkv_wkv", "wkv"),
            "ssd": ("repro_torch.kernels.ssd_scan", "ssd"),
            "reduce_sum": ("repro_torch.kernels.reduce_sum", "reduce_sum"),
            "elementwise": ("repro_torch.kernels.elementwise",
                            "elementwise"),
            "grouped_matmul": ("repro_torch.kernels.moe_gemm",
                               "grouped_matmul")}


def _loaded_kernels() -> Dict[str, Any]:
    """The kernel wrappers this process has imported, by name."""
    out = {}
    for name, (mod, attr) in _KERNELS.items():
        m = sys.modules.get(mod)
        if m is not None:
            out[name] = getattr(m, attr)
    return out


def _launch_counts() -> Dict[str, Dict[str, int]]:
    return {name: {"total": int(fn.launches),
                   **{b: int(n) for b, n in
                      getattr(fn, "launches_by_path", {}).items()}}
            for name, fn in _loaded_kernels().items()}


def _signature(args, kw) -> str:
    """A kernel call as JSON: each tensor argument's shape, strides and
    dtype, every other argument as given."""
    def one(x):
        if hasattr(x, "shape") and hasattr(x, "stride"):
            return {"shape": list(x.shape), "stride": list(x.stride()),
                    "dtype": str(x.dtype).replace("torch.", "")}
        return x
    return json.dumps({"args": [one(a) for a in args],
                       "kw": {k: one(v) for k, v in sorted(kw.items())}},
                      default=str)


class _LaunchLog:
    """Per-job kernel launches and the distinct calls the case suites
    made of each kernel, appended as one JSONL line to the file
    ``REPRO_LAUNCH_LOG`` names.  Calls are seen through shims put where
    the suites look a wrapper up; the wrappers' own counters count as
    before, and a call the wrapper refused is not kept.  Launches are
    also split by the device-lease hold they fell in (``probe``, ``fe``,
    ``time``, ``ref``); on the card none may fall outside a hold."""

    def __init__(self, path: str):
        from repro_torch.core.measure import HOLD_LISTENERS
        self.path = path
        self._lock = threading.Lock()
        self._calls: Dict[str, set] = {}
        self._shimmed: set = set()
        self._by_hold: Dict[str, Dict[str, int]] = {}
        self._at_enter: Dict[str, Dict[str, int]] = {}
        HOLD_LISTENERS.append(self._hold)

    def _hold(self, what: str, entering: bool) -> None:
        # the holder is the only thread on the card: the counters' moves
        # between its enter and exit are its hold's launches
        counts = {name: int(fn.launches)
                  for name, fn in _loaded_kernels().items()}
        if entering:
            self._at_enter = counts
            return
        acc = self._by_hold.setdefault(what or "other", {})
        for name, n in counts.items():
            acc[name] = acc.get(name, 0) + n - self._at_enter.get(name, 0)

    def _shim(self) -> None:
        wrappers = {id(fn): name for name, fn in _loaded_kernels().items()}
        for mname, mod in list(sys.modules.items()):
            if not mname.startswith("repro_torch.kernels.suites.") \
                    or mname in self._shimmed or mod is None:
                continue
            self._shimmed.add(mname)
            for attr, fn in list(vars(mod).items()):
                name = wrappers.get(id(fn))
                if name is not None:
                    setattr(mod, attr, self._recorder(name, fn))

    def _recorder(self, name: str, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            sig = _signature(args, kw)
            with self._lock:
                self._calls.setdefault(name, set()).add(sig)
            return out
        return call

    def begin(self) -> Dict[str, Dict[str, int]]:
        self._shim()
        with self._lock:
            self._calls = {}
            self._by_hold = {}
        return _launch_counts()

    def end(self, before, spec: Dict[str, Any], seconds: float) -> None:
        after = _launch_counts()
        delta = {name: {k: n - before.get(name, {}).get(k, 0)
                        for k, n in counts.items()}
                 for name, counts in after.items()}
        with self._lock:
            calls = {name: [json.loads(c) for c in sorted(sigs)]
                     for name, sigs in self._calls.items()}
        job = spec.get("job") or {}
        append_jsonl(self.path, json_safe({
            "pid": os.getpid(), "host": this_host(),
            "campaign": spec.get("campaign", ""),
            "job": job.get("label") or (job.get("case") or {}).get("name"),
            "case": (job.get("case") or {}).get("name"),
            "seconds": seconds, "launches": delta,
            "launches_by_hold": self._by_hold, "calls": calls}))


class _SpecServer:
    """The worker-side spec interpreter, shared by every transport: one
    instance per worker *process*, handling eval specs one
    ``handle(spec) → reply`` call at a time (or concurrently, from the
    remote server's connection threads).  Platform/cache/store/db
    handles are memoized per spec coordinates so a long-lived process
    serving many jobs keeps its warm caches."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._platforms: Dict[str, Platform] = {}
        self._caches: Dict[Tuple, EvalCache] = {}
        self._stores: Dict[Tuple, PatternStore] = {}
        self._dbs: Dict[str, ResultsDB] = {}
        # scripted fault injection (repro_torch.core.chaos): None outside
        # the chaos harness — REPRO_CHAOS reaches spawned workers via the
        # executor env stamp, a standing server via its own environment
        self._chaos = ChaosInjector.from_env()
        log = os.environ.get(LAUNCH_LOG_ENV, "")
        self._launch_log = _LaunchLog(log) if log else None

    def handle_with_faults(self, spec: Dict[str, Any]
                           ) -> Tuple[Dict[str, Any], List[Any]]:
        """``(reply, drop_faults)``: fire any scripted faults due for
        this spec (kill/stall/poison happen here, in place), then handle
        it.  The returned ``drop_connection`` faults are for the
        transport to honor at reply time — only the TCP server can tear
        a line mid-send; stdio callers use ``handle`` and ignore them."""
        drops = self._chaos.fire(spec) if self._chaos is not None else []
        return self.handle(spec), drops

    def handle(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        try:
            if spec.get("ping"):
                return {"ok": True, "pong": True, "host": this_host()}
            _apply_inject(spec.get("inject") or {})
            job, scale = job_from_spec(spec)
            pname = spec["platform"]
            with self._lock:
                if pname not in self._platforms:
                    # a card platform raises here without a GPU: the
                    # error goes back as the job's outcome
                    self._platforms[pname] = platform_from_name(pname)
                platform = self._platforms[pname]
                cache = None
                if spec.get("cache"):
                    c = spec["cache"]
                    ck = (c["path"], c.get("ns"), c.get("ttl_s"))
                    if ck not in self._caches:
                        self._caches[ck] = EvalCache(
                            c["path"], namespace=c.get("ns"),
                            ttl_s=c.get("ttl_s"))
                    cache = self._caches[ck]
                patterns = None
                if spec.get("patterns"):
                    ps = spec["patterns"]
                    sk = (ps["path"], ps.get("ns"))
                    if sk not in self._stores:
                        self._stores[sk] = PatternStore.from_spec(ps)
                    patterns = self._stores[sk]
                db = None
                if spec.get("db"):
                    db = self._dbs.setdefault(spec["db"],
                                              ResultsDB(spec["db"]))
            stop_event = threading.Event()
            if spec.get("stop"):
                stop_event.set()
            measure = MeasureConfig.from_dict(spec["measure"]) \
                if spec.get("measure") else None
            pop_cfg = PopulationConfig.from_dict(spec["population"]) \
                if spec.get("population") else None
            log = self._launch_log
            before = log.begin() if log is not None else None
            t0 = time.perf_counter()
            res = run_case_job(
                job, platform, campaign_id=spec.get("campaign", ""),
                cache=cache, patterns=patterns, db=db,
                stop_event=stop_event,
                verbose=spec.get("verbose", False), scale=scale,
                measure=measure, lease_path=lease_for_spec(spec),
                population=pop_cfg)
            if log is not None:
                log.end(before, spec, time.perf_counter() - t0)
            return {"ok": True, "result": res.to_dict(full=True)}
        except Exception as e:  # noqa: BLE001 — job errors go to scheduler
            import traceback
            return {"ok": False, "type": type(e).__name__,
                    "error": f"{e}"[:1000],
                    "traceback": traceback.format_exc()[-2000:]}


def serve_stdio(proto) -> int:
    """Line-JSON worker loop over stdio: read an eval spec from stdin,
    run the §3.2 search for its job, write the full OptResult (or an
    error record) to ``proto``, the protocol channel."""
    server = _SpecServer()
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            spec = json.loads(line)
        except ValueError as e:
            reply: Dict[str, Any] = {"ok": False, "type": "ProtocolError",
                                     "error": f"{e}"[:1000]}
        else:
            # drop_connection faults are TCP-only; over pipes they are
            # collected and ignored (the pipe can't tear a line cleanly)
            reply, _ = server.handle_with_faults(spec)
        proto.write(json.dumps(json_safe(reply), default=str) + "\n")
        proto.flush()
    return 0


def worker_main() -> int:
    """Line-JSON worker loop over stdio (the socket transport runs the
    same ``_SpecServer`` behind ``repro_torch.core.remote_worker``)."""
    from repro_torch.core.worker_main import protocol_channel
    return serve_stdio(protocol_channel())
