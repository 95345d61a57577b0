"""Campaign engine: concurrent multi-kernel optimization (paper §3.2).

The paper optimizes one hotspot at a time inside its MEP; a *campaign*
runs the same §3.2 round structure over many ``KernelCase``s at once:

    for each case (concurrently, over an evaluation executor):
        d = 0..D-1:                                  eq. 5 outer loop
            re-read inherited hints from the PatternStore (PPI)
            propose N candidates from K^(d)          (LLM / heuristic)
            evaluate each: build → FE → time         eq. 3–4, AER-wrapped
            K^(d+1) = argmin over the feasible set   eq. 5
            record the round's win into the PatternStore
            stop when the round's gain ≤ 1 + eps     (uniform early stop)

    The PatternStore is the flock-journaled multi-process store
    (``repro_torch.core.patterns``): wins recorded by one case — in this
    process or a subprocess worker — reach every concurrent case's
    next round, and a ``patterns="path.jsonl"`` string opens the
    persistent store shared with out-of-process workers.

``Campaign`` is the *scheduler* half: it owns the shared evaluation
cache, pattern store, and results journal, and hands the per-case search
to an ``Executor`` (``repro_torch.core.workers``) — it never touches an MEP
itself.  Three transports share one code path:

* ``InProcessExecutor``   (default) — bounded thread pool.
* ``SubprocessExecutor``  — one MEP per worker process; jobs ship as
  serialized eval specs, the JSONL cache/journal on shared storage are
  the only shared state (advisory file locks keep cross-process
  in-flight dedup intact).
* ``LocalClusterExecutor`` — persistent subprocess workers.

Measured (wall-clock) platforms fan out like analytic ones: the
campaign owns a **timing lease** (an flock'd arbiter file next to the
eval cache, see ``repro_torch.core.measure``) that serializes only the actual
wall-clock slices across every thread and worker process, so eq. 3's
trimmed mean stays clean while build/compile/FE/LLM work overlaps.
``measure=MeasureConfig(...)`` sets the campaign-wide adaptive
measurement policy (CI-based early stop under the eq. 3 R cap,
incumbent racing); per-job ``OptConfig.measure`` overrides it.

Select with ``executor=`` (an ``Executor``, or a kind string:
``inprocess`` / ``subprocess`` / ``local-cluster``), or the
REPRO_CAMPAIGN_EXECUTOR / REPRO_CAMPAIGN_WORKERS environment knobs.

Shared-state guarantees, regardless of transport:

* **Shared evaluation cache** — every build/FE/time outcome is
  content-addressed in an ``EvalCache`` keyed by the full evaluation
  spec, so duplicate candidates (across proposers, cases, rounds, or a
  previous campaign run against the same cache file) are never paid for
  twice.  In-flight dedup means two workers racing on the same key do
  the work once — across threads and across processes.
* **MEP dedup** — in-process jobs that target the same (case, platform,
  seed, constraints, scale) share one MEP; each worker process builds
  its own (one MEP per worker process).
* **Persistent results DB** — campaign_start / round / case_result /
  worker_fault / campaign_end records are journaled to JSONL
  (``ResultsDB``) so a campaign's trajectory survives restarts and backs
  the BENCH_* snapshots compared across PRs.

``repro_torch.core.optimizer.optimize`` remains the serial API: it is a
one-case campaign with ``max_workers=1`` and no cache unless given one.

Port of ``repro.core.campaign``.  On the card, an in-process campaign on a
measured CUDA platform (``h100``, ``h100-torch``) runs one job at a time —
its threads share one CUDA context, so a concurrent job's FE kernels
would land inside another job's timed CUDA-event window.  Out-of-process
executors fan out there: each worker holds the card's device lease
(``measure.DeviceLease``) over every stretch of its device work, so no
two workers' device work overlaps and every timed window is the card's
alone.  Within a job, a population wave's LLM personae may run in
threads, which only wait on the batcher.  An executor the campaign makes
itself (from a kind string or the environment) is its own and is closed
at the end of each ``run``: its workers' CUDA contexts go back to the
card; a caller's executor stays up for the caller to close.
"""
from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Union

from repro_torch.core.evalcache import EvalCache, ResultsDB
from repro_torch.core.measure import MeasureConfig, default_lease_path
from repro_torch.core.optimizer import OptResult
from repro_torch.core.patterns import PatternStore
from repro_torch.core.profiler import Platform
from repro_torch.core.population import PopulationConfig
from repro_torch.core.workers import (CaseJob, Executor, InProcessExecutor,
                                WorkerContext, make_executor)

__all__ = ["Campaign", "CaseJob"]


class Campaign:
    """Scheduler that optimizes many kernels concurrently with shared
    evaluation cache, pattern store, and results journal, over a
    pluggable evaluation executor."""

    def __init__(self, platform: Platform, *,
                 patterns: Union[PatternStore, str, None] = None,
                 cache: Optional[EvalCache] = None,
                 db: Optional[ResultsDB] = None,
                 max_workers: Optional[int] = None,
                 executor: Union[Executor, str, None] = None,
                 measure: Optional[MeasureConfig] = None,
                 lease_path: Optional[str] = None,
                 population: Optional[PopulationConfig] = None,
                 verbose: bool = False):
        self.platform = platform
        if isinstance(patterns, str):
            # a path opens the persistent multi-process journal store —
            # the form out-of-process executors can ship to workers
            patterns = PatternStore(patterns)
        self.patterns = patterns
        self.cache = cache
        self.db = db
        self.measure = measure
        # campaign-wide population-search policy (per-job
        # OptConfig.population overrides it); None → greedy loop
        self.population = population
        # measured platforms fan out (no one-worker clamp any more):
        # all wall-clock slices — every thread, every worker process —
        # serialize on one lease file, by default next to the eval
        # cache.  The cache-less fallback is keyed by pid only: every
        # campaign this scheduler process creates (e.g. the autotuner's
        # repeated cycles) shares ONE lease file and ONE registry entry
        # — timing contends for the same CPUs whichever campaign owns it
        # lease_scope records the derivation coordinates when WE derived
        # the path (vs caller-pinned): the spec wire form ships them so
        # fleet workers on other hosts re-resolve the lease against
        # their own hostname — a lease arbitrates one machine's CPUs
        self.lease_scope = None
        if lease_path is None and not getattr(platform,
                                              "concurrency_safe", False):
            cache_path = cache.path if cache is not None else None
            scope = str(os.getpid())
            lease_path = default_lease_path(cache_path, scope=scope)
            self.lease_scope = {"cache": cache_path, "scope": scope}
        self.lease_path = lease_path
        self.verbose = verbose
        if max_workers is None:
            max_workers = int(os.environ.get("REPRO_CAMPAIGN_WORKERS", "4"))
        self.max_workers = max(1, max_workers)
        self.owns_executor = not isinstance(executor, Executor)
        if executor is None:
            kind = os.environ.get("REPRO_CAMPAIGN_EXECUTOR", "inprocess")
            executor = InProcessExecutor(self.max_workers) \
                if kind in ("inprocess", "in-process", "thread") \
                else make_executor(kind, workers=self.max_workers)
        elif isinstance(executor, str):
            executor = make_executor(executor, workers=self.max_workers)
        if isinstance(executor, InProcessExecutor) \
                and not getattr(platform, "concurrency_safe", False) \
                and str(getattr(platform, "device", "")).startswith("cuda"):
            # one CUDA context: see the module docstring
            executor.max_workers = self.max_workers = 1
        self.executor = executor

    # ------------------------------------------------------------------
    def run(self, jobs: List[CaseJob], *,
            stop: Optional[threading.Event] = None) -> List[OptResult]:
        """Run all jobs; the result list matches the job order.

        One failing job does not abort the others: every job runs to
        completion, the journal gets its campaign_end record either way,
        and only then is the first failure re-raised.

        ``stop`` makes the campaign interruptible: a background owner
        (the serve-layer autotuner) sets the event and every in-process
        job winds down at its next round boundary, returning a
        partial-but-valid OptResult (``stop_reason="stop requested"``);
        out-of-process jobs already dispatched run to completion, while
        queued ones return immediately-stopped results.  Because every
        evaluation went through the shared EvalCache, re-running the
        same jobs later resumes where the stopped campaign left off —
        completed rounds replay as cache hits."""
        campaign_id = f"c{os.getpid():x}-{int(time.time() * 1e3):x}"
        t0 = time.time()
        if self.db:
            self.db.append("campaign_start", id=campaign_id,
                           platform=self.platform.name,
                           workers=self.max_workers,
                           executor=self.executor.name,
                           jobs=[j.name for j in jobs])

        ctx = WorkerContext(platform=self.platform, cache=self.cache,
                            patterns=self.patterns, db=self.db,
                            verbose=self.verbose, measure=self.measure,
                            lease_path=self.lease_path,
                            lease_scope=self.lease_scope,
                            population=self.population)
        try:
            outcomes = self.executor.run(jobs, ctx, campaign_id=campaign_id,
                                         stop=stop)
        finally:
            if self.owns_executor:
                self.executor.close()
        failures = [(j, o) for j, o in zip(jobs, outcomes)
                    if isinstance(o, Exception)]
        oks = [o for o in outcomes if isinstance(o, OptResult)]
        fleet_events = getattr(self.executor, "fleet_events", None)
        if self.db:
            self.db.append(
                "campaign_end", id=campaign_id,
                wall_s=round(time.time() - t0, 3),
                cache=self.cache.stats() if self.cache else None,
                # fleet fault-tolerance counters (RemoteExecutor only):
                # reconnects / quarantines / readmissions / reroutes
                fleet=fleet_events() if callable(fleet_events) else None,
                # campaign-level PPI health: how many inherited hints
                # were suggested vs. actually landed in round winners
                hints_suggested=sum(o.hints_suggested for o in oks),
                hints_accepted=sum(o.hints_accepted for o in oks),
                results=[o.to_dict() for o in oks],
                errors=[{"job": j.name,
                         "error": f"{type(e).__name__}: {e}"[:300]}
                        for j, e in failures])
        if failures:
            job, err = failures[0]
            raise RuntimeError(
                f"campaign job {job.name!r} failed "
                f"({len(failures)}/{len(jobs)} jobs failed)") from err
        return outcomes
