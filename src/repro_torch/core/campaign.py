"""Campaign engine: concurrent multi-kernel optimization (paper §3.2).

Port of ``repro.core.campaign`` for the in-process executor.  A campaign
runs the paper's §3.2 round structure over many ``KernelCase``s:

    for each case (over an evaluation executor):
        d = 0..D-1:                                  eq. 5 outer loop
            re-read inherited hints from the PatternStore (PPI)
            propose N candidates from K^(d)          (heuristic / direct)
            evaluate each: build → FE → time         eq. 3–4, AER-wrapped
            K^(d+1) = argmin over the feasible set   eq. 5
            record the round's win into the PatternStore
            stop when the round's gain ≤ 1 + eps     (uniform early stop)

``Campaign`` is the scheduler half: it owns the shared evaluation cache,
pattern store and results journal, and hands the per-case search to an
``Executor`` (``repro_torch.core.workers``).  Measured platforms serialise
their timed slices on a timing lease next to the eval cache.

On a measured CUDA platform (``h100``) the campaign runs one job at a
time: every thread launches on the device's default stream, so a
concurrent job's FE kernels would land inside another job's timed
CUDA-event window, which the lease (timed slices only) cannot prevent.
Concurrent jobs on the card wait for per-worker streams or processes
(ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import os
import time
from typing import List, Optional, Union

from repro_torch.core.evalcache import EvalCache, ResultsDB
from repro_torch.core.measure import MeasureConfig, default_lease_path
from repro_torch.core.optimizer import OptResult
from repro_torch.core.patterns import PatternStore
from repro_torch.core.profiler import Platform
from repro_torch.core.workers import (CaseJob, InProcessExecutor,
                                      WorkerContext)

__all__ = ["Campaign", "CaseJob"]


class Campaign:
    """Scheduler that optimizes many kernels with a shared evaluation
    cache, pattern store, and results journal."""

    def __init__(self, platform: Platform, *,
                 patterns: Union[PatternStore, str, None] = None,
                 cache: Optional[EvalCache] = None,
                 db: Optional[ResultsDB] = None,
                 max_workers: int = 4,
                 measure: Optional[MeasureConfig] = None):
        self.platform = platform
        if isinstance(patterns, str):
            patterns = PatternStore(patterns)
        self.patterns = patterns
        self.cache = cache
        self.db = db
        self.measure = measure
        measured = not getattr(platform, "concurrency_safe", False)
        # measured platforms time under one lease file, next to the eval
        # cache when it has a file, else keyed by this process
        self.lease_path = default_lease_path(
            cache.path if cache is not None else None,
            scope=str(os.getpid())) if measured else None
        if measured and str(getattr(platform, "device", "")).startswith(
                "cuda"):
            max_workers = 1          # one default stream: see the docstring
        self.max_workers = max(1, max_workers)
        self.executor = InProcessExecutor(self.max_workers)

    # ------------------------------------------------------------------
    def run(self, jobs: List[CaseJob]) -> List[OptResult]:
        """Run all jobs; the result list matches the job order.

        One failing job does not abort the others: every job runs to
        completion, the journal gets its campaign_end record either way,
        and only then is the first failure re-raised."""
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
                            measure=self.measure, lease_path=self.lease_path)
        outcomes = self.executor.run(jobs, ctx, campaign_id=campaign_id)
        failures = [(j, o) for j, o in zip(jobs, outcomes)
                    if isinstance(o, Exception)]
        oks = [o for o in outcomes if isinstance(o, OptResult)]
        if self.db:
            self.db.append(
                "campaign_end", id=campaign_id,
                wall_s=round(time.time() - t0, 3),
                cache=self.cache.stats() if self.cache else None,
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
