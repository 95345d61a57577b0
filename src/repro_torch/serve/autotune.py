"""Online serving autotuner: background campaigns hot-swap winners into
the ops registry.

Port of ``repro.serve.autotune``.  The paper's final stage reintegrates
MEP-optimized variants into the full application once, offline.  This
module closes that loop *continuously* against live serving traffic:

    telemetry → campaign → guarded install → (rollback)

1. **Telemetry**: the ``BatchedServer`` reports every prefill/decode
   event to the per-site telemetry in ``repro_torch.kernels.ops``; the
   autotuner reads traffic-weighted scale statistics from it, so it
   optimizes the workload actually observed — not a fixed benchmark grid.
2. **Campaign**: each cycle, hot sites are mapped to their extracted
   ``KernelCase``s (``app_site``), MEPs are pinned to the snapped
   observed scale, and a ``Campaign`` runs the paper's §3.2 loop over
   them with the shared ``EvalCache``/``ResultsDB`` — so repeated cycles
   replay cached evaluations and cost almost nothing once traffic is
   stable.
3. **Guarded install**: winners that beat the incumbent by more than
   ``improve_eps`` go through ``core.integrate.guarded_install`` — FE
   checked at the observed scale before touching the registry, probed
   afterwards, rolled back to the prior registry generation if the
   integrated step regresses or diverges.  The serving loop picks the swap
   up at its next step boundary (a "swap epoch", where a graph server
   re-captures) without interrupting in-flight requests.

The whole loop runs on a daemon thread (``start``/``stop``); ``run_once``
is the synchronous building block.  A cycle's campaign, FE checks and
probes run under ``device.DEVICE_LOCK``, which a ``BatchedServer`` holds
while it captures its CUDA graphs: the two never touch the card at once.

Differences from the JAX package: an install goes through
``guarded_install(..., impl=platform.impl)``, the build the winner was
timed on (as ``integrate.integrated_speedup`` installs it); the default
probe's fallback is the baseline's ``torch`` build, its inputs on the
platform's device.  ``config.executor`` takes every kind ``make_executor``
knows; an out-of-process fabric runs the campaign in worker processes
(which on the card hold its device lease over their device work), while
``guarded_install``'s FE and probes stay in the serving process.
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core import datagen
from repro_torch.core.campaign import Campaign
from repro_torch.core.evalcache import EvalCache, ResultsDB
from repro_torch.core.fe import as_tensors
from repro_torch.core.integrate import GuardedInstall, guarded_install
from repro_torch.core.kernelcase import KernelCase, cases
from repro_torch.core.measure import MeasureConfig
from repro_torch.core.mep import MEPConstraints, build_mep
from repro_torch.core.optimizer import OptConfig, OptResult
from repro_torch.core.patterns import PatternStore
from repro_torch.core.profiler import Platform
from repro_torch.core.proposer import HeuristicProposer, Proposer
from repro_torch.core.workers import CaseJob, make_executor
from repro_torch.device import DEVICE_LOCK
from repro_torch.kernels import ops

@dataclass
class AutotuneConfig:
    interval_s: float = 30.0       # pause between background cycles
    min_tokens: int = 256          # site is "hot" after this much traffic
    max_sites: int = 4             # top-k hottest sites per cycle
    opt: OptConfig = field(default_factory=lambda: OptConfig(
        d_rounds=3, n_candidates=3, r=5, k=1))
    constraints: MEPConstraints = field(default_factory=lambda:
                                        MEPConstraints(r=5, k=1, t_max_s=2.0))
    improve_eps: float = 0.01      # install only winners beating this gain
    max_regression: float = 0.25   # guard: rollback beyond this slowdown
    atol: float = 5e-2             # guard: rollback beyond this divergence
    probe_r: int = 3               # probe repetitions (trimmed mean)
    probe_k: int = 0
    install: bool = True           # False = observe-and-campaign dry run
    seed: int = 0
    # evaluation fabric: None → in-process policy default; "subprocess" /
    # "local-cluster" / "remote" move MEP evaluation out of the serving
    # process so background campaigns never contend with request threads
    # for the GIL
    executor: Optional[str] = None
    workers: Optional[int] = None  # fabric width (None → env/policy)
    # persistent Performance Pattern Inheritance store (JSONL journal
    # path): campaign wins survive restarts and — because the store is
    # multi-process safe — flow to out-of-process campaign workers
    patterns: Optional[str] = None
    # adaptive measurement policy (None → engine defaults: CI-stopped
    # reps under the eq. 3 R cap + incumbent racing); the campaign adds
    # the cross-process timing lease, so measured platforms fan out
    # across autotune workers
    measure: Optional[MeasureConfig] = None


def snap_scale(case: KernelCase, observed: int) -> int:
    """Nearest scale the case supports to the observed traffic scale
    (ties resolve to the smaller — cheaper — scale)."""
    return min(case.scales, key=lambda s: (abs(s - int(observed)), s))


def bucket_key(site: str, bucket: Optional[int] = None) -> str:
    """Composite telemetry-site key: per-bucket traffic shows up as
    ``site@b<bucket>`` so each (site, bucket) pair is a distinct campaign
    site; bucket-less traffic keeps the bare site name."""
    return site if bucket is None else f"{site}@b{int(bucket)}"


def split_bucket_key(key: str) -> Tuple[str, Optional[int]]:
    """Inverse of ``bucket_key``: -> (site, bucket-or-None)."""
    site, sep, b = key.rpartition("@b")
    if sep and b.isdigit():
        return site, int(b)
    return key, None


@dataclass
class AutotuneReport:
    """One cycle's outcome: what was hot, what the campaign found, what
    was swapped (or rolled back)."""
    cycle: int
    hot: Dict[str, int] = field(default_factory=dict)   # site -> scale
    results: List[OptResult] = field(default_factory=list)
    swaps: List[GuardedInstall] = field(default_factory=list)
    skipped: str = ""
    wall_s: float = 0.0

    @property
    def installed(self) -> List[GuardedInstall]:
        return [s for s in self.swaps if s.active]

    @property
    def rolled_back(self) -> List[GuardedInstall]:
        return [s for s in self.swaps if s.rolled_back]


class ServeAutotuner:
    """Background optimization loop over the serving hotspots.

    One instance owns a stop event shared by the loop thread and any
    in-flight campaign: ``stop()`` interrupts a running campaign at its
    next round boundary (partial results stay valid and cached), then the
    thread exits.  Sites already tuned at their observed scale are
    skipped in later cycles until their traffic-weighted scale drifts to
    a different snap point, so a stable workload converges to cache-hit
    no-op cycles.
    """

    REPORTS_MAX = 256              # in-memory report tail kept per instance

    def __init__(self, platform: Platform, *,
                 config: Optional[AutotuneConfig] = None,
                 cache: Optional[EvalCache] = None,
                 db: Optional[ResultsDB] = None,
                 patterns: Optional[PatternStore] = None,
                 telemetry: Optional[ops.Telemetry] = None,
                 proposer_factory: Optional[
                     Callable[[str, int], Proposer]] = None,
                 probes: Optional[Dict[str, Callable[[], Any]]] = None,
                 site_cases: Optional[Dict[str, KernelCase]] = None,
                 verbose: bool = False):
        self.platform = platform
        self.config = config or AutotuneConfig()
        if cache is None:
            # an out-of-process fabric shares the cache as a file; the
            # in-memory default would be rejected by job_to_spec
            if self.config.executor and \
                    self.config.executor not in ("inprocess", "in-process",
                                                 "thread"):
                cache = EvalCache(os.path.join(
                    tempfile.gettempdir(),
                    f"repro-autotune-cache-{os.getpid()}.jsonl"))
            else:
                cache = EvalCache()
        self.cache = cache
        self.db = db
        if patterns is None and self.config.patterns:
            patterns = PatternStore(self.config.patterns)
        self.patterns = patterns
        self.telemetry = telemetry if telemetry is not None else ops.telemetry
        self.proposer_factory = proposer_factory or (
            lambda site, seed: HeuristicProposer(
                seed, patterns=self.patterns,
                platform=self.platform.name))
        self.probes = dict(probes or {})
        self._site_cases = site_cases
        self.verbose = verbose
        # bounded: the durable per-cycle record goes to the ResultsDB;
        # this is only the in-memory tail for dashboards/tests
        self.reports: Deque[AutotuneReport] = deque(maxlen=self.REPORTS_MAX)
        self.tuned_scales: Dict[str, int] = {}   # site -> scale last tuned at
        self._cycles = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cycle_lock = threading.Lock()      # one cycle at a time
        # one long-lived executor for every cycle's campaign: a
        # local-cluster fabric keeps its worker processes alive across
        # cycles, so repeated autotunes don't re-pay process startup
        self._executor = (make_executor(self.config.executor,
                                        workers=self.config.workers)
                          if self.config.executor else None)

    # ---------------------------------------------------------- mapping --
    def site_cases(self) -> Dict[str, KernelCase]:
        """app_site -> KernelCase for every case that names a splice point
        (overridable for tests / restricted deployments)."""
        if self._site_cases is not None:
            return dict(self._site_cases)
        return {c.app_site: c for c in cases() if c.app_site}

    def hot_sites(self) -> Dict[str, int]:
        """Campaign sites above the traffic threshold that map to a known
        case, hottest first, with the observed scale snapped to the case's
        supported grid.  Bucketed traffic (the continuous-batching server
        tags every event with its prefill bucket) yields one entry per hot
        bucket — keyed ``site@b<bucket>`` — each snapped to *that bucket's*
        traffic-weighted scale.  Entries already tuned at their snap are
        dropped."""
        known = self.site_cases()
        cfg = self.config
        out: Dict[str, int] = {}
        for site in self.telemetry.hot_sites(min_tokens=cfg.min_tokens):
            case = known.get(site)
            if case is None:
                continue
            buckets = [b for b, t in self.telemetry.site_buckets(site).items()
                       if t >= cfg.min_tokens]
            for b in buckets or [None]:       # no bucket tags → aggregate
                observed = self.telemetry.weighted_scale(site, bucket=b)
                if observed is None:
                    continue
                scale = snap_scale(case, observed)
                key = bucket_key(site, b)
                if self.tuned_scales.get(key) == scale:
                    continue
                out[key] = scale
                if len(out) >= cfg.max_sites:
                    return out
        return out

    # ----------------------------------------------------------- probing --
    def _default_probe(self, case: KernelCase, scale: int
                       ) -> Callable[[], Any]:
        """Integrated-step stand-in when the deployment gives no probe:
        run whatever impl is *active in the registry* on fixed generated
        inputs at the observed scale, on the platform's device — consulting
        the registry per call, so pre- and post-install runs exercise
        different generations."""
        inputs = as_tensors(datagen.generate(case.input_specs(scale),
                                             self.config.seed),
                            self.platform.device)
        fallback = case.build(case.baseline_variant, impl="torch")
        site = case.app_site

        def probe():
            fn = ops.get_impl(site) or fallback
            return fn(*inputs)
        return probe

    # ------------------------------------------------------------- cycle --
    def run_once(self) -> AutotuneReport:
        """One synchronous autotune cycle; also the body of the loop."""
        t0 = time.time()
        with self._cycle_lock:
            cycle, self._cycles = self._cycles, self._cycles + 1
            rep = AutotuneReport(cycle=cycle)
            rep.hot = self.hot_sites()
            if not rep.hot:
                rep.skipped = ("no hot sites above traffic threshold "
                               "(or all tuned at their observed scales)")
            else:
                with DEVICE_LOCK:
                    self._campaign_and_install(rep)
            rep.wall_s = time.time() - t0
            if self.db:
                self.db.append(
                    "autotune_cycle", cycle=cycle, hot=rep.hot,
                    skipped=rep.skipped, wall_s=round(rep.wall_s, 3),
                    results=[r.to_dict() for r in rep.results],
                    swaps=[s.to_dict() for s in rep.swaps])
            self.reports.append(rep)
            if self.verbose:
                swapped = [s.site for s in rep.installed]
                print(f"# autotune cycle {cycle}: hot={rep.hot} "
                      f"installed={swapped} "
                      f"rolled_back={[s.site for s in rep.rolled_back]} "
                      f"{rep.skipped}", flush=True)
            return rep

    def _campaign_and_install(self, rep: AutotuneReport) -> None:
        cfg = self.config
        cases_map = self.site_cases()
        jobs = []
        for key, scale in rep.hot.items():
            site, _bucket = split_bucket_key(key)
            case = cases_map[site]
            mep = build_mep(case, self.platform, constraints=cfg.constraints,
                            seed=cfg.seed, scale=scale)
            jobs.append(CaseJob(
                case, self.proposer_factory(site, cfg.seed + rep.cycle),
                cfg=cfg.opt, constraints=cfg.constraints, seed=cfg.seed,
                mep=mep, label=f"autotune:{key}@{scale}"))
        camp = Campaign(self.platform, patterns=self.patterns,
                        cache=self.cache, db=self.db, verbose=self.verbose,
                        executor=self._executor, max_workers=cfg.workers,
                        measure=cfg.measure)
        rep.results = camp.run(jobs, stop=self._stop)
        for (key, scale), res in zip(rep.hot.items(), rep.results):
            # an interrupted job stays un-tuned so the next cycle resumes
            # it (completed rounds replay from the shared cache)
            if res.stop_reason != "stop requested":
                self.tuned_scales[key] = scale
        if not cfg.install or self._stop.is_set():
            return
        # installs land per *site* (the registry has no bucket dimension):
        # buckets are walked hottest-first, so when several buckets of one
        # site produced different winners the hottest bucket's wins
        handled_sites = set()
        for (key, scale), res in zip(rep.hot.items(), rep.results):
            site, _bucket = split_bucket_key(key)
            case = cases_map[site]
            if site in handled_sites:
                continue
            if res.speedup <= 1.0 + cfg.improve_eps:
                continue
            if res.best_variant == res.baseline_variant:
                continue
            handled_sites.add(site)
            active = ops.active_entry(site)
            if active is not None and \
                    active.info.get("variant") == res.best_variant:
                continue                      # winner already live
            g = guarded_install(
                case, res.best_variant, scale=scale,
                impl=self.platform.impl,
                probe=self.probes.get(site) or self._default_probe(case,
                                                                   scale),
                max_regression=cfg.max_regression, atol=cfg.atol,
                r=cfg.probe_r, k=cfg.probe_k, seed=cfg.seed,
                device=self.platform.device, campaign_speedup=res.speedup)
            rep.swaps.append(g)
            if self.db:
                self.db.append("autotune_swap", cycle=rep.cycle,
                               **g.to_dict())

    # -------------------------------------------------------- background --
    def start(self) -> threading.Thread:
        """Start (or return) the background loop thread."""
        if self._thread is not None and self._thread.is_alive():
            return self._thread
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-autotune", daemon=True)
        self._thread.start()
        return self._thread

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception as e:  # noqa: BLE001 — serving must outlive us
                if self.db:
                    self.db.append("autotune_error",
                                   error=f"{type(e).__name__}: {e}"[:300])
                if self.verbose:
                    print(f"# autotune cycle failed: "
                          f"{type(e).__name__}: {e}", flush=True)
            self._stop.wait(self.config.interval_s)

    def stop(self, timeout: float = 60.0) -> None:
        """Interrupt any in-flight campaign at its next round boundary and
        join the loop thread.  Safe to call without start().  If the join
        times out the thread handle is kept, so a later ``start`` returns
        the still-draining thread instead of racing a second loop."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if not self._thread.is_alive():
                self._thread = None
        if self._executor is not None and self._thread is None:
            # only wind the fabric down once no cycle can be in flight —
            # closing under a still-draining thread would kill workers
            # mid-exchange and burn their jobs' retry budgets; a later
            # stop() (thread finished) closes it then
            self._executor.close()
