"""Performance-Feedback Iterative Optimization (paper §3.2, eq. 3–5).

Round d: the proposer generates up to N candidates from the current
baseline K^(d); each candidate is built (AER on failure), checked for
functional equivalence (eq. 4, AER on failure), and timed with the
R-run trimmed mean (eq. 3).  The feasible-set argmin becomes K^(d+1)
(eq. 5).  The loop stops at d=D or after any round whose best candidate
fails to beat the incumbent by more than the preset threshold.  Winning
strategies are summarized into the Performance Pattern Inheritance store.

This module holds the *per-candidate* half of the pipeline: the
``Evaluator`` runs build → FE → time for one candidate (each stage
AER-wrapped) and consults the shared ``EvalCache`` so no variant is ever
evaluated twice.  The *search* half — the round loop and the scheduler
that runs many kernels concurrently — lives in ``repro_torch.core.campaign``;
``optimize()`` below is kept as a thin wrapper over a one-case campaign
so existing callers and tests are unaffected.

Port of ``repro.core.optimizer``.  The JAX ``Evaluator`` FE-checks the
``jnp`` build and checks the Pallas build only under ``check_pallas``.  Here
the flag is ``check_kernel``: FE of the ``cuda`` build, on the platform's
device.  A platform that times the kernel (``h100``) forces it, so no
candidate is timed through the kernel without passing FE through it.
``OptConfig.from_dict`` also reads a JAX wire dict's ``check_pallas`` as
``check_kernel``.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.core.aer import AER
from repro_torch.core import fe as fe_mod
from repro_torch.core.evalcache import EvalCache, EvalRecord, canonical_spec
from repro_torch.core.kernelcase import KernelCase, Variant
from repro_torch.core.measure import MeasureConfig, device_work
from repro_torch.core.mep import MEP, MEPConstraints
from repro_torch.core.patterns import PatternStore
from repro_torch.core.profiler import Platform, TimingResult
from repro_torch.core.proposer import Proposer


@dataclass(frozen=True)
class OptConfig:
    d_rounds: int = 6            # D (paper: 6 for PolyBench, 10 for others)
    n_candidates: int = 3        # N (paper: 3 / 5)
    r: int = 30                  # R repeated runs — the eq. 3 cap
    k: int = 3                   # trim k
    improve_eps: float = 0.01    # stop when round gain < 1%
    fe_input_sets: int = 2
    fe_scale: Optional[int] = None   # None → MEP scale
    check_kernel: bool = False       # also FE-check the cuda build
    # adaptive measurement knobs (None → engine defaults: CI-stopped
    # reps under the R cap, incumbent racing on); the campaign fills in
    # the cross-process timing lease path
    measure: Optional[MeasureConfig] = None
    # population-search knobs (core.population.PopulationConfig); None →
    # the greedy one-variant-per-round loop.  The campaign-level default
    # (WorkerContext.population) applies when this is None.
    population: Optional[Any] = None
    # ppi=False runs the PatternStore record-only: wins are journaled
    # (and replicate across the fleet) but rounds don't *consume* hints.
    # Chaos/equivalence harnesses use it to keep winner identity
    # independent of cross-case hint timing while still exercising the
    # shared journal machinery.
    ppi: bool = True

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)            # nested dataclasses → plain dicts

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "OptConfig":
        d = dict(d)
        if "check_pallas" in d:        # a JAX package's spec
            d["check_kernel"] = bool(d.pop("check_pallas")) \
                or bool(d.get("check_kernel", False))
        if isinstance(d.get("measure"), dict):
            d["measure"] = MeasureConfig.from_dict(d["measure"])
        if isinstance(d.get("population"), dict):
            from repro_torch.core.population import PopulationConfig
            d["population"] = PopulationConfig.from_dict(d["population"])
        return OptConfig(**d)


def _de_none(t: Optional[float]) -> float:
    """json_safe writes inf as None; restore it on the way back in."""
    return float("inf") if t is None else t


@dataclass
class CandidateLog:
    variant: Variant
    status: str                  # ok | build_error | fe_fail | run_error
    time_s: float = float("inf")
    fe_abs_err: float = 0.0
    repairs: int = 0
    error: str = ""
    cached: bool = False         # served from the shared EvalCache
    # adaptive-engine provenance: reps actually spent under the eq. 3
    # cap, the CI half-width achieved, and whether incumbent racing
    # aborted the timing (a raced-out candidate is a loss by
    # construction and is excluded from the round argmin)
    reps: int = 0
    ci_half_width_s: float = 0.0
    raced_out: bool = False
    lower_bound_s: float = 0.0
    # population search: which expert persona (or "seed" / "migrant")
    # proposed this candidate; "" → greedy loop
    persona: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "CandidateLog":
        d = {k: v for k, v in d.items() if v is not None}
        d["time_s"] = _de_none(d.get("time_s", float("inf")))
        return CandidateLog(**d)


@dataclass
class RoundLog:
    round: int
    baseline_time_s: float
    candidates: List[CandidateLog] = field(default_factory=list)
    best_time_s: float = float("inf")
    improved: bool = False
    stop_reason: str = ""        # non-empty → the loop stopped after this round
    # bottleneck verdict the round's proposals were routed by
    # (core.diagnosis.Diagnosis.to_dict(); None → no diagnosis computed)
    diagnosis: Optional[Dict[str, Any]] = None
    # per-hint acceptance evidence: for each PPI hint suggested this
    # round, whether its delta ended up in the round winner
    # ({delta, source, gain, bottleneck, accepted, pid, ns})
    hints: List[Dict[str, Any]] = field(default_factory=list)
    # population search (a RoundLog is one generation there): per-persona
    # provenance {persona: {proposed, evaluated, raced, joined}}, how
    # many challengers tournament racing retired at r_min, and the
    # cross-case migration events this generation
    # ({source, delta, gain, joined})
    personae: Dict[str, Dict[str, int]] = field(default_factory=dict)
    raced_kills: int = 0
    migrations: List[Dict[str, Any]] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "RoundLog":
        d = dict(d)
        d["candidates"] = [CandidateLog.from_dict(c)
                           for c in d.get("candidates", [])]
        d["best_time_s"] = _de_none(d.get("best_time_s", float("inf")))
        if d.get("diagnosis") is not None:
            d["diagnosis"] = dict(d["diagnosis"])
        d["hints"] = [dict(h) for h in d.get("hints", []) or []]
        d["personae"] = {k: dict(v)
                         for k, v in (d.get("personae") or {}).items()}
        d["raced_kills"] = int(d.get("raced_kills", 0))
        d["migrations"] = [dict(m) for m in d.get("migrations", []) or []]
        return RoundLog(**d)


@dataclass
class OptResult:
    case_name: str
    platform: str
    proposer: str
    baseline_variant: Variant
    baseline_time_s: float
    best_variant: Variant
    best_time_s: float
    rounds: List[RoundLog] = field(default_factory=list)
    mep_log: List[str] = field(default_factory=list)
    aer_records: int = 0
    wall_s: float = 0.0
    stop_reason: str = ""
    cache_hits: int = 0
    cache_misses: int = 0
    # measurement economics (adaptive engine): wall-clock reps actually
    # paid vs what fixed-R would have paid for the same timings, plus
    # how many candidates incumbent racing retired early
    timing_reps: int = 0
    timing_reps_fixed: int = 0
    raced_out: int = 0
    # PPI hint economics: hints suggested across rounds, and how many
    # were accepted (their delta appeared in the round winner)
    hints_suggested: int = 0
    hints_accepted: int = 0
    # population-search evidence (zero/empty under the greedy loop):
    # aggregated per-persona stats, tournament-racing kills, and island
    # migration counters (candidates tried / joined the population /
    # deltas exported to other cases via the PatternStore)
    persona_stats: Dict[str, Dict[str, int]] = field(default_factory=dict)
    raced_kills: int = 0
    migrations_in: int = 0
    migrations_joined: int = 0
    migrations_out: int = 0

    @property
    def speedup(self) -> float:
        return self.baseline_time_s / self.best_time_s if self.best_time_s else 0.0

    @property
    def rep_savings(self) -> float:
        """fixed-R reps ÷ reps paid (1.0 → no savings)."""
        return self.timing_reps_fixed / self.timing_reps \
            if self.timing_reps else 1.0

    def to_dict(self, *, full: bool = False) -> Dict[str, Any]:
        """Summary record for journals (default), or — with ``full`` — the
        complete wire form an out-of-process worker ships back to the
        scheduler (``from_dict`` restores it losslessly)."""
        d = {
            "case": self.case_name, "platform": self.platform,
            "proposer": self.proposer, "speedup": self.speedup,
            "baseline_time_s": self.baseline_time_s,
            "best_time_s": self.best_time_s,
            "best_variant": self.best_variant,
            "rounds": len(self.rounds), "aer_records": self.aer_records,
            "wall_s": self.wall_s, "stop_reason": self.stop_reason,
            "cache_hits": self.cache_hits, "cache_misses": self.cache_misses,
            "timing_reps": self.timing_reps,
            "timing_reps_fixed": self.timing_reps_fixed,
            "raced_out": self.raced_out,
            "hints_suggested": self.hints_suggested,
            "hints_accepted": self.hints_accepted,
            "persona_stats": self.persona_stats,
            "raced_kills": self.raced_kills,
            "migrations_in": self.migrations_in,
            "migrations_joined": self.migrations_joined,
            "migrations_out": self.migrations_out,
        }
        if full:
            d["baseline_variant"] = self.baseline_variant
            d["rounds"] = [r.to_dict() for r in self.rounds]
            d["mep_log"] = list(self.mep_log)
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "OptResult":
        """Inverse of ``to_dict(full=True)``."""
        res = OptResult(
            case_name=d["case"], platform=d["platform"],
            proposer=d["proposer"],
            baseline_variant=dict(d["baseline_variant"]),
            baseline_time_s=_de_none(d["baseline_time_s"]),
            best_variant=dict(d["best_variant"]),
            best_time_s=_de_none(d["best_time_s"]),
            rounds=[RoundLog.from_dict(r) for r in d.get("rounds", [])],
            mep_log=list(d.get("mep_log", [])),
            aer_records=int(d.get("aer_records", 0)),
            wall_s=float(d.get("wall_s", 0.0)),
            stop_reason=d.get("stop_reason", ""),
            cache_hits=int(d.get("cache_hits", 0)),
            cache_misses=int(d.get("cache_misses", 0)),
            timing_reps=int(d.get("timing_reps", 0)),
            timing_reps_fixed=int(d.get("timing_reps_fixed", 0)),
            raced_out=int(d.get("raced_out", 0)),
            hints_suggested=int(d.get("hints_suggested", 0)),
            hints_accepted=int(d.get("hints_accepted", 0)),
            persona_stats={k: dict(v) for k, v in
                           (d.get("persona_stats") or {}).items()},
            raced_kills=int(d.get("raced_kills", 0)),
            migrations_in=int(d.get("migrations_in", 0)),
            migrations_joined=int(d.get("migrations_joined", 0)),
            migrations_out=int(d.get("migrations_out", 0)))
        return res


class Evaluator:
    """Pure per-candidate evaluation: build → FE → time (eq. 3–4), with
    AER-driven retries at each stage.  When an ``EvalCache`` is attached,
    every outcome is content-addressed by the full evaluation spec, so
    repeated candidates — within a round, across kernels, or across
    campaign restarts — are served from the cache."""

    def __init__(self, mep: MEP, case: KernelCase, platform_name: str,
                 aer: AER, proposer: Proposer, cfg: OptConfig,
                 cache: Optional[EvalCache] = None,
                 measured: bool = False,
                 measure_cfg: Optional[MeasureConfig] = None):
        self.mep = mep
        self.case = case
        self.platform_name = platform_name
        self.aer = aer
        self.proposer = proposer
        self.cfg = cfg
        self.cache = cache
        # wall-clock platforms → cached records are namespace/TTL-guarded
        self.measured = measured
        # resolved adaptive-engine config (lease path filled in by the
        # campaign); None → engine defaults
        self.measure_cfg = measure_cfg if measure_cfg is not None \
            else cfg.measure
        self.hits = 0
        self.misses = 0
        # measurement economics: reps actually paid vs the fixed-R bill
        self.timing_reps = 0
        self.timing_reps_fixed = 0
        self.raced = 0
        # FE through the kernel: asked for, or forced by the platform
        self._check_kernel = bool(cfg.check_kernel or getattr(
            mep.platform, "check_kernel", False))

    # ------------------------------------------------------------------
    def _time(self, variant: Variant,
              incumbent_s: Optional[float]) -> TimingResult:
        """One eq. 3 timing through the adaptive engine, with the rep
        ledger updated."""
        t = self.mep.measure(variant, r=self.cfg.r, k=self.cfg.k,
                             budget=self.measure_cfg,
                             incumbent_s=incumbent_s)
        self.timing_reps += t.r
        # an analytic (deterministic) timing never paid R real reps under
        # fixed-R either — it computed the model once and padded — so it
        # contributes no claimed savings to the ledger
        self.timing_reps_fixed += t.r if t.deterministic \
            else (t.r_cap or self.cfg.r)
        if t.raced_out:
            self.raced += 1
        return t

    @staticmethod
    def _timing_fields(t: TimingResult) -> Dict[str, Any]:
        return {"reps": t.r, "r_cap": t.r_cap,
                "ci_half_width_s": t.ci_half_width_s,
                "raced_out": t.raced_out,
                "lower_bound_s": t.lower_bound_s}

    def measure_baseline(self, variant: Variant) -> float:
        """Timing-only measurement (no FE) of an already-trusted variant.
        The baseline IS the incumbent, so racing never applies here."""
        if self.cache is None:
            return self._time(variant, None).trimmed_mean_s

        def compute() -> EvalRecord:
            t = self._time(variant, None)
            return EvalRecord(status="ok", time_s=t.trimmed_mean_s,
                              final_variant=dict(variant),
                              **self._timing_fields(t))

        rec, hit = self.cache.get_or_compute(self._spec(variant, "measure"),
                                             compute,
                                             measured=self.measured,
                                             accept=self._accept(None))
        self._count(hit)
        return rec.time_s

    def _accept(self, incumbent_s: Optional[float]):
        """Cached-record validity in this evaluation's context: a full
        timing always replays; a raced-out partial timing replays only
        while its optimistic lower bound still loses to the *current*
        incumbent — otherwise the candidate might now win and must be
        re-measured (the fresh record replaces the stale one)."""
        def accept(rec: EvalRecord) -> bool:
            if not rec.raced_out:
                return True
            return incumbent_s is not None \
                and rec.lower_bound_s > incumbent_s
        return accept

    def evaluate(self, variant: Variant,
                 incumbent_s: Optional[float] = None) -> CandidateLog:
        """Build → FE → time one candidate.  ``incumbent_s`` (the search
        loop's current best) arms incumbent racing: timing aborts once
        the candidate provably cannot win the round."""
        if self.cache is None:
            return self._evaluate_uncached(variant, incumbent_s)

        def compute() -> EvalRecord:
            cl = self._evaluate_uncached(variant, incumbent_s)
            return EvalRecord(status=cl.status, time_s=cl.time_s,
                              fe_abs_err=cl.fe_abs_err, repairs=cl.repairs,
                              error=cl.error, final_variant=dict(cl.variant),
                              reps=cl.reps, r_cap=self.cfg.r,
                              ci_half_width_s=cl.ci_half_width_s,
                              raced_out=cl.raced_out,
                              lower_bound_s=cl.lower_bound_s)

        rec, hit = self.cache.get_or_compute(self._spec(variant, "eval"),
                                             compute,
                                             measured=self.measured,
                                             accept=self._accept(incumbent_s))
        self._count(hit)
        return CandidateLog(dict(rec.final_variant), rec.status, rec.time_s,
                            fe_abs_err=rec.fe_abs_err, repairs=rec.repairs,
                            error=rec.error, cached=hit, reps=rec.reps,
                            ci_half_width_s=rec.ci_half_width_s,
                            raced_out=rec.raced_out,
                            lower_bound_s=rec.lower_bound_s)

    # ------------------------------------------------------------------
    def _spec(self, variant: Variant, kind: str) -> Dict[str, Any]:
        cfg = self.cfg
        # the kernel-source digest makes editing a case's build/ref code
        # invalidate its persisted cache entries (ROADMAP: eval-cache
        # invalidation) instead of replaying timings of the old kernel
        params: Dict[str, Any] = {"r": cfg.r, "k": cfg.k,
                                  "seed": self.mep.seed,
                                  "src": self.case.source_digest()}
        # the adaptive stopping policy changes how many reps back a
        # timing, so it is part of the record's identity (racing and the
        # lease are NOT: racing truncation is carried by the raced_out
        # flag + accept predicate, the lease only schedules)
        params["measure"] = (self.measure_cfg or MeasureConfig()).cache_key()
        if kind == "eval":
            # a full evaluation embeds repair outcomes, so the repair
            # policy is part of the key (AER-only proposers share it)
            params.update(fe_input_sets=cfg.fe_input_sets,
                          fe_scale=cfg.fe_scale or min(self.mep.scale,
                                                       min(self.case.scales)),
                          check_kernel=self._check_kernel,
                          repair=getattr(self.proposer, "repair_key", "aer"))
        return canonical_spec(self.case.name, variant, self.mep.scale,
                              self.platform_name, kind=kind, **params)

    def _count(self, hit: bool) -> None:
        if hit:
            self.hits += 1
        else:
            self.misses += 1

    def _evaluate_uncached(self, variant: Variant,
                           incumbent_s: Optional[float] = None
                           ) -> CandidateLog:
        mep, case, cfg = self.mep, self.case, self.cfg
        v = dict(variant)
        repairs = 0
        while True:
            stage = "build"
            try:
                fe_scale = cfg.fe_scale or min(mep.scale, min(case.scales))
                stage = "fe"
                rtol_scale = 200.0 if v.get("compute_dtype") == "bf16" else 1.0
                device = mep.platform.device
                # FE runs both builds on the platform's device: on the
                # card it is device work under the card's lease
                with device_work(mep.platform, "fe"):
                    r = fe_mod.check(case, v, fe_scale, impl="torch",
                                     n_input_sets=cfg.fe_input_sets,
                                     rtol_scale=rtol_scale, device=device)
                    if not r.ok:
                        raise FloatingPointError(
                            f"FE violation: {r.detail}")
                    if self._check_kernel:
                        rp = fe_mod.check(case, v, fe_scale, impl="cuda",
                                          n_input_sets=1, rtol_scale=4.0,
                                          device=device)
                        if not rp.ok:
                            raise FloatingPointError(
                                f"FE(kernel) violation: {rp.detail}")
                stage = "run"
                t = self._time(v, incumbent_s)
                return CandidateLog(v, "ok", t.trimmed_mean_s,
                                    fe_abs_err=r.max_abs_err, repairs=repairs,
                                    reps=t.r,
                                    ci_half_width_s=t.ci_half_width_s,
                                    raced_out=t.raced_out,
                                    lower_bound_s=t.lower_bound_s)
            except Exception as e:  # noqa: BLE001 — every failure goes to AER
                err = f"{type(e).__name__}: {e}"
                fixed = self.proposer.repair(case, v, err) \
                    or self.aer.repair(v, err, stage)
                if fixed is None or repairs >= 4:
                    status = {"build": "build_error", "fe": "fe_fail",
                              "run": "run_error"}[stage]
                    return CandidateLog(v, status, repairs=repairs,
                                        error=err[:300])
                v = fixed
                repairs += 1


def optimize(case: KernelCase, platform: Platform, proposer: Proposer, *,
             cfg: OptConfig = OptConfig(),
             constraints: MEPConstraints = MEPConstraints(),
             patterns: Optional[PatternStore] = None,
             seed: int = 0,
             mep: Optional[MEP] = None,
             cache: Optional[EvalCache] = None) -> OptResult:
    """Serial single-kernel entry point: a one-case campaign."""
    from repro_torch.core.campaign import Campaign, CaseJob
    camp = Campaign(platform, patterns=patterns, cache=cache, max_workers=1)
    job = CaseJob(case, proposer, cfg=cfg, constraints=constraints,
                  seed=seed, mep=mep)
    return camp.run([job])[0]
