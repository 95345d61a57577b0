"""Adaptive measurement engine: CI-based early stopping, incumbent
racing, and a cross-process timing lease.

Port of ``repro.core.measure``: the engine, ``trimmed_stats``, the timing
lease and the probe memo are the JAX package's, unchanged.  Only
``measure_fn`` differs: where JAX blocks with ``jax.block_until_ready``, it
synchronises the device the inputs lie on and times a rep on the card with
CUDA events, on the CPU with ``perf_counter``.

The paper's eq. 3 suppresses system noise with a fixed budget — R
repeated runs, k-trimmed mean — and that budget is paid for *every*
candidate: obvious losers, analytic re-probes, and already-converged
timings all cost the full R.  This engine keeps eq. 3's semantics (the
cap is the paper's R; k-trimming is applied to whatever was collected)
while spending only the repetitions a measurement actually needs:

* **Adaptive repetitions** — run ``r_min`` reps, then extend in blocks
  until the normal-approximation confidence half-width of the trimmed
  mean falls under ``ci_rel`` × the trimmed mean, or the rep count hits
  the eq. 3 cap.  Deterministic (analytic) timers stop after one rep.
* **Incumbent racing** — when the caller passes the current best time,
  timing aborts as soon as the candidate's optimistic lower bound
  (min observed minus the CI half-width) can no longer beat it; the
  result is flagged ``raced_out`` and the search loop treats it as a
  loss without paying the full R.
* **Timing lease** — wall-clock sections are serialized in short slices
  through a process-wide mutex plus (when a lease path is configured)
  an flock'd arbiter file shared across worker processes.  Everything
  *around* the timed section — build, compile, FE, LLM calls — overlaps
  freely, so measured platforms fan out across threads and processes
  without corrupting eq. 3 (this replaces the one-exclusive-worker
  pinning the local-cluster executor used to apply).

* **Device lease** (the port's own) — on one GPU, worker processes run
  in separate CUDA contexts that the card time-slices, so another
  worker's FE launches could land inside a timed CUDA-event window, and
  the timing lease above (host-scoped, timed slices only) cannot see
  them.  A measured platform on the card therefore holds a cross-process
  lease on the *physical card* (keyed by its UUID, one file in the temp
  dir, shared by every host alias and worker on the machine) over every
  stretch of device work a worker does: the MEP's probes, FE through the
  kernel, warm-up and every timed slice.  CPU work (proposals, spec
  decoding, the MEP's host-side data, the LLM batcher) still overlaps.
  Each hold ends with a device synchronise, so no launch outlives it, and
  is journaled (pid, host alias, monotonic start and end) into the
  campaign's ``ResultsDB`` as a ``device_lease`` record.

The engine is also the home of the MEP auto-sizing **probe memo**: rough
baseline probes (r=3, k=0) are memoized per (case, variant, platform,
scale, seed), so MEP construction never times the same coordinates
twice — not across the budget-walk fallback, and not across repeated
``build_mep`` calls in one process.
"""
from __future__ import annotations

import math
import os
import tempfile
import threading
import time
import weakref
from contextlib import contextmanager
from dataclasses import asdict, dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MeasureConfig:
    """Knobs of the adaptive engine.  The eq. 3 parameters (the rep cap R
    and trim k) stay where they always were — ``OptConfig.r`` /
    ``MEPConstraints.r`` — this config only controls how much of that
    cap a measurement actually spends."""
    adaptive: bool = True     # False → always pay the full cap (fixed-R)
    r_min: int = 5            # reps before any stopping decision
    block: int = 5            # extension block between CI re-checks
    ci_rel: float = 0.05      # stop when CI half-width ≤ ci_rel × mean
    z: float = 1.96           # normal CI multiplier (95%)
    race: bool = True         # incumbent racing (needs incumbent_s)
    # tournament slack (population search): racing aborts once the
    # optimistic lower bound cannot beat incumbent × (1 − race_margin),
    # so challengers within the margin of their tournament opponent
    # still get a full timing (0.0 → classic strict racing).  Like
    # ``race`` it only truncates, so it is not part of the cache key.
    race_margin: float = 0.0
    warmup: int = 1           # warmup calls (each blocked on) before timing
    lease_path: Optional[str] = None   # cross-process timing arbiter file
    lease_slice: int = 5      # max reps timed per lease hold

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "MeasureConfig":
        return MeasureConfig(**d)

    def cache_key(self) -> Dict[str, Any]:
        """The fields that change a measurement's *outcome* — part of the
        eval-cache spec.  Warmup is included: it decides whether the
        first timed rep absorbs deferred compile/dispatch cost.  The
        lease only schedules wall-clock sections and racing only
        truncates (handled by the ``raced_out`` flag + accept predicate
        at lookup), so neither belongs in the key."""
        return {"adaptive": self.adaptive, "r_min": self.r_min,
                "block": self.block, "ci_rel": self.ci_rel, "z": self.z,
                "warmup": self.warmup}


def resolve_lease(cfg: Optional[MeasureConfig],
                  lease_path: Optional[str]) -> MeasureConfig:
    """Fill the campaign-provided lease path into a (possibly None)
    measure config, keeping an explicitly-set path."""
    cfg = cfg or MeasureConfig()
    if lease_path and not cfg.lease_path:
        cfg = replace(cfg, lease_path=lease_path)
    return cfg


def default_lease_path(cache_path: Optional[str], scope: str,
                       host: Optional[str] = None) -> str:
    """The one rule for where a timing lease lives: next to the shared
    eval cache when there is one (every process sharing the cache shares
    the lease), else a ``scope``-keyed file in the temp dir.  Both the
    campaign scheduler and the bare-executor spec path derive from here
    so the two can never drift apart.

    The path is **host-scoped** (``host=None`` → ``this_host()``): a
    timing lease arbitrates contention for ONE machine's CPUs, so when
    the eval cache is shared across hosts (shared filesystem, or the
    remote fleet's journal replication) every host must get its *own*
    arbiter file — serializing host A's wall-clock slices against host
    B's would throttle the fleet without protecting anything.  Workers
    re-derive the path with their own hostname from the spec wire form's
    ``lease_scope`` (see ``workers.job_to_spec``)."""
    from repro_torch.core.evalcache import this_host
    host = this_host() if host is None else host
    tag = f"@{host}" if host else ""
    if cache_path:
        return f"{cache_path}.timelease{tag}"
    return os.path.join(tempfile.gettempdir(),
                        f"repro-timelease-{scope}{tag}.lock")


# ---------------------------------------------------------------------------
# timing lease
# ---------------------------------------------------------------------------
# All wall-clock sections in this process serialize on one mutex: timing
# is contending for the same CPUs whichever variant it measures, so a
# global lock (not per-path) is the correct granularity.
_TIMING_MUTEX = threading.Lock()


class TimingLease:
    """Cross-process timing arbiter.  ``slice_()`` grants the exclusive
    right to wall-clock for one short burst of reps: a process-wide
    mutex (threads of this process) plus an ``flock`` on the arbiter
    file (other worker processes sharing the path) — the lock
    discipline itself is the shared ``evalcache.FileLock`` (never
    unlinked, no-op without ``fcntl``).  The file lives next to the
    eval cache by default and is safe to share over local
    filesystems."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self.acquisitions = 0     # observability (tests, benches)

    @contextmanager
    def slice_(self):
        from repro_torch.core.evalcache import FileLock
        with _TIMING_MUTEX:
            if self.path:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                with FileLock(self.path):
                    self.acquisitions += 1
                    yield
            else:
                self.acquisitions += 1
                yield


_LEASES: Dict[Optional[str], TimingLease] = {}
_LEASES_LOCK = threading.Lock()


def get_lease(path: Optional[str]) -> TimingLease:
    with _LEASES_LOCK:
        lease = _LEASES.get(path)
        if lease is None:
            lease = _LEASES[path] = TimingLease(path)
        return lease


# ---------------------------------------------------------------------------
# device lease: one physical card, every process on the machine
# ---------------------------------------------------------------------------
def card_key(device) -> str:
    """The physical card behind ``device``: its UUID (the same for every
    process, context and host alias on the machine), as a file-name-safe
    string."""
    import torch
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    raw = str(torch.cuda.get_device_properties(idx).uuid)
    return "".join(c if c.isalnum() or c in "-_" else "-" for c in raw)


def device_lease_path(key: str) -> str:
    """Where the lease on card ``key`` lives: one file in the temp dir,
    so every worker and every host alias on the machine contends for
    it."""
    return os.path.join(tempfile.gettempdir(),
                        f"repro-devicelease-{key}.lock")


class DeviceLease:
    """Cross-process lease on one physical card.  ``hold(what)`` grants
    the card for one stretch of device work: a per-card mutex (threads
    of this process) plus an ``flock`` on the card's lease file (every
    other process).  Holds nest within a thread (only the outermost one
    locks); the outermost hold synchronises ``device`` before it lets go
    and journals itself to the thread's sink (``lease_journal``)."""

    def __init__(self, key: str, path: Optional[str] = None, device=None):
        self.key = key
        self.path = path or device_lease_path(key)
        self.device = device
        self._mutex = threading.Lock()
        self._local = threading.local()
        self.holds = 0            # observability (tests)

    def held(self) -> bool:
        """Whether the calling thread holds the card."""
        return getattr(self._local, "depth", 0) > 0

    @contextmanager
    def hold(self, what: str = ""):
        if self.held():
            self._local.depth += 1
            try:
                yield
            finally:
                self._local.depth -= 1
            return
        from repro_torch.core.evalcache import FileLock, this_host
        t_req = time.monotonic()
        with self._mutex:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with FileLock(self.path):
                t0 = time.monotonic()
                self._local.depth = 1
                for listen in HOLD_LISTENERS:
                    listen(what, True)
                try:
                    yield
                finally:
                    try:
                        if self.device is not None:
                            import torch
                            torch.cuda.synchronize(self.device)
                    finally:
                        self._local.depth = 0
                        t1 = time.monotonic()
                        for listen in HOLD_LISTENERS:
                            listen(what, False)
        self.holds += 1
        sink = getattr(_JOURNAL, "sink", None)
        if sink is not None:
            db, fields = sink
            try:
                db.append("device_lease", card=self.key, what=what,
                          pid=os.getpid(), host=this_host(),
                          t_req=t_req, t0=t0, t1=t1, **fields)
            except OSError:
                pass      # a full disk must not fail the measurement


_DEVICE_LEASES: Dict[str, DeviceLease] = {}
# called as listen(what, entering) at the start and the end of every
# outermost hold, by the holding thread, while it holds the card
HOLD_LISTENERS: List[Callable[[str, bool], None]] = []
_JOURNAL = threading.local()


def get_device_lease(key: str, device=None) -> DeviceLease:
    """The process's one ``DeviceLease`` for card ``key``."""
    with _LEASES_LOCK:
        lease = _DEVICE_LEASES.get(key)
        if lease is None:
            lease = _DEVICE_LEASES[key] = DeviceLease(key, device=device)
        return lease


def platform_lease(platform) -> Optional[DeviceLease]:
    """The device lease a platform's device work is held under: the
    card's for a measured platform that launches on it (``h100``,
    ``h100-torch``); None for analytic platforms and the CPU, which fan
    out as before (the host's timing lease still serialises CPU timing).
    A platform may name its own lease through a ``device_lease()``
    method."""
    own = getattr(platform, "device_lease", None)
    if callable(own):
        return own()
    if getattr(platform, "concurrency_safe", False):
        return None
    device = str(getattr(platform, "device", "cpu"))
    if not device.startswith("cuda"):
        return None
    return get_device_lease(card_key(device), device=device)


@contextmanager
def device_work(platform, what: str = ""):
    """Hold ``platform``'s device lease (if it has one) over a stretch of
    device work."""
    lease = platform_lease(platform)
    if lease is None:
        yield
    else:
        with lease.hold(what):
            yield


@contextmanager
def lease_journal(db, **fields):
    """Journal this thread's device-lease holds into ``db`` (a
    ``ResultsDB``) as ``device_lease`` records carrying ``fields``."""
    prev = getattr(_JOURNAL, "sink", None)
    _JOURNAL.sink = (db, fields) if db is not None else None
    try:
        yield
    finally:
        _JOURNAL.sink = prev


# ---------------------------------------------------------------------------
# eq. 3 statistics on a partial sample
# ---------------------------------------------------------------------------
def effective_k(n: int, k: int) -> int:
    """Eq. 3 requires R > 2k; on a partial sample the trim shrinks to
    what the collected reps can afford (full k once n ≥ 2k+1)."""
    return max(0, min(k, (n - 1) // 2))


# 97.5% Student-t quantiles by degrees of freedom (df = m-1); beyond
# the table the normal 1.96 is close enough.  The stopping decisions
# run on few kept samples (m=4 at the first k=3 decision point), where
# the normal quantile understates the CI by ~40% — the t-quantile keeps
# "converged" honest there.
_T975 = {1: 12.71, 2: 4.30, 3: 3.18, 4: 2.78, 5: 2.57, 6: 2.45,
         7: 2.36, 8: 2.31, 9: 2.26, 10: 2.23, 12: 2.18, 15: 2.13,
         20: 2.09, 25: 2.06, 30: 2.04}


def _t_quantile(df: int) -> float:
    if df in _T975:
        return _T975[df]
    for lim in sorted(_T975):
        if df < lim:
            return _T975[lim]
    return 1.96


def trimmed_stats(times: List[float], k: int, z: float
                  ) -> Tuple[float, float, int]:
    """(trimmed mean, CI half-width, k applied).  The half-width is the
    Student-t interval over the *kept* (trimmed) sample — scaled by
    ``z``/1.96 so a configured confidence other than 95% carries
    through.  One kept sample → width 0 (deterministic timers);
    identical samples → width 0 (converged immediately)."""
    n = len(times)
    ke = effective_k(n, k)
    kept = sorted(times)[ke:n - ke] if ke else list(times)
    m = len(kept)
    mean = sum(kept) / m
    if m < 2:
        return mean, 0.0, ke
    var = sum((t - mean) ** 2 for t in kept) / (m - 1)
    mult = _t_quantile(m - 1) * (z / 1.96)
    return mean, mult * math.sqrt(var / m), ke


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def measure_callable(run_once: Callable[[], float], *, r: int, k: int,
                     cfg: Optional[MeasureConfig] = None,
                     incumbent_s: Optional[float] = None,
                     deterministic: bool = False):
    """Adaptive eq. 3 measurement of ``run_once`` (returns the seconds of
    one timed rep).  ``r`` is the paper's cap, ``k`` the trim count.
    Returns a ``TimingResult`` whose ``r`` is the reps actually spent,
    with the CI half-width, the cap, and the raced-out flag recorded.

    ``deterministic=True`` (analytic platforms) short-circuits to a
    single rep — re-running a pure function R times buys nothing."""
    from repro_torch.core.profiler import TimingResult

    cfg = cfg or MeasureConfig()
    r = max(1, int(r))
    lease = get_lease(cfg.lease_path)
    times: List[float] = []

    if deterministic:
        t = run_once()
        return TimingResult(t, [t], 1, 0, ci_half_width_s=0.0, r_cap=r,
                            deterministic=True)

    goal = r if not cfg.adaptive else min(r, max(1, cfg.r_min))
    raced_out = False
    while True:
        while len(times) < goal:
            take = min(goal - len(times), max(1, cfg.lease_slice))
            with lease.slice_():
                for _ in range(take):
                    times.append(run_once())
        mean, hw, ke = trimmed_stats(times, k, cfg.z)
        if not cfg.adaptive or len(times) >= r:
            break
        # a stopping decision needs a real spread estimate: with fewer
        # than two kept (post-trim) samples the half-width is trivially
        # zero, which must not read as convergence
        if len(times) - 2 * ke >= 2:
            if hw <= cfg.ci_rel * mean:
                # CI converged under the cap.  Checked before racing: a
                # converged loser is a full-fidelity record (reusable
                # from the cache against any future incumbent), at the
                # same rep cost a raced-out stamp would have paid
                break
            if cfg.race and incumbent_s is not None \
                    and min(times) - hw \
                    > incumbent_s * (1.0 - cfg.race_margin):
                # even the optimistic lower bound loses to the
                # incumbent: further reps cannot change the argmin,
                # stop paying for them
                raced_out = True
                break
        goal = min(r, len(times) + max(1, cfg.block))
    return TimingResult(mean, times, len(times), ke, ci_half_width_s=hw,
                        r_cap=r, raced_out=raced_out)


def _device_of(inputs):
    """The device of the first tensor among ``inputs`` (CPU if none)."""
    import torch
    for x in inputs:
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, (tuple, list)):
            found = _device_of(x)
            if found.type != "cpu":
                return found
    return torch.device("cpu")


def measure_fn(fn: Callable, inputs, *, r: int, k: int,
               cfg: Optional[MeasureConfig] = None,
               incumbent_s: Optional[float] = None):
    """Time ``fn(*inputs)`` through the adaptive engine.  On the card each
    rep is the CUDA-event time between a start event recorded after
    ``torch.cuda.synchronize()`` (no earlier work inside the window) and an
    end event recorded after the call, read once the end event completes;
    on the CPU it is ``perf_counter`` around the call.  Warmup calls each
    synchronise on their own output, and ``warmup=0`` is a supported
    configuration (no stray state)."""
    import torch

    cfg = cfg or MeasureConfig()
    dev = _device_of(inputs)
    on_card = dev.type == "cuda"

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(dev)

    for _ in range(max(0, cfg.warmup)):
        fn(*inputs)
        sync()

    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def run_once() -> float:
            torch.cuda.synchronize(dev)
            start.record()
            fn(*inputs)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
    else:
        def run_once() -> float:
            t0 = time.perf_counter()
            fn(*inputs)
            return time.perf_counter() - t0

    return measure_callable(run_once, r=r, k=k, cfg=cfg,
                            incumbent_s=incumbent_s)


# ---------------------------------------------------------------------------
# MEP auto-sizing probe memo
# ---------------------------------------------------------------------------
# memo is keyed per platform *instance* (WeakKeyDictionary): two
# differently-parameterized platforms sharing a name must never serve
# each other's probe times, and a collected platform frees its entries
_PROBE_MEMO: "weakref.WeakKeyDictionary[Any, Dict[Tuple, Tuple[float, float]]]" \
    = weakref.WeakKeyDictionary()
_PROBE_LOCK = threading.Lock()
_PROBE_MAX = 512
probe_hits = 0          # observability for tests/benches


def _probe_ttl_s() -> float:
    """Probes are wall-clock under current machine conditions, like the
    eval cache's measured records: honor the same REPRO_CACHE_TTL_S when
    set, else a modest default so a long-lived autotuner process never
    sizes MEPs against dead measurements."""
    env = os.environ.get("REPRO_CACHE_TTL_S", "")
    return float(env) if env else 600.0


def _probe_key(case, variant, scale: int, seed: int,
               r: int, k: int) -> Tuple:
    return (case.name, case.source_digest(),
            tuple(sorted(variant.items())), int(scale), int(seed),
            int(r), int(k))


def probe_time(platform, case, variant, scale: int, inputs, *,
               seed: int, r: int = 3, k: int = 0,
               budget: Optional[MeasureConfig] = None) -> float:
    """Rough baseline probe for MEP auto-sizing, memoized so the budget
    walk, its fallback path, and later ``build_mep`` calls at the same
    (case, variant, platform, scale, seed) never pay the same wall-clock
    twice in one process.  ``budget`` carries the campaign's timing
    lease so a probe's wall-clock never overlaps another worker's
    leased eq. 3 slices."""
    global probe_hits
    key = _probe_key(case, variant, scale, seed, r, k)
    deterministic = getattr(platform, "concurrency_safe", False)
    with _PROBE_LOCK:
        memo = _PROBE_MEMO.get(platform)
        hit = memo.get(key) if memo is not None else None
        if hit is not None and (deterministic or
                                time.time() - hit[1] <= _probe_ttl_s()):
            probe_hits += 1
            return hit[0]
    with device_work(platform, "probe"):
        t = platform.time_variant(case, variant, scale, inputs,
                                  r=r, k=k, budget=budget).trimmed_mean_s
    with _PROBE_LOCK:
        memo = _PROBE_MEMO.setdefault(platform, {})
        if len(memo) >= _PROBE_MAX:
            memo.clear()              # probes are cheap; a reset is fine
        memo[key] = (t, time.time())
    return t
