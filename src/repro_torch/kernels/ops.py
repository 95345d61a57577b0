"""Kernel-variant registry: the reintegration point of the MEP framework.

A verbatim copy of ``repro.kernels.ops``: the port keeps its own registry
(and imports nothing of ``repro``).  In the port, model code runs eagerly
and consults ``get_impl`` on every call; ``BatchedServer`` still counts
registry changes at step boundaries as swap epochs.

Model code asks ``get_impl(site)`` at trace time; the MEP optimizer (or a
config flag) installs an optimized variant with ``install`` / ``set_impl``
/ ``use_impl``.  This is how an MEP-optimized kernel is swapped back into
the full application ("Integrated Speedup" in the paper) without editing
model code or re-deriving the training step.

The registry is **versioned**: every mutation mints a monotonically
increasing *generation*, and each site keeps a stack of installed
implementations so a bad install can be rolled back to exactly the state
it replaced (``core.integrate.guarded_install`` builds on this).  A
global ``registry_epoch`` counter lets long-lived consumers — the
``BatchedServer`` keeps jit-compiled step functions that bake the active
impl in at trace time — detect that *any* site changed and re-trace at a
convenient boundary (a "swap epoch") instead of polling per call.

A module-level ``telemetry`` object collects traffic-weighted scale
statistics per site (which scales actually serve tokens), feeding the
online autotuner (``serve.autotune``) the workload it should optimize
for, rather than a fixed benchmark scale.

Sites used by the models:
  attention   (q, k, v, *, causal, softcap) -> out
  rwkv_wkv    (r, k, v, w, u) -> out
  ssm_chunk   (x, dt, A, B, C) -> y
  moe_gemm    (buf, w1, w3, w2, act) -> y
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

_lock = threading.Lock()
_STACKS: Dict[str, List["ImplEntry"]] = {}
_gen_counter = itertools.count(1)
_epoch = 0


@dataclass(frozen=True)
class ImplEntry:
    """One installed implementation: the callable plus its provenance."""
    fn: Callable
    generation: int
    meta: Tuple[Tuple[str, Any], ...] = ()

    @property
    def info(self) -> Dict[str, Any]:
        return dict(self.meta)


def _bump_epoch() -> None:
    # caller holds _lock
    global _epoch
    _epoch += 1


def registry_epoch() -> int:
    """Monotonic counter bumped on every registry mutation (any site).
    Consumers that bake impls into traced/jitted code compare this against
    the epoch they traced under to know when to re-trace."""
    return _epoch


def install(site: str, fn: Callable, **meta: Any) -> int:
    """Push ``fn`` as the active impl for ``site``; returns its generation.
    The previous impl stays underneath for ``rollback``."""
    with _lock:
        gen = next(_gen_counter)
        _STACKS.setdefault(site, []).append(
            ImplEntry(fn, gen, tuple(sorted(meta.items()))))
        _bump_epoch()
        return gen


def rollback(site: str, to_generation: Optional[int] = None) -> int:
    """Pop installs from ``site``'s stack; returns the now-active
    generation (0 = empty).  Without ``to_generation`` pops one entry;
    with it, pops until the active generation is ≤ ``to_generation`` —
    i.e. restores the state as of that generation."""
    with _lock:
        stack = _STACKS.get(site, [])
        if to_generation is None:
            if stack:
                stack.pop()
        else:
            while stack and stack[-1].generation > to_generation:
                stack.pop()
        if not stack:
            _STACKS.pop(site, None)
        _bump_epoch()
        return stack[-1].generation if stack else 0


def generation(site: str) -> int:
    """Generation of the active impl at ``site`` (0 = nothing installed)."""
    with _lock:
        stack = _STACKS.get(site)
        return stack[-1].generation if stack else 0


def history(site: str) -> List[ImplEntry]:
    """The install stack for ``site``, oldest first (last = active)."""
    with _lock:
        return list(_STACKS.get(site, ()))


def active_entry(site: str) -> Optional[ImplEntry]:
    with _lock:
        stack = _STACKS.get(site)
        return stack[-1] if stack else None


def get_impl(site: str) -> Optional[Callable]:
    with _lock:
        stack = _STACKS.get(site)
        return stack[-1].fn if stack else None


def set_impl(site: str, fn: Optional[Callable]) -> None:
    """Legacy flat API: replace the site's whole stack with ``fn`` (or
    clear it with None).  Still mints a generation / bumps the epoch."""
    with _lock:
        if fn is None:
            _STACKS.pop(site, None)
        else:
            _STACKS[site] = [ImplEntry(fn, next(_gen_counter))]
        _bump_epoch()


def clear_all() -> None:
    with _lock:
        _STACKS.clear()
        _bump_epoch()


def active_sites() -> Dict[str, Callable]:
    with _lock:
        return {site: stack[-1].fn for site, stack in _STACKS.items()
                if stack}


@contextlib.contextmanager
def use_impl(site: str, fn: Callable):
    """Scoped install: on exit the site is restored to the generation it
    had on entry (anything pushed on top inside the scope is popped too,
    so nesting composes)."""
    gen_before = generation(site)
    install(site, fn)
    try:
        yield
    finally:
        rollback(site, gen_before)


# --------------------------------------------------------------------------
# Per-site traffic telemetry
# --------------------------------------------------------------------------
class Telemetry:
    """Thread-safe traffic-weighted scale/shape statistics per site.

    The serving layer calls ``observe`` on its hotspot paths (prefill:
    one event per admitted prompt, weight = prompt tokens; decode: one
    event per generated token, scale = context length).  The autotuner
    reads ``hot_sites`` / ``weighted_scale`` to decide *what* to optimize
    and *at which scale* — the observed workload, not a benchmark grid.

    Keys optionally carry a **bucket** dimension: the continuous-batching
    server tags every event with the prefill length-bucket its request was
    admitted under, so each (site, bucket) pair becomes a distinct
    telemetry site and the autotuner campaigns per traffic bucket at that
    bucket's observed scale (``weighted_scale(site, bucket=...)``).
    Bucket-less observations keep the old aggregate behavior; bucketed
    ones contribute to both the aggregate and their bucket's sub-stats.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._sites: Dict[str, Dict[str, Any]] = {}

    def observe(self, site: str, *, scale: int, tokens: int = 1,
                kind: str = "decode", bucket: Optional[int] = None) -> None:
        with self._lock:
            st = self._sites.setdefault(
                site, {"calls": 0, "tokens": 0, "kinds": {}, "scales": {},
                       "buckets": {}})
            st["calls"] += 1
            st["tokens"] += tokens
            st["kinds"][kind] = st["kinds"].get(kind, 0) + tokens
            st["scales"][int(scale)] = (st["scales"].get(int(scale), 0)
                                        + tokens)
            if bucket is not None:
                bk = st["buckets"].setdefault(
                    int(bucket), {"tokens": 0, "scales": {}})
                bk["tokens"] += tokens
                bk["scales"][int(scale)] = (bk["scales"].get(int(scale), 0)
                                            + tokens)

    def tokens(self, site: str, kind: Optional[str] = None) -> int:
        with self._lock:
            st = self._sites.get(site)
            if st is None:
                return 0
            return st["tokens"] if kind is None else st["kinds"].get(kind, 0)

    def site_buckets(self, site: str) -> Dict[int, int]:
        """bucket -> observed tokens for ``site`` (empty if the traffic
        never carried a bucket tag), hottest bucket first."""
        with self._lock:
            st = self._sites.get(site)
            if not st:
                return {}
            return dict(sorted(((b, bk["tokens"])
                                for b, bk in st["buckets"].items()),
                               key=lambda kv: -kv[1]))

    def weighted_scale(self, site: str,
                       bucket: Optional[int] = None) -> Optional[int]:
        """Traffic-weighted mean scale observed at ``site`` (None if no
        traffic) — every token votes with the context size it ran at.
        With ``bucket``, restrict to that prefill bucket's traffic."""
        with self._lock:
            st = self._sites.get(site)
            if not st:
                return None
            scales = (st["scales"] if bucket is None else
                      st["buckets"].get(int(bucket), {}).get("scales", {}))
            if not scales:
                return None
            total = sum(scales.values())
            return int(round(sum(s * w for s, w in scales.items())
                             / max(total, 1)))

    def hot_sites(self, min_tokens: int = 1) -> List[str]:
        """Sites with at least ``min_tokens`` observed, hottest first."""
        with self._lock:
            return [site for site, st in
                    sorted(self._sites.items(),
                           key=lambda kv: -kv[1]["tokens"])
                    if st["tokens"] >= min_tokens]

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {site: {"calls": st["calls"], "tokens": st["tokens"],
                           "kinds": dict(st["kinds"]),
                           "scales": dict(st["scales"]),
                           "buckets": {b: {"tokens": bk["tokens"],
                                           "scales": dict(bk["scales"])}
                                       for b, bk in st["buckets"].items()}}
                    for site, st in self._sites.items()}

    def reset(self) -> None:
        with self._lock:
            self._sites.clear()


telemetry = Telemetry()
