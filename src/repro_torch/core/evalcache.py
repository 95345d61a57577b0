"""Shared evaluation cache + persistent campaign results database.

Port of ``repro.core.evalcache`` (pure Python), with byte-compatible JSONL:
a journal written by either package replays through the other's reader,
compaction-epoch markers included.

The paper's framework amortizes optimization cost by never paying the
full-application build per candidate; the campaign engine extends the
same economics across candidates: a **content-addressed cache** keyed by
the complete evaluation spec — (case, variant, scale, platform) plus the
timing/FE parameters that affect the outcome — guarantees that no
variant is ever built, FE-checked, or timed twice, within a campaign or
across restarts (the cache persists as append-only JSONL).

Two layers live here:

* ``EvalCache``  — the content-addressed store.  ``get_or_compute`` is
  the only entry point workers need: it returns a cached record, waits
  on an in-flight computation of the same key (cross-case candidate
  dedup under concurrency), or runs the computation and publishes it.
* ``ResultsDB``  — the campaign manifest: an append-only JSONL journal
  of campaign_start / round / case_result / campaign_end records that
  survives restarts and backs the BENCH_* trajectory across PRs.

Both are safe to share between *processes*, not just threads — the
substrate the out-of-process worker fabric (``repro_torch.core.workers``)
runs on:

* Every JSONL append is a single ``write()`` on an ``O_APPEND`` fd, so
  concurrent writers never interleave partial lines.
* A cache miss takes a per-key advisory file lock (``flock``) before
  computing, re-reading the tail of the shared file first — so two
  worker processes racing on the same key compute it exactly once
  (the cross-process analogue of the in-thread pending-event dedup).

Measured (wall-clock) entries additionally carry the cache's
**namespace** — hostname + platform fingerprint — and are rejected on
lookup when the namespace differs or the record is older than the
staleness TTL (``REPRO_CACHE_TTL_S``): a persisted timing replays the
machine conditions under which it was taken, so cross-host or long-stale
wall-clock numbers must never be mixed into one speedup ratio.  Analytic
platforms are immune (timings are pure functions of the spec) and their
records are never expired.  Rejections are counted in the ``stale`` stat.
"""
from __future__ import annotations

import hashlib
import json
import os
import socket
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

try:                      # POSIX advisory locking; absent → thread-only dedup
    import fcntl
except ImportError:       # pragma: no cover - non-POSIX hosts
    fcntl = None  # type: ignore[assignment]

from repro_torch.core.kernelcase import Variant


def this_host() -> str:
    """The host identity every per-host resolution rule keys on: the
    measured-cache namespace, the timing-lease host scope, and the
    journals' host provenance.  ``REPRO_HOST_ALIAS`` overrides the real
    hostname so a simulated fleet (N worker servers on one machine,
    loopback sockets) exercises the exact cross-host code paths."""
    return os.environ.get("REPRO_HOST_ALIAS") or socket.gethostname()


def default_namespace() -> str:
    """Identity of the measurement conditions: hostname + platform
    fingerprint.  Wall-clock timings taken under a different namespace
    are not comparable and must not replay from the shared cache."""
    import platform as _pyplat
    return (f"{this_host()}:{_pyplat.machine()}"
            f":py{_pyplat.python_version()}:cpus={os.cpu_count()}")


def canonical_spec(case_name: str, variant: Variant, scale: int,
                   platform: str, *, kind: str = "eval",
                   **params: Any) -> Dict[str, Any]:
    """The full evaluation spec.  ``kind`` separates measure-only records
    (baseline timing, no FE) from full build→FE→time evaluations;
    ``params`` carries whatever else changes the outcome (r, k, FE input
    sets, ...)."""
    spec: Dict[str, Any] = {
        "kind": kind, "case": case_name,
        "variant": {k: variant[k] for k in sorted(variant)},
        "scale": int(scale), "platform": platform,
    }
    spec.update(params)
    return spec


def spec_key(spec: Dict[str, Any]) -> str:
    blob = json.dumps(spec, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:20]


def json_safe(obj: Any) -> Any:
    """Recursively replace non-finite floats with None: json.dumps would
    emit the non-RFC token ``Infinity``, breaking strict JSONL consumers
    of the cache/journal files."""
    if isinstance(obj, float):
        return obj if obj == obj and abs(obj) != float("inf") else None
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


def append_jsonl(path: str, rec: Dict[str, Any]) -> int:
    """Append one record as a single ``write()`` on an ``O_APPEND`` fd.
    POSIX guarantees the offset-advance+write is atomic per syscall, so
    concurrent appenders — threads or *processes* — never interleave
    partial lines.  Returns the number of bytes written."""
    data = (json.dumps(rec, default=str) + "\n").encode()
    fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        os.write(fd, data)
    finally:
        os.close(fd)
    return len(data)


# ---------------------------------------------------------------------------
# compaction-epoch markers (replication coordination)
# ---------------------------------------------------------------------------
# Compacting a journal rewrites it through ``os.replace`` — an inode
# swap that invalidates every byte offset other readers hold, including
# the ``repro_torch.core.replicate`` tail-ship loop's.  Every compaction
# therefore (1) first drains any live Replicator whose link ends at
# this journal, so nothing appended-but-not-yet-shipped is folded away,
# and (2) writes a **compaction-epoch marker** as the rewritten file's
# last line.  A resyncing tail finds the last marker and resumes just
# past it: everything before the marker is the compacted snapshot
# (replayed through the shipped-digest filter, so nothing re-ships),
# everything after is fresh appends.  Markers are per-file coordination
# state and are never shipped across a link.

COMPACT_EV = "compact"


def compaction_marker(epoch: int) -> Dict[str, Any]:
    """The journal line a compaction writes last: names the rewrite so
    offset-tracking readers can distinguish 'compacted' from
    'truncated/rotated' and resume precisely."""
    return {"ev": COMPACT_EV, "epoch": int(epoch), "host": this_host(),
            "pid": os.getpid(), "ts": time.time()}


def marker_epoch(line: bytes) -> Optional[int]:
    """The epoch if ``line`` is a compaction marker, else None."""
    if b'"ev"' not in line:
        return None
    try:
        obj = json.loads(line.decode("utf-8", errors="replace"))
    except ValueError:
        return None
    if isinstance(obj, dict) and obj.get("ev") == COMPACT_EV:
        try:
            return int(obj.get("epoch", 0))
        except (TypeError, ValueError):
            return 0
    return None


def drain_replicas(path: str) -> int:
    """Pre-compaction coordination: synchronously pump every live
    Replicator with ``path`` as a link endpoint, so lines appended since
    the last sweep ship verbatim before the rewrite folds them into the
    snapshot.  Must be called *before* taking the store flock (the pump
    appends under the destination's flock).  A no-op when
    ``repro_torch.core.replicate`` was never imported."""
    if not path:
        return 0
    import sys
    mod = sys.modules.get("repro_torch.core.replicate")
    if mod is None:
        return 0
    return mod.drain_endpoint(path)


@dataclass
class EvalRecord:
    status: str = "ok"            # ok | build_error | fe_fail | run_error
    time_s: float = float("inf")
    fe_abs_err: float = 0.0
    repairs: int = 0
    error: str = ""
    final_variant: Dict[str, Any] = field(default_factory=dict)
    key: str = ""
    spec: Dict[str, Any] = field(default_factory=dict)
    ts: float = 0.0
    ns: str = ""                  # namespace the record was taken under
    measured: bool = False        # wall-clock (True) vs analytic timing
    # measurement fidelity (adaptive engine): how the timing was taken,
    # so a replayed record is auditable and a raced-out partial timing
    # is never mistaken for a full eq. 3 measurement
    reps: int = 0                 # reps actually collected (0 → legacy)
    r_cap: int = 0                # eq. 3 cap that was in force
    ci_half_width_s: float = 0.0  # CI half-width of the trimmed mean
    raced_out: bool = False       # timing aborted by incumbent racing
    lower_bound_s: float = 0.0    # optimistic bound the race compared

    def to_dict(self) -> Dict[str, Any]:
        return json_safe(asdict(self))

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "EvalRecord":
        rec = EvalRecord(**{k: d[k] for k in
                            ("status", "time_s", "fe_abs_err", "repairs",
                             "error", "final_variant", "key", "spec", "ts",
                             "ns", "measured", "reps", "r_cap",
                             "ci_half_width_s", "raced_out",
                             "lower_bound_s")
                            if k in d and d[k] is not None})
        # a None time_s (json_safe maps inf → None on disk) was dropped
        # by the filter above, so the field default float("inf") applies
        return rec


class FileLock:
    """Advisory exclusive file lock (``flock``), shared by the eval
    cache's per-key locks and the PatternStore's per-store lock.  Lock
    files are never unlinked (unlink+recreate races would let two
    holders coexist); they are empty and reusable.  A no-op on hosts
    without ``fcntl`` (degrades to thread-only safety)."""

    def __init__(self, path: str):
        self.path = path
        self.fd: Optional[int] = None

    def __enter__(self) -> "FileLock":
        if fcntl is not None:
            self.fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
            fcntl.flock(self.fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc) -> None:
        if self.fd is not None:
            fcntl.flock(self.fd, fcntl.LOCK_UN)
            os.close(self.fd)
            self.fd = None


class _KeyFileLock(FileLock):
    """Per-key lock file under ``<cache>.locks/``: the exclusive holder
    computes; every other process blocks in ``__enter__`` and then finds
    the published record on disk.  Bounded by the number of distinct
    keys."""

    def __init__(self, locks_dir: str, key: str):
        os.makedirs(locks_dir, exist_ok=True)
        super().__init__(os.path.join(locks_dir, f"{key}.lock"))


class EvalCache:
    """Thread- and process-safe content-addressed evaluation cache with
    optional JSONL persistence.  Duplicate keys resolve to the last
    record."""

    COMPACT_MIN_LINES = 256  # journal lines before compaction considered
    COMPACT_RATIO = 4        # compact when lines > ratio * distinct keys

    def __init__(self, path: Optional[str] = None, *,
                 namespace: Optional[str] = None,
                 ttl_s: Optional[float] = None):
        self.path = path
        # ns_explicit distinguishes a caller-pinned namespace (shipped
        # verbatim over the spec wire) from the host-derived default —
        # a worker on ANOTHER host must re-derive the default locally,
        # or its measured records would be stamped with the scheduler's
        # host and wrongly replay there (see workers.job_to_spec)
        self.ns_explicit = namespace is not None
        self.namespace = namespace if namespace is not None \
            else default_namespace()
        if ttl_s is None:
            env = os.environ.get("REPRO_CACHE_TTL_S", "")
            ttl_s = float(env) if env else None
        self.ttl_s = ttl_s           # None → measured entries never expire
        self._lock = threading.Lock()
        self._records: Dict[str, EvalRecord] = {}
        self._pending: Dict[str, threading.Event] = {}
        self._offset = 0             # how far into the file we have read
        self._ino: Optional[int] = None
        self._lines = 0              # journal lines behind the view
        self._epoch = 0              # last compaction epoch replayed
        self.hits = 0
        self.misses = 0
        self.waits = 0        # in-flight dedup: waited on another worker
        self.stale = 0        # measured records rejected (namespace / TTL)
        if path and os.path.exists(path):
            with self._lock:
                self._reload_locked()

    # ------------------------------------------------------------------
    def _reload_locked(self) -> None:
        """Read records appended since the last load (our own or another
        process's).  Caller holds self._lock.  A final line without a
        trailing newline is a write still in flight — leave it for the
        next reload rather than consuming a torn prefix.  The stat is an
        ``fstat`` on the opened fd so the inode-swap check and the read
        see the same file: when another process compacted the journal
        (inode changed, or it shrank below our offset) the view is
        rebuilt from the rewritten file — replay is last-wins per key,
        so nothing is lost."""
        if not self.path or not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            st = os.fstat(f.fileno())
            if self._ino is not None and \
                    (st.st_ino != self._ino or st.st_size < self._offset):
                self._offset, self._lines = 0, 0
                self._records = {}
            self._ino = st.st_ino
            f.seek(self._offset)
            data = f.read()
        if not data:
            return
        end = data.rfind(b"\n") + 1
        if end == 0:
            return                    # only an unfinished line so far
        self._offset += end
        for line in data[:end].splitlines():
            line = line.strip()
            if not line:
                continue
            self._lines += 1
            try:
                obj = json.loads(line.decode())
                if isinstance(obj, dict) and obj.get("ev") == COMPACT_EV:
                    self._epoch = max(self._epoch,
                                      int(obj.get("epoch", 0) or 0))
                    continue
                rec = EvalRecord.from_dict(obj)
            except (ValueError, TypeError, KeyError, UnicodeDecodeError):
                # a crash mid-append leaves a torn line; losing one
                # record must not lose the whole cache
                continue
            if rec.key:
                self._records[rec.key] = rec

    def _fresh_locked(self, key: str) -> Optional[EvalRecord]:
        """The record for ``key`` unless it is a stale measured entry
        (different namespace, or past the TTL).  Measured-ness is the
        ``measured`` flag stamped at publish time (the evaluator sets it
        for wall-clock platforms).  Caller holds _lock."""
        rec = self._records.get(key)
        if rec is None:
            return None
        if rec.measured:
            if rec.ns and self.namespace and rec.ns != self.namespace:
                self.stale += 1
                return None
            if self.ttl_s is not None and rec.ts \
                    and time.time() - rec.ts > self.ttl_s:
                self.stale += 1
                return None
        return rec

    # ------------------------------------------------------------------
    def lookup(self, spec: Dict[str, Any]) -> Optional[EvalRecord]:
        with self._lock:
            return self._fresh_locked(spec_key(spec))

    def get_or_compute(self, spec: Dict[str, Any],
                       compute: Callable[[], EvalRecord], *,
                       measured: bool = False,
                       accept: Optional[Callable[[EvalRecord], bool]] = None
                       ) -> Tuple[EvalRecord, bool]:
        """Return ``(record, was_hit)``.  If another worker — a thread of
        this process or, when the cache is file-backed, *any process
        sharing the file* — is already computing the same key, wait for
        its result instead of recomputing.  ``measured=True`` marks the
        record as a wall-clock timing subject to namespace/TTL staleness
        checks on later lookups.  ``accept`` lets the caller veto a
        cached record that is not valid in its context — the adaptive
        engine uses it to re-measure a ``raced_out`` partial timing when
        the incumbent it lost to is no longer the incumbent — vetoed
        records are recomputed and the fresh record replaces the old one
        (last-wins, same key)."""
        key = spec_key(spec)
        while True:
            with self._lock:
                rec = self._fresh_locked(key)
                if rec is not None and (accept is None or accept(rec)):
                    self.hits += 1
                    return rec, True
                ev = self._pending.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._pending[key] = ev
                    break
                self.waits += 1
            ev.wait()
        try:
            if self.path and fcntl is not None:
                with _KeyFileLock(f"{self.path}.locks", key):
                    # another process may have published while we waited
                    # for the lock (or before we ever looked): re-read
                    # the shared file's tail before paying the compute
                    with self._lock:
                        self._reload_locked()
                        rec = self._fresh_locked(key)
                        if rec is not None and (accept is None
                                                or accept(rec)):
                            self.hits += 1
                            self.waits += 1
                            return rec, True
                    return self._compute_and_publish(
                        key, spec, compute, measured), False
            return self._compute_and_publish(key, spec, compute,
                                             measured), False
        finally:
            with self._lock:
                self._pending.pop(key, None)
            ev.set()

    def _compute_and_publish(self, key: str, spec: Dict[str, Any],
                             compute: Callable[[], EvalRecord],
                             measured: bool) -> EvalRecord:
        rec = compute()
        rec.key, rec.spec, rec.ts = key, spec, time.time()
        rec.ns = self.namespace
        rec.measured = measured
        with self._lock:
            self._records[key] = rec
            self.misses += 1
            self._append_locked(rec)
        return rec

    def reload(self) -> None:
        """Fold records appended by other processes (the worker fabric)
        into this process's in-memory view."""
        with self._lock:
            self._reload_locked()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "waits": self.waits, "stale": self.stale,
                    "entries": len(self._records)}

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    # ------------------------------------------------------------------
    def _append_locked(self, rec: EvalRecord) -> None:
        # caller holds self._lock
        if not self.path:
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        # the store flock serializes this append against a concurrent
        # compaction's read-merge-os.replace in another process — an
        # unlocked append landing between the snapshot read and the
        # replace would be silently dropped by the rewrite
        with FileLock(self.path + ".lock"):
            append_jsonl(self.path, rec.to_dict())
        self._lines += 1
        self._maybe_compact_locked()

    def _maybe_compact_locked(self) -> None:
        if not self.path or self._lines < self.COMPACT_MIN_LINES:
            return
        if self._lines <= self.COMPACT_RATIO * max(1, len(self._records)):
            return
        self._compact_locked()

    def compact(self) -> None:
        """Force a journal compaction: rewrite the file as one line per
        distinct key (all namespaces preserved — a measured record from
        another host must survive the rewrite even though *this* cache
        would reject it on lookup), ending with a compaction-epoch
        marker so replication tails resync instead of re-shipping."""
        with self._lock:
            self._compact_locked()

    def _compact_locked(self) -> None:
        """Caller holds self._lock (and must NOT hold the store flock:
        the pre-compaction replica drain appends under it)."""
        if not self.path:
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        drain_replicas(self.path)
        with FileLock(self.path + ".lock"):
            self._reload_locked()
            self._epoch += 1
            tmp = f"{self.path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                for rec in self._records.values():
                    f.write(json.dumps(rec.to_dict(), default=str) + "\n")
                f.write(json.dumps(compaction_marker(self._epoch),
                                   default=str) + "\n")
            os.replace(tmp, self.path)
            st = os.stat(self.path)
            self._offset, self._ino = st.st_size, st.st_ino
            self._lines = len(self._records) + 1


class ResultsDB:
    """Append-only JSONL journal of campaign progress.  Each line is a
    self-describing record: {"kind": ..., "ts": ..., **fields}.

    Safe for concurrent writers across threads *and processes*: every
    ``append`` is one O_APPEND ``write()`` syscall, so records from the
    out-of-process worker fabric land whole, never interleaved."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def append(self, kind: str, **fields: Any) -> Dict[str, Any]:
        rec = json_safe({"kind": kind, "ts": time.time(), **fields})
        with self._lock:
            append_jsonl(self.path, rec)
        return rec

    def records(self, kind: Optional[str] = None) -> Iterator[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:     # torn line from a crashed writer
                    continue
                if kind is None or rec.get("kind") == kind:
                    yield rec
