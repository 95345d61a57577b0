"""Performance Pattern Inheritance (paper §3.2), cross-process.

Port of ``repro.core.patterns`` (pure Python), with the same journal format
(compaction-epoch markers included): a store written by either package
replays through the other's reader.

Effective optimization patterns (tiling choices, memory strategies,
algorithmic restructurings) discovered while optimizing one kernel are
summarized and injected as hints for later rounds, *other kernels of the
same family*, and *other platforms* — this is what let the paper transfer
NVIDIA-discovered strategies to the DCU.

The store is an **append-only JSONL journal** sharing the EvalCache's
multi-process recipe (``repro_torch.core.evalcache``):

* Every observation is one ``O_APPEND`` single-``write()`` line, so
  concurrent recorders — campaign worker threads or *worker processes*
  across the evaluation fabric — never interleave partial lines.
* Appends and compaction serialize on a per-store advisory ``flock``
  (``<store>.lock``), so a reader never sees a half-rewritten file.
* ``suggest`` tail-reloads the journal first, folding in observations
  appended by other processes since the last read — a pattern recorded
  by one worker process is visible to every other worker's *next round*
  of the same campaign, not just after the campaign ends.
* Replay **merges**: identical ``(family, platform, delta)`` keeps the
  best observed gain, so the in-memory view is order-insensitive and
  duplicate observations cost nothing.
* When the journal grows well past the merged state (default: > 64
  lines and > 4x the distinct patterns), it is **compacted** in place —
  rewritten to one line per merged pattern via ``os.replace`` under the
  store lock.  Other processes detect the rewrite (inode change /
  shrink) and transparently replay the compacted journal.
* Records carry the EvalCache wire conventions' provenance fields:
  ``ns`` (hostname+platform namespace) and ``pid`` (recording process),
  plus ``ts``.  Unlike measured timings, patterns are *meant* to cross
  namespaces (the paper's cross-platform inheritance), so provenance is
  informational — nothing is rejected on lookup.

Besides pattern lines, the journal carries **hint-outcome events**
(``{"ev": "hint", ...}``: this pattern was suggested to that kernel, did
its delta end up in the round winner?).  Replay folds them into a
per-(delta, receiving family, bottleneck) acceptance ledger that
``suggest`` uses to demote patterns that keep being suggested but never
win; compaction rewrites the ledger as aggregate ``{"ev": "acc", ...}``
lines.  Patterns themselves are tagged with the diagnosed bottleneck
they were won under (``core.diagnosis``).

Corrupt journal lines (a crash mid-``os.replace``, a torn concurrent
write, a legacy truncated file) are tolerated: bad lines are quarantined
to ``<store>.quarantine`` with a warning instead of poisoning the load.
A legacy whole-file JSON array store (the pre-journal format) is
migrated to the journal form on first open.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.evalcache import (COMPACT_EV, FileLock, append_jsonl,
                                  compaction_marker, default_namespace,
                                  drain_replicas, json_safe)
from repro_torch.core.kernelcase import KernelCase, Variant


@dataclass
class Pattern:
    family: str
    platform: str
    delta: Dict[str, Any]          # variant keys that changed
    gain: float                    # speedup attributed to the delta
    source_kernel: str
    ts: float = field(default_factory=time.time)
    ns: str = ""                   # namespace recorded under (provenance)
    pid: int = 0                   # recording process (provenance)
    bottleneck: str = ""           # diagnosis the win was recorded under

    def to_dict(self) -> Dict[str, Any]:
        return {"family": self.family, "platform": self.platform,
                "delta": self.delta, "gain": self.gain,
                "source_kernel": self.source_kernel, "ts": self.ts,
                "ns": self.ns, "pid": self.pid,
                "bottleneck": self.bottleneck}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Pattern":
        return Pattern(d["family"], d["platform"], dict(d["delta"]),
                       float(d["gain"]), d.get("source_kernel", "?"),
                       d.get("ts", 0.0), d.get("ns", ""),
                       int(d.get("pid", 0)),
                       str(d.get("bottleneck", "")))

    def merge_key(self) -> Tuple[str, str, str]:
        return (self.family, self.platform,
                json.dumps(self.delta, sort_keys=True, default=str))


def _acc_stats(acc: Dict[Tuple[str, str, str], List[int]],
               delta_key: str, family: str,
               bottleneck: str) -> Tuple[int, int]:
    """Acceptance tally for (delta, receiving family): the exact
    bottleneck bucket when it has data, else the aggregate across all
    bottlenecks (a pattern that loses everywhere should be demoted even
    for a bottleneck it hasn't been tried under)."""
    if bottleneck:
        st = acc.get((delta_key, family, bottleneck))
        if st is not None:
            return st[0], st[1]
    n = w = 0
    for (dk, fam, _bn), (sn, sw) in acc.items():
        if dk == delta_key and fam == family:
            n += sn
            w += sw
    return n, w


class _StoreLock(FileLock):
    """Advisory whole-store lock (``<store>.lock``): serializes appends
    against compaction's read-merge-``os.replace``.  The lock lives in a
    side file because ``os.replace`` swaps the journal's inode — a lock
    on the journal fd itself would silently stop excluding anyone."""

    def __init__(self, path: str):
        super().__init__(path + ".lock")


class PatternStore:
    """Thread- and process-safe Performance Pattern Inheritance store
    with optional JSONL journal persistence."""

    MIN_GAIN = 1.02          # below this a win is noise, not a pattern
    COMPACT_MIN_LINES = 64   # journal lines before compaction considered
    COMPACT_RATIO = 4        # compact when lines > ratio * merged patterns

    def __init__(self, path: Optional[str] = None, *,
                 namespace: Optional[str] = None):
        self.path = path
        # like EvalCache: a host-derived default namespace must be
        # re-derived by workers on other hosts (the wire form ships
        # None), so pattern provenance names the host that actually
        # recorded the win — patterns still cross namespaces freely
        self.ns_explicit = namespace is not None
        self.namespace = namespace if namespace is not None \
            else default_namespace()
        self._lock = threading.Lock()
        self._merged: Dict[Tuple[str, str, str], Pattern] = {}
        # acceptance ledger: (delta_json, receiving_family, bottleneck)
        # → [times_suggested, times_won], replayed from the journal's
        # "hint"/"acc" event lines (same provenance conventions)
        self._acc: Dict[Tuple[str, str, str], List[int]] = {}
        self._offset = 0         # how far into the journal we have read
        self._ino: Optional[int] = None
        self._lines = 0          # journal lines behind the merged view
        self._epoch = 0          # last compaction epoch seen (monotonic)
        self._dirty = False      # journal holds quarantined (bad) lines
        self.quarantined = 0     # corrupt lines shunted aside, cumulative
        if path and os.path.exists(path):
            with self._lock:
                self._reload_locked()

    # -------------------------------------------------------- wire form --
    def to_spec(self) -> Dict[str, Any]:
        """Shared-state coordinates a worker process rebuilds the store
        from (the EvalCache wire convention: path + namespace)."""
        if not self.path:
            raise ValueError(
                "subprocess executors need a file-backed PatternStore "
                "(or none): an in-memory store cannot be shared across "
                "processes")
        return {"path": self.path,
                "ns": self.namespace if self.ns_explicit else None}

    @staticmethod
    def from_spec(spec: Dict[str, Any]) -> "PatternStore":
        return PatternStore(spec["path"], namespace=spec.get("ns"))

    # ------------------------------------------------------------------
    @property
    def patterns(self) -> List[Pattern]:
        with self._lock:
            return list(self._merged.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._merged)

    def reload(self) -> None:
        """Fold journal lines appended by other processes (the worker
        fabric) into this process's merged view."""
        with self._lock:
            self._reload_locked()

    # ------------------------------------------------------------------
    def record(self, case: KernelCase, platform: str, baseline: Variant,
               best: Variant, gain: float, *,
               bottleneck: str = "") -> Optional[Pattern]:
        """Summarize the winning strategy as a delta vs the baseline.

        ``bottleneck`` tags the pattern with the diagnosis it was won
        under (``core.diagnosis`` vocabulary), so later suggestions can
        prefer patterns that fixed the *same* kind of slowness.

        Safe under concurrent campaign workers — threads *and* worker
        processes sharing the journal file: an identical (family,
        platform, delta) merges into the existing pattern (keeping the
        best observed gain) instead of accumulating duplicates, and
        every improving observation is journaled as one atomic append."""
        delta = {k: v for k, v in best.items() if baseline.get(k) != v}
        if not delta or not gain < float("inf") or gain <= self.MIN_GAIN:
            # non-finite gain (a zero/failed timing) would journal as
            # "gain": null (json_safe) and be quarantined on every
            # replay — reject it here, like a below-threshold win
            return None
        p = Pattern(case.family, platform, delta, gain, case.name,
                    ns=self.namespace, pid=os.getpid(),
                    bottleneck=bottleneck)
        with self._lock:
            kept, improved = self._merge_locked(p)
            if improved:
                self._append_locked(p.to_dict())
                self._maybe_compact_locked()
        return kept

    def record_hint_outcome(self, case: KernelCase, platform: str,
                            pattern: Pattern, *, won: bool,
                            bottleneck: str = "") -> None:
        """Journal that ``pattern`` was suggested to ``case`` and whether
        its delta ended up in the round winner.  The per-(delta,
        receiving family, bottleneck) tally feeds ``suggest_patterns``
        ranking: patterns repeatedly suggested but never winning on the
        receiving kernel are demoted below fresh equal-gain ones."""
        ev = {"ev": "hint",
              "delta": pattern.delta, "family": case.family,
              "case": case.name, "platform": platform,
              "bottleneck": bottleneck, "won": bool(won),
              "ns": self.namespace, "pid": os.getpid(),
              "ts": time.time()}
        with self._lock:
            if self.path:
                # the append's tail fold counts our own line exactly once
                self._append_locked(ev)
                self._maybe_compact_locked()
            else:
                self._fold_event_locked(ev)

    def acceptance(self, delta: Dict[str, Any], family: str,
                   bottleneck: str = "") -> Tuple[int, int]:
        """(times_suggested, times_won) for a delta on a receiving
        family — exact bottleneck bucket when it has data, else the
        aggregate across bottlenecks."""
        key = json.dumps(delta, sort_keys=True, default=str)
        with self._lock:
            self._reload_locked()
            n, w = self._acc_stats_locked(key, family, bottleneck)
        return n, w

    def suggest(self, case: KernelCase, platform: str,
                max_hints: int = 4, *,
                bottleneck: str = "") -> List[Dict[str, Any]]:
        """Hint deltas, most relevant first (see ``suggest_patterns``)."""
        return [dict(p.delta)
                for p in self.suggest_patterns(case, platform, max_hints,
                                               bottleneck=bottleneck)]

    def suggest_patterns(self, case: KernelCase, platform: str,
                         max_hints: int = 4, *,
                         bottleneck: str = "") -> List[Pattern]:
        """Ranked hints with provenance.  Ordering: patterns sourced
        from *other* kernels strictly before the case's own history
        (its own winning delta is already its baseline — echoing it
        first wastes a hint), then same family + same platform, then
        same family cross-platform (the paper's cross-platform
        inheritance), then generic high-gain patterns.  Two learned
        signals modulate the score: a ×2 boost when the pattern was won
        under the same diagnosed ``bottleneck`` as the querying round,
        and a Laplace acceptance rate (wins+1)/(suggestions+2) replayed
        from the journal's hint-outcome events — a pattern repeatedly
        suggested to this family but never winning decays below a fresh
        pattern of equal gain (rate 1/2).  The journal tail is re-read
        first, so hints include wins recorded by other worker processes
        since the last call."""
        with self._lock:
            self._reload_locked()
            snapshot = list(self._merged.values())
            acc = {k: list(v) for k, v in self._acc.items()}

        def rank(p: Pattern):
            s = p.gain
            if p.family == case.family:
                s *= 4
            if p.platform == platform:
                s *= 2
            if bottleneck and p.bottleneck == bottleneck:
                s *= 2
            key = json.dumps(p.delta, sort_keys=True, default=str)
            n, w = _acc_stats(acc, key, case.family, bottleneck)
            s *= (w + 1.0) / (n + 2.0)
            return (p.source_kernel == case.name, -s)

        seen, out = set(), []
        for p in sorted(snapshot, key=rank):
            key = json.dumps(p.delta, sort_keys=True, default=str)
            if key in seen:
                continue
            seen.add(key)
            out.append(p)
            if len(out) >= max_hints:
                break
        return out

    def suggest_migrants(self, case: KernelCase, platform: str,
                         max_hints: int = 2, *,
                         bottleneck: str = "") -> List[Pattern]:
        """Island-model migration read path (population search): the
        top-ranked patterns won by *other* kernels, never the case's own
        history — its own winning deltas already live in its population,
        so re-importing them would burn paid evals on known variants.
        Same acceptance/bottleneck ranking as ``suggest_patterns``; the
        journal tail re-read there is what makes deltas recorded by
        concurrent cases' worker processes visible mid-campaign."""
        pool = self.suggest_patterns(case, platform,
                                     max_hints=max_hints * 2 + 2,
                                     bottleneck=bottleneck)
        return [p for p in pool
                if p.source_kernel != case.name][:max_hints]

    # ------------------------------------------------------------------
    def _acc_stats_locked(self, delta_key: str, family: str,
                          bottleneck: str) -> Tuple[int, int]:
        return _acc_stats(self._acc, delta_key, family, bottleneck)

    def _fold_event_locked(self, obj: Dict[str, Any]) -> None:
        """Fold one journal event line into the acceptance ledger.
        "hint": one suggested-hint outcome; "acc": a compaction-written
        aggregate (n suggestions, w wins).  Caller holds self._lock."""
        ev = obj["ev"]
        if ev == COMPACT_EV:
            # compaction-epoch marker: coordination state for the
            # replication tails, a no-op for the merged view
            self._epoch = max(self._epoch,
                              int(obj.get("epoch", 0) or 0))
            return
        key = (json.dumps(obj.get("delta", {}), sort_keys=True,
                          default=str),
               str(obj.get("family", "")), str(obj.get("bottleneck", "")))
        st = self._acc.setdefault(key, [0, 0])
        if ev == "hint":
            st[0] += 1
            st[1] += 1 if obj.get("won") else 0
        elif ev == "acc":
            st[0] += int(obj.get("n", 0))
            st[1] += int(obj.get("w", 0))
        else:
            raise ValueError(f"unknown journal event {ev!r}")

    # ------------------------------------------------------------------
    def _merge_locked(self, p: Pattern) -> Tuple[Pattern, bool]:
        """Fold one observation into the merged view; returns the kept
        pattern and whether it improved the state (new delta or better
        gain).  Caller holds self._lock."""
        key = p.merge_key()
        q = self._merged.get(key)
        if q is None:
            self._merged[key] = p
            return p, True
        if p.gain > q.gain:
            self._merged[key] = p
            return p, True
        return q, False

    # ------------------------------------------------------------------
    def _read_tail_locked(self) -> bytes:
        """Read the journal bytes appended since the last load (our own
        or another process's), advancing nothing yet.  The stat is an
        ``fstat`` on the opened fd, so the inode-swap check and the read
        always see the *same* file — a compaction's ``os.replace``
        landing between a path-stat and the open could otherwise make
        us seek a stale offset into the new file and quarantine valid
        lines.  If the file was compacted (inode changed, or it shrank
        below our offset), the merged view is rebuilt from the new
        journal — replay is order-insensitive, so nothing is lost.
        Caller holds self._lock."""
        if not self.path:
            return b""
        try:
            f = open(self.path, "rb")
        except OSError:
            return b""
        with f:
            st = os.fstat(f.fileno())
            if self._ino is not None and \
                    (st.st_ino != self._ino or st.st_size < self._offset):
                self._offset, self._lines = 0, 0
                self._merged = {}
                self._acc = {}
            self._ino = st.st_ino
            f.seek(self._offset)
            return f.read()

    def _fold_lines_locked(self, data: bytes) -> None:
        """Merge whole journal lines from ``data`` and advance the
        offset past them.  A final line without a trailing newline is a
        write still in flight — left for the next reload.  Caller holds
        self._lock."""
        end = data.rfind(b"\n") + 1
        if end == 0:
            return                    # only an unfinished line so far
        self._offset += end
        bad: List[bytes] = []
        for line in data[:end].splitlines():
            line = line.strip()
            if not line:
                continue
            self._lines += 1
            try:
                obj = json.loads(line.decode())
                if isinstance(obj, dict) and "ev" in obj:
                    self._fold_event_locked(obj)
                else:
                    self._merge_locked(Pattern.from_dict(obj))
            except (ValueError, TypeError, KeyError, UnicodeDecodeError):
                bad.append(line)
        if bad:
            self._quarantine_locked(bad)

    def _reload_locked(self) -> None:
        """Fold journal lines appended since the last load; migrates a
        legacy whole-file JSON array on first read.  Caller holds
        self._lock (and must NOT hold the store flock: migration
        compacts, which takes it)."""
        data = self._read_tail_locked()
        if data:
            if self._offset == 0 and data.lstrip()[:1] == b"[":
                self._migrate_legacy_locked(data)
                return
            self._fold_lines_locked(data)
        if self._dirty:
            # rewrite the journal without the quarantined line(s): a
            # torn line must be shunted aside ONCE, not re-quarantined
            # (and re-warned) by every future reader of the store
            self._compact_locked()

    def _reload_under_flock_locked(self) -> None:
        """Tail fold for callers already holding the store flock
        (append, compact): never recurses into legacy migration or
        compaction, which would re-take the flock and self-deadlock."""
        data = self._read_tail_locked()
        if not data or (self._offset == 0 and data.lstrip()[:1] == b"["):
            return        # legacy body: the unflocked reload migrates it
        self._fold_lines_locked(data)

    def _migrate_legacy_locked(self, data: bytes) -> None:
        """Pre-journal stores were one whole-file JSON array, rewritten
        in full on every record — not multi-process safe, and a crash
        mid-``os.replace`` left them truncated.  Fold what parses,
        quarantine what doesn't, and rewrite as a journal."""
        try:
            entries = json.loads(data.decode())
            for d in entries:
                self._merge_locked(Pattern.from_dict(d))
        except (ValueError, TypeError, KeyError, UnicodeDecodeError):
            self._quarantine_locked([data.rstrip(b"\n")])
        self._compact_locked()        # rewrite in journal form

    def _quarantine_locked(self, lines: List[bytes]) -> None:
        self.quarantined += len(lines)
        self._dirty = True
        if self.path:
            try:
                fd = os.open(self.path + ".quarantine",
                             os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
                try:
                    os.write(fd, b"\n".join(lines) + b"\n")
                finally:
                    os.close(fd)
            except OSError:
                pass
        warnings.warn(
            f"PatternStore {self.path}: quarantined {len(lines)} corrupt "
            f"journal line(s) to {self.path}.quarantine (crash mid-write "
            f"or legacy/truncated store); continuing with the rest",
            RuntimeWarning, stacklevel=2)

    # ------------------------------------------------------------------
    def _append_locked(self, obj: Dict[str, Any]) -> None:
        """Append one journal line (a pattern dict or an event dict)."""
        if not self.path:
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with _StoreLock(self.path):
            append_jsonl(self.path, json_safe(obj))
            # fold the tail through the shared reader (our own line plus
            # anything other processes appended): the line is counted
            # into _lines exactly once and the offset lands at EOF, so
            # later reloads don't double-count it toward compaction —
            # and acceptance events tally exactly once, here
            self._reload_under_flock_locked()

    def _merged_lines(self) -> int:
        """Lines a compaction would write: one per pattern + one per
        acceptance-ledger bucket + the epoch marker."""
        return len(self._merged) + len(self._acc) + 1

    def _maybe_compact_locked(self) -> None:
        if not self.path or self._lines < self.COMPACT_MIN_LINES:
            return
        if self._lines <= self.COMPACT_RATIO * max(1, self._merged_lines()):
            return
        self._compact_locked()

    def compact(self) -> None:
        """Force a journal compaction (replication-safe: any live
        Replicator ending at this journal is drained first, and the
        rewrite closes with a compaction-epoch marker the tails resync
        on)."""
        with self._lock:
            self._compact_locked()

    def _compact_locked(self) -> None:
        """Rewrite the journal as one line per merged pattern, under the
        store lock so no concurrent append lands between the tail read
        and the ``os.replace`` (it would be silently dropped).  Caller
        must NOT hold the store flock: the pre-compaction replica drain
        appends under it."""
        if not self.path:
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        drain_replicas(self.path)
        with _StoreLock(self.path):
            self._reload_under_flock_locked()
            self._epoch += 1
            tmp = f"{self.path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                for p in self._merged.values():
                    f.write(json.dumps(json_safe(p.to_dict()),
                                       default=str) + "\n")
                for (dk, fam, bn), (n, w) in self._acc.items():
                    f.write(json.dumps(json_safe(
                        {"ev": "acc", "delta": json.loads(dk),
                         "family": fam, "bottleneck": bn,
                         "n": n, "w": w}), default=str) + "\n")
                f.write(json.dumps(compaction_marker(self._epoch),
                                   default=str) + "\n")
            os.replace(tmp, self.path)
            st = os.stat(self.path)
            self._offset, self._ino = st.st_size, st.st_ino
            self._lines = self._merged_lines()
            self._dirty = False      # the rewrite dropped any bad lines
