"""Thin append-replication for the fleet's shared JSONL journals.

Port of ``repro.core.replicate`` (pure Python), line for line: a link
ships the same bytes between journals written by either package.

Every store the campaign fleet shares — the ``EvalCache`` file, the
``PatternStore`` journal, the ``ResultsDB`` manifest — has the same
shape: O_APPEND JSONL where each line is a self-contained record and
readers **merge on replay** (duplicate lines are idempotent, order
across writers does not matter, a torn trailing line is skipped until
its newline lands).  Those semantics make cross-host sharing trivial
when there is no shared filesystem: replication is *tail-ship + replay*
— read the complete lines appended to one journal since the last sweep
and append them verbatim to the other, where the store's normal
tail-reload folds them in.

The only hazard is the echo: a line shipped A→B reappears in B's tail
and would bounce back to A (and onward, forever).  A ``JournalLink``
therefore remembers the digest of every line it has shipped *in either
direction* and never ships it twice.  A side effect worth knowing: a
byte-identical line appended independently on both sides crosses the
link only once — harmless, because identical journal lines carry
identical information under merge-on-replay.

Journal **compaction** used to be this loop's blind spot: a store's
``os.replace`` rewrite swaps the inode and invalidates the tail's byte
offset — a stale offset into the new file ships garbage, and resetting
to zero re-ships the whole snapshot.  Both sides now coordinate:

* A compacting store first calls ``drain_endpoint`` so everything
  appended since the last sweep ships verbatim before the rewrite
  folds it away, and closes the rewritten file with a
  **compaction-epoch marker** line (``evalcache.compaction_marker``).
* ``_Tail`` fstats the journal each sweep; on an inode swap or a
  shrink below its offset it resyncs — resuming just past the last
  marker, and handing the snapshot lines before it back for
  digest-filtered *replay* (so an unseen line still crosses once, but
  nothing already shipped goes again).  A rewrite without a marker (a
  rotation or truncation underneath us) resets to offset 0 with a
  warning instead of shipping garbage from the stale offset.
* Markers and ``"ev"`` event lines inside a replayed snapshot never
  ship: markers are per-file coordination state, and a compacted
  aggregate (``{"ev": "acc", ...}``) re-shipped to a peer that already
  folded the underlying events would double-count them.
* Shipped batches append under the destination's store flock
  (``<journal>.lock``), so a batch can't land between a concurrent
  compaction's snapshot read and its ``os.replace`` (it would be
  silently dropped by the rewrite).

``RemoteExecutor`` drives this for fleet hosts configured with journal
path remaps; it is equally usable standalone (e.g. a cron rsync-less
mirror of a campaign's results journal).
"""
from __future__ import annotations

import hashlib
import os
import threading
import warnings
import weakref
from typing import Dict, List, Optional, Tuple

from repro_torch.core.evalcache import FileLock, marker_epoch


class _Tail:
    """Incremental reader of complete lines from a JSONL journal.  A
    final line without its newline is a write still in flight — left
    for the next sweep, exactly like the stores' own tail-reload."""

    def __init__(self, path: str):
        self.path = path
        self.offset = 0
        self._ino: Optional[int] = None
        self.resyncs = 0          # compactions/rotations survived

    def lines(self) -> Tuple[List[bytes], List[bytes]]:
        """``(fresh, replay)``: the complete lines appended since the
        last sweep, plus — after a compaction/rotation resync — the
        rewritten file's snapshot lines for digest-filtered replay."""
        if not os.path.exists(self.path):
            return [], []
        replay: List[bytes] = []
        with open(self.path, "rb") as f:
            st = os.fstat(f.fileno())
            if self._ino is not None and \
                    (st.st_ino != self._ino or st.st_size < self.offset):
                replay = self._resync(f)
            self._ino = st.st_ino
            f.seek(self.offset)
            data = f.read()
        end = data.rfind(b"\n") + 1
        fresh: List[bytes] = []
        if end:
            self.offset += end
            fresh = [ln for ln in data[:end].split(b"\n") if ln.strip()]
        return fresh, replay

    def _resync(self, f) -> List[bytes]:
        """The journal was rewritten underneath us.  Resume just past
        the LAST compaction-epoch marker (everything before it is the
        compacted snapshot, returned for replay); no marker means a
        rotation/truncation — restart from 0 and let the digest filter
        suppress re-ships."""
        self.resyncs += 1
        f.seek(0)
        data = f.read()
        end = data.rfind(b"\n") + 1
        snapshot: List[bytes] = []
        current: List[bytes] = []
        cut = pos = 0
        while pos < end:
            nl = data.find(b"\n", pos)
            line = data[pos:nl]
            pos = nl + 1
            if not line.strip():
                continue
            if marker_epoch(line) is not None:
                snapshot.extend(current)
                current = []
                cut = pos
            else:
                current.append(line)
        stale = self.offset
        self.offset = cut
        how = ("compaction marker found" if cut
               else "no marker: rotation/truncation")
        warnings.warn(
            f"replication tail {self.path}: journal rewritten underneath "
            f"the sweep (offset {stale} -> {cut}, {how}); resyncing "
            f"instead of shipping from the stale offset",
            RuntimeWarning, stacklevel=3)
        return snapshot


def _append_lines(path: str, lines: List[bytes]) -> None:
    """One O_APPEND write for the whole batch under the destination's
    store flock: concurrent appenders never interleave partial lines
    (same contract as ``evalcache.append_jsonl``), and a concurrent
    compaction can't drop the batch between its snapshot read and its
    ``os.replace``."""
    if not lines:
        return
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    data = b"".join(ln + b"\n" for ln in lines)
    with FileLock(path + ".lock"):
        fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)


def _is_event_line(ln: bytes) -> bool:
    if b'"ev"' not in ln:
        return False
    import json
    try:
        obj = json.loads(ln.decode("utf-8", errors="replace"))
    except ValueError:
        return False
    return isinstance(obj, dict) and "ev" in obj


class JournalLink:
    """Bidirectional tail-ship between two journal files.  ``pump()``
    ships the new complete lines each way and returns how many lines
    crossed; the shared shipped-digest set suppresses echo."""

    def __init__(self, a: str, b: str):
        self.a, self.b = a, b
        self._tails = (_Tail(a), _Tail(b))
        self._shipped: set = set()

    def pump(self) -> int:
        ta, tb = self._tails
        crossed = 0
        for src, dst in ((ta, tb), (tb, ta)):
            fresh, replay = src.lines()
            out: List[bytes] = []
            for ln in replay:
                # snapshot replay: events/aggregates would double-count
                # on a peer that already folded the underlying lines
                if _is_event_line(ln):
                    continue
                digest = hashlib.sha256(ln).digest()
                if digest in self._shipped:
                    continue
                self._shipped.add(digest)
                out.append(ln)
            for ln in fresh:
                if marker_epoch(ln) is not None:
                    continue         # markers never cross a link
                digest = hashlib.sha256(ln).digest()
                if digest in self._shipped:
                    continue                 # our own earlier shipment
                self._shipped.add(digest)
                out.append(ln)
            _append_lines(dst.path, out)
            crossed += len(out)
        return crossed


# Endpoint registry: journal path → the live Replicators with a link
# ending there, so a compacting store in the same process can drain
# pending shipments before its os.replace (see evalcache.drain_replicas)
_ENDPOINTS: Dict[str, "weakref.WeakSet"] = {}
_ENDPOINTS_LOCK = threading.Lock()


def drain_endpoint(path: str) -> int:
    """Synchronously pump every live ``Replicator`` that has ``path`` as
    a link endpoint; returns lines crossed.  Callers must not hold any
    store flock (the pump appends under the destinations' flocks)."""
    with _ENDPOINTS_LOCK:
        reps = list(_ENDPOINTS.get(os.path.abspath(path), ()))
    return sum(r.pump() for r in reps)


class Replicator:
    """A background loop pumping a set of ``JournalLink``s.  Links can
    be added while running (``add`` dedupes by path pair); ``pump()``
    forces one synchronous sweep — the fleet executor calls it after a
    campaign so every host append is home before winners are read —
    and ``stop()`` ends the thread after a final drain."""

    def __init__(self, interval_s: float = 0.2):
        self.interval_s = interval_s
        self._links: Dict[Tuple[str, str], JournalLink] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.shipped = 0               # lifetime lines crossed (telemetry)

    def add(self, a: str, b: str) -> JournalLink:
        key = (a, b) if a <= b else (b, a)
        with self._lock:
            link = self._links.get(key)
            if link is None:
                link = JournalLink(a, b)
                self._links[key] = link
        with _ENDPOINTS_LOCK:
            for p in (a, b):
                _ENDPOINTS.setdefault(os.path.abspath(p),
                                      weakref.WeakSet()).add(self)
        return link

    def pump(self) -> int:
        """One synchronous sweep over every link; safe concurrently with
        the background thread (per-link work is serialized under the
        registry lock, which also orders the offset/digest updates)."""
        with self._lock:
            crossed = sum(link.pump() for link in self._links.values())
            self.shipped += crossed
        return crossed

    # ------------------------------------------------------------------
    def start(self) -> "Replicator":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="journal-replicator",
                                            daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.pump()
            self._wake.wait(self.interval_s)
            self._wake.clear()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.pump()                    # final drain after the loop ends
