"""Spans and counters recorded inside the port, with each span's device
interval on the host's clock.

A span is a named interval of the host's wall clock (``time.time_ns``, the
clock ``torch.profiler`` stamps its events with, and perfbench's own spans
too), with the span that was open around it in the same thread as its
parent.  ``span(name, device, **attrs)`` is a context manager; ``begin`` /
``end`` handle a span that opens in one call and closes in another (a
request's wait in the queue).  ``count(name, n)`` adds to a counter.

The recorder records while a ``torch.profiler`` session is active, or
inside ``recording()``, and at no other time.  Off, ``span`` returns one
shared null context after a flag check, and ``count`` returns.  A session
starts at the first span or count made on after one made off, after a
read made off, or at ``recording()``'s start; it drops the session before.

A span opened with a CUDA ``device`` records a CUDA event on the device's
current stream when it opens and another on that stream when it closes
(none while the stream captures a CUDA graph: the span is marked
``captured``).  The
session's first such span takes an anchor: the device synchronised, an
event, then ``time.time_ns()``.  Read, each event becomes the anchor's
nanoseconds plus its time after the anchor's event, so a span's device
interval lies on the host's clock beside its host interval.

``session()`` returns the spans and counters as plain dicts and lists, and
the functions after it reduce a session: spans by name, a span's host,
device and self time, and the device's idle gaps split across the host
spans that were open while the device waited.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

OUTSIDE = "outside the program"  # idle while no span of the program was open


class _Null:
    """The context ``span`` returns while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        """Nothing: attributes are kept only while recording."""


NULL = _Null()


class _Span:
    __slots__ = ("name", "id", "parent", "thread", "attrs", "nested", "t0",
                 "t1", "device", "stream", "events", "captured")

    def __init__(self, name, sid, parent, attrs, nested, device):
        self.name, self.id, self.parent = name, sid, parent
        self.thread = threading.get_ident()
        self.attrs, self.nested = attrs, nested
        self.device, self.stream, self.events = device, None, None
        self.captured, self.t1 = False, None
        self.t0 = time.time_ns()
        if device is not None:
            _REC.start_events(self)

    def __enter__(self):
        _REC.stack().append(self)
        return self

    def __exit__(self, *exc):
        stack = _REC.stack()
        if stack and stack[-1] is self:
            stack.pop()
        _REC.close(self)
        return False

    def set(self, **attrs) -> None:
        """Adds attributes known only once the span has run."""
        self.attrs.update(attrs)


class _Recorder:
    """The session: closed spans, spans begun and not ended, counters, and
    an anchor a device."""

    def __init__(self):
        self.forced = 0                 # recording() contexts open
        self.stale = True               # the next record starts a session
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count()
        self.restart()

    def restart(self) -> None:
        self.spans: List[_Span] = []
        self.begun: Dict[int, _Span] = {}
        self.counters: Dict[str, int] = {}
        self.anchors: Dict[int, tuple] = {}
        self.streams: Dict[tuple, "torch.cuda.Stream"] = {}
        self.read: Optional[Dict] = None
        self.stale = False

    def stack(self) -> List[_Span]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def fresh(self) -> None:
        """Starts a session if the last record or read was made off."""
        if self.stale:
            with self.lock:
                if self.stale:
                    self.restart()

    def open(self, name, device, attrs, nested) -> _Span:
        self.fresh()
        stack = self.stack()
        if device is not None:
            device = torch.device(device)
            if device.type != "cuda":
                device = None
            elif device.index is None:
                device = torch.cuda.current_device()
            else:
                device = device.index
        return _Span(name, next(self.ids), stack[-1].id if stack else None,
                     attrs, nested, device)

    def start_events(self, sp: _Span) -> None:
        """The span's first timing event, on the current stream of its
        device (index ``sp.device``), which its last goes on too; none
        while that stream captures a graph (the span is marked)."""
        if torch.cuda.is_current_stream_capturing():
            sp.captured = True
            return
        # torch.cuda.current_stream builds a Stream object a call; a span
        # looks the stream up by its raw ids and keeps one object for each
        ids = torch._C._cuda_getCurrentStream(sp.device)
        stream = self.streams.get(ids)
        if stream is None:
            stream = self.streams[ids] = torch.cuda.Stream(
                stream_id=ids[0], device_index=ids[1], device_type=ids[2])
        if sp.device not in self.anchors:
            torch.cuda.synchronize(sp.device)
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record(stream)
            self.anchors[sp.device] = (anchor, time.time_ns())
        sp.stream = stream
        sp.events = [torch.cuda.Event(enable_timing=True)]
        sp.events[0].record(stream)

    def close(self, sp: _Span) -> None:
        if sp.events is not None:
            sp.events.append(torch.cuda.Event(enable_timing=True))
            sp.events[1].record(sp.stream)
        sp.t1 = time.time_ns()
        with self.lock:
            self.spans.append(sp)
            self.read = None

    def resolve(self) -> Dict:
        for device in self.anchors:
            torch.cuda.synchronize(device)
        out = []
        for sp in sorted(self.spans, key=lambda s: (s.t0, s.id)):
            dev = None
            if sp.events and len(sp.events) == 2:
                anchor, ns = self.anchors[sp.device]
                dev = [ns + int(anchor.elapsed_time(ev) * 1e6)
                       for ev in sp.events]
            out.append({"name": sp.name, "id": sp.id, "parent": sp.parent,
                        "thread": sp.thread, "attrs": dict(sp.attrs),
                        "nested": sp.nested, "t0": sp.t0, "t1": sp.t1,
                        "device": dev, "captured": sp.captured})
        return {"spans": out, "counters": dict(self.counters)}


_REC = _Recorder()


def on() -> bool:
    """Whether the recorder records now: a caller builds costly attributes
    only then."""
    return bool(_profiler._is_profiler_enabled or _REC.forced)


def span(name: str, device=None, **attrs):
    """A span named ``name`` around the ``with`` block, with ``attrs``
    (the object entered has ``set(**attrs)`` for attributes known later);
    with a CUDA ``device`` also its interval on that device's stream.  That
    interval runs from the stream reaching the first event to its reaching
    the last, and counts as device time in ``idle_split``: give a device
    only to a block that queues device work, not to one that waits inside
    (a copy from pageable memory waits for the stream, then stages)."""
    if not (_profiler._is_profiler_enabled or _REC.forced):
        _REC.stale = True
        return NULL
    return _REC.open(name, device, attrs, True)


def begin(name: str, **attrs) -> Optional[int]:
    """Opens a span that ``end(id)`` closes, in this call or a later one;
    it is nobody's parent.  Returns its id, or None while off."""
    if not (_profiler._is_profiler_enabled or _REC.forced):
        _REC.stale = True
        return None
    sp = _REC.open(name, None, attrs, False)
    with _REC.lock:
        _REC.begun[sp.id] = sp
    return sp.id


def end(sid: Optional[int]) -> None:
    """Closes the span ``begin`` opened (nothing for None, or for a span of
    a session since dropped)."""
    if sid is None:
        return
    with _REC.lock:
        sp = _REC.begun.pop(sid, None)
    if sp is not None:
        _REC.close(sp)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while recording."""
    if not (_profiler._is_profiler_enabled or _REC.forced):
        _REC.stale = True
        return
    _REC.fresh()
    with _REC.lock:
        _REC.counters[name] = _REC.counters.get(name, 0) + int(n)
        _REC.read = None


@contextlib.contextmanager
def recording():
    """Records inside the block without a profiler; a session starts here
    unless one is being recorded already."""
    with _REC.lock:
        if not (_profiler._is_profiler_enabled or _REC.forced):
            _REC.restart()
        _REC.forced += 1
    try:
        yield
    finally:
        with _REC.lock:
            _REC.forced -= 1


def session() -> Dict:
    """The session's closed spans (by start), each ``{"name", "id",
    "parent", "thread", "attrs", "nested", "t0", "t1", "device",
    "captured"}`` (nanoseconds on ``time.time_ns``'s clock; ``device``
    [start, end] or None), and its ``counters``.  Resolved once and kept
    until something more is recorded."""
    with _REC.lock:
        if not (_profiler._is_profiler_enabled or _REC.forced):
            _REC.stale = True
        if _REC.read is None:
            _REC.read = _REC.resolve()
        return _REC.read


# ---------------------------------------------------------- reductions --
def named(sess: Dict, name: str) -> List[Dict]:
    """The session's spans named ``name``, by start."""
    return [s for s in sess["spans"] if s["name"] == name]


def host_ms(s: Dict) -> float:
    return (s["t1"] - s["t0"]) * 1e-6


def device_ms(s: Dict) -> Optional[float]:
    """The span's device interval in ms, or None without one."""
    d = s["device"]
    return None if d is None else (d[1] - d[0]) * 1e-6


def totals(sess: Dict) -> Dict[str, Dict]:
    """name -> {"n", "host_ms", "device_n", "device_ms"}: the session's
    spans of each name counted and summed, those with a device interval
    apart."""
    out: Dict[str, Dict] = {}
    for s in sess["spans"]:
        t = out.setdefault(s["name"], {"n": 0, "host_ms": 0.0,
                                       "device_n": 0, "device_ms": 0.0})
        t["n"] += 1
        t["host_ms"] += host_ms(s)
        if s["device"]:
            t["device_n"] += 1
            t["device_ms"] += device_ms(s)
    return out


def within(sess: Dict, s: Dict) -> List[Dict]:
    """Every span below ``s``: its children, theirs, and so on."""
    kids: Dict[int, List[Dict]] = {}
    for t in sess["spans"]:
        kids.setdefault(t["parent"], []).append(t)
    out, todo = [], [s["id"]]
    while todo:
        for t in kids.get(todo.pop(), ()):
            out.append(t)
            todo.append(t["id"])
    return out


def union(intervals) -> tuple:
    """(covered ns, [(start, end)] of the union) of intervals."""
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def self_ms(sess: Dict, s: Dict) -> float:
    """The span's host ms less the part of it its child spans cover."""
    covered, _ = union((max(t["t0"], s["t0"]), min(t["t1"], s["t1"]))
                        for t in sess["spans"] if t["parent"] == s["id"]
                        and t["t1"] > s["t0"] and t["t0"] < s["t1"])
    return (s["t1"] - s["t0"] - covered) * 1e-6


def idle_split(sess: Dict) -> Optional[Dict]:
    """The device's idle time between its first interval's start and its
    last one's end (the union of the session's device intervals), split
    by what the host had open: ``idle`` maps the innermost open span's name
    (``OUTSIDE`` where none was) to idle ns, ``under`` each name to the idle
    ns while any span of that name was open; with ``window_ns`` and
    ``busy_ns``.  Spans of ``begin``/``end`` are no one's work and left
    out.  None without a device interval."""
    busy, merged = union(s["device"] for s in sess["spans"] if s["device"])
    if not merged:
        return None
    lo, hi = merged[0][0], merged[-1][1]
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    host = [s for s in sess["spans"] if s["nested"]]
    by_id = {s["id"]: s for s in host}
    depth: Dict[int, int] = {}
    for s in host:
        d, p = 0, s["parent"]
        while p in by_id:
            d, p = d + 1, by_id[p]["parent"]
        depth[s["id"]] = d
    edges = sorted({lo, hi, *(t for g in gaps for t in g),
                    *(t for s in host for t in (s["t0"], s["t1"])
                      if lo < t < hi)})
    starts = sorted(host, key=lambda s: s["t0"])
    ends = sorted(host, key=lambda s: s["t1"])
    i = j = k = 0
    active: Dict[int, Dict] = {}
    idle: Dict[str, int] = {}
    under: Dict[str, int] = {}
    for a, b in zip(edges, edges[1:]):
        while i < len(starts) and starts[i]["t0"] <= a:
            active[starts[i]["id"]] = starts[i]
            i += 1
        while j < len(ends) and ends[j]["t1"] <= a:
            active.pop(ends[j]["id"], None)
            j += 1
        while k < len(gaps) and gaps[k][1] <= a:
            k += 1
        if k == len(gaps) or gaps[k][0] > a:
            continue                    # the device was busy over [a, b)
        inner = max(active.values(), default=None,
                    key=lambda s: (depth[s["id"]], s["t0"]))
        name = OUTSIDE if inner is None else inner["name"]
        idle[name] = idle.get(name, 0) + b - a
        for n in {s["name"] for s in active.values()}:
            under[n] = under.get(n, 0) + b - a
    return {"window_ns": hi - lo, "busy_ns": busy, "idle": idle,
            "under": under}
