"""What the drivers and ``run.py`` share: the clock, spans, percentiles, the
card's record from ``nvidia-smi``, the profiler's trace reduced to device
time, and the check for modules that a run must not load."""
from __future__ import annotations

import contextlib
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

clock = time.perf_counter

ROOT = Path(__file__).resolve().parent.parent
# top-level module names no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), each compared whole: ``repro_torch`` is not
    ``repro``."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                         else modules)}
    return sorted(names & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of every value, linearly interpolated
    between order statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def smi_sample() -> Optional[Dict[str, str]]:
    """One reading of the card's name, SM clock, power draw and limit and
    temperature from ``nvidia-smi``, or None where it cannot be read."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    keys = ("name", "clocks.sm", "power.draw", "power.limit",
            "temperature.gpu")
    try:
        out = subprocess.run(
            [smi, f"--query-gpu={','.join(keys)}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None
    return dict(zip(keys, (v.strip() for v in out.split(","))))


def span(name: str, trace: Optional["Trace"]):
    """A span named ``name`` recorded by ``trace`` while it is taken, else
    nothing."""
    if trace is None or trace.prof is None:
        return contextlib.nullcontext()
    return trace.span(name)


class Trace:
    """A ``torch.profiler`` trace of the device (CUDA activity only, so the
    host runs at its own pace) over part of the window, reduced to the
    device's operations.  ``start``/``stop`` synchronise the device, so the
    host clock between them is the traced window.  The drivers' spans are
    kept on the host's wall clock (``time.time_ns``), the clock the
    profiler stamps its events with."""

    def __init__(self):
        self.prof = None
        self.window_s = 0.0
        self.spans: List[tuple] = []
        self.result: Optional[Dict] = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._t0 = clock()
        self._ns0 = time.time_ns()

    @contextlib.contextmanager
    def span(self, name: str):
        a = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((a, time.time_ns(), name))

    def stop(self) -> Dict:
        import torch
        torch.cuda.synchronize()
        self.window_s = clock() - self._t0
        ns1 = time.time_ns()
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        self.result = reduce_events(events, self.window_s, self.spans,
                                    (self._ns0, ns1))
        self.prof = None
        return self.result


def reduce_events(events, window_s: float, spans, host_ns) -> Dict:
    """Device time by operation name, the busy time (the union of every
    device operation's interval), and the idle gaps between them named by
    the span the host had open when each began (``spans``: (start ns, end
    ns, name) on the host's wall clock, which ``host_ns`` bounds).  Where
    the device's stamps fall outside the host's bounds by more than 5 ms,
    the clocks do not agree and every gap is named so."""
    dev = []
    for e in events:
        if str(e.device_type()).endswith("CUDA") and not getattr(
                e, "is_user_annotation", lambda: False)():
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name()))
    by_name: Dict[str, float] = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
    dev.sort()
    busy_ns, gaps = 0, []
    end = None
    for a, b, _ in dev:
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy_ns += b - a
            end = b
        elif b > end:
            busy_ns += b - end
            end = b
    slack = 5_000_000
    aligned = not dev or (dev[0][0] >= host_ns[0] - slack
                          and end <= host_ns[1] + slack)
    spans = sorted(spans)
    idle: Dict[str, float] = {}
    for a, b in gaps:
        name = "between spans" if aligned else "clocks disagree"
        for s0, s1, sname in spans if aligned else ():
            if s0 <= a < s1:
                name = sname
            elif s0 > a:
                break
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-9
    return {"busy_s": busy_ns * 1e-9, "window_s": window_s,
            "device_ops": by_name, "idle": idle, "aligned": aligned}


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    """The ``n`` largest entries of ``d`` as [name, value] pairs, names cut
    to 160 characters."""
    items = sorted(d.items(), key=lambda kv: -kv[1])[:n]
    return [[k[:160], v] for k, v in items]


def kernel_names(cu_file: Path) -> List[str]:
    """The ``__global__`` functions a CUDA source defines."""
    src = cu_file.read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                      r"\s*)?(\w+)\s*\(", src)


def is_kernel(op_name: str, names) -> bool:
    """Whether a device operation's (demangled) name is one of ``names``."""
    return any(re.search(rf"(^|[\s:]){n}\b", op_name) for n in names)
