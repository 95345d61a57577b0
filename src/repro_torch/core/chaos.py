"""Deterministic fault injection for the campaign fleet.

Port of ``repro.core.chaos`` (pure Python): a ``FaultPlan`` written by
either package's ``to_env`` parses to the same faults in the other.

The fleet's fault-tolerance layer (reconnect/backoff, host quarantine,
replication-safe compaction) is only trustworthy if its failure paths
run under test — so faults are *scripted*, not random.  A ``FaultPlan``
is a list of ``Fault``s that ships to worker processes through the
``REPRO_CHAOS`` environment variable (executors set it on the workers
they spawn; an already-running ``repro_torch.core.remote_worker`` picks it up
from its own environment).  Each worker-side ``_SpecServer`` builds one
``ChaosInjector`` from the env and consults it per eval spec — pings
never count, so warm()/probe traffic cannot consume a scheduled fault.

Faults fire on the Nth *matching* dispatch (``at_nth``, counted inside
one worker process).  A server kill respawns the worker with fresh
counters, so any fault that must fire exactly once across restarts
carries a ``flag`` file: the fault fires only if the flag is absent and
creates it first (the same latch idiom as the worker tests'
``crash_once_flag``).

Fault kinds:

* ``kill_server``      — ``os._exit`` the worker/server process before
  evaluating: the scheduler sees EOF and takes the WorkerFault
  crash/retry path, and a ``spawn`` host's server is respawned.
* ``drop_connection``  — evaluate normally, then send only *half* the
  reply line and close the socket: the scheduler sees EOF mid-line
  (torn-line handling + retry).  Only the TCP transport
  (``repro_torch.core.remote_worker``) honors this; stdio workers ignore it.
* ``stall``            — sleep ``sleep_s`` before evaluating, to drive
  the scheduler's timeout path.
* ``corrupt_journal``  — append a non-JSON ``payload`` line to ``path``
  before evaluating, to drive journal quarantine + replication of a
  poisoned line.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

CHAOS_ENV = "REPRO_CHAOS"


@dataclass(frozen=True)
class Fault:
    kind: str                 # kill_server | drop_connection | stall | corrupt_journal
    match: str = ""           # substring of the job label / case name ("" → any job)
    host: str = ""            # restrict to one REPRO_HOST_ALIAS ("" → any host)
    at_nth: int = 1           # fire on the Nth matching eval spec (1-based)
    flag: str = ""            # cross-restart latch file: fire only if absent
    sleep_s: float = 0.0      # stall duration
    path: str = ""            # corrupt_journal: journal to poison
    payload: str = "CHAOS not-json {"   # corrupt_journal: the poison line
    exit_code: int = 43       # kill_server exit status

    KINDS = ("kill_server", "drop_connection", "stall", "corrupt_journal")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {self.KINDS}")

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Fault":
        return Fault(**d)


@dataclass
class FaultPlan:
    """A scripted fault schedule, serializable through one env var."""

    faults: List[Fault] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps([f.to_dict() for f in self.faults])

    @staticmethod
    def from_json(s: str) -> "FaultPlan":
        return FaultPlan([Fault.from_dict(d) for d in json.loads(s)])

    def to_env(self, env: Dict[str, str]) -> Dict[str, str]:
        """Stamp the plan into a child-process environment dict."""
        env[CHAOS_ENV] = self.to_json()
        return env

    @staticmethod
    def from_env(environ: Optional[Dict[str, str]] = None
                 ) -> Optional["FaultPlan"]:
        raw = (environ if environ is not None else os.environ).get(
            CHAOS_ENV, "")
        return FaultPlan.from_json(raw) if raw else None


def _spec_label(spec: Dict[str, Any]) -> str:
    """The job identity a fault's ``match`` substring is tested against:
    the job label plus the case name (either matches)."""
    j = spec.get("job") or {}
    case = (j.get("case") or {}).get("name", "")
    return f"{j.get('label', '')}|{case}"


def _latch(flag: str) -> bool:
    """Atomically acquire a cross-restart fire-once latch.  Returns True
    exactly once per flag file across all processes."""
    try:
        fd = os.open(flag, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    except OSError:
        return False         # unreachable flag dir → never fire
    os.write(fd, b"chaos fired\n")
    os.close(fd)
    return True


class ChaosInjector:
    """Worker-side fault trigger.  ``fire(spec)`` applies any due
    ``stall`` / ``corrupt_journal`` / ``kill_server`` faults in place
    and returns the due ``drop_connection`` faults for the transport
    layer to honor at reply time."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = {}     # fault index → match count

    @staticmethod
    def from_env(environ: Optional[Dict[str, str]] = None
                 ) -> Optional["ChaosInjector"]:
        plan = FaultPlan.from_env(environ)
        return ChaosInjector(plan) if plan and plan.faults else None

    def _due(self, spec: Dict[str, Any]) -> List[Fault]:
        label = _spec_label(spec)
        alias = os.environ.get("REPRO_HOST_ALIAS", "")
        due: List[Fault] = []
        with self._lock:
            for i, f in enumerate(self.plan.faults):
                if f.host and f.host != alias:
                    continue
                if f.match and f.match not in label:
                    continue
                self._counts[i] = self._counts.get(i, 0) + 1
                if self._counts[i] != max(1, f.at_nth):
                    continue
                if f.flag and not _latch(f.flag):
                    continue
                due.append(f)
        return due

    def fire(self, spec: Dict[str, Any]) -> List[Fault]:
        if spec.get("ping"):
            return []            # probes/warm pings never consume faults
        due = self._due(spec)
        drops: List[Fault] = []
        for f in due:
            if f.kind == "stall":
                time.sleep(float(f.sleep_s))
            elif f.kind == "corrupt_journal":
                self._poison(f)
            elif f.kind == "drop_connection":
                drops.append(f)
        for f in due:
            if f.kind == "kill_server":
                os._exit(int(f.exit_code))
        return drops

    @staticmethod
    def _poison(f: Fault) -> None:
        if not f.path:
            return
        data = f.payload.encode("utf-8", errors="replace") + b"\n"
        fd = os.open(f.path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)
