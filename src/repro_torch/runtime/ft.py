"""Fault tolerance: checkpoint/restart loop, failure injection, straggler
watchdog.

Port of ``repro.runtime.ft``.  The loop treats a step failure as normal:
any exception rolls the state back to the latest checkpoint (or, with none
yet, replays from the last good step) and goes on; the data pipeline is
keyed by step, so a replay is bit-identical.  The watchdog flags stragglers
from a step-time EWMA and invokes a callback.

The state is a tree of tensors (``{"params": model_params(model), "opt":
opt_state}``); a restore copies the checkpoint into its live tensors, and a
train step that raises leaves it as it was (``train.steps``).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger("repro_torch.runtime")


class FailureInjector:
    """Deterministic fault injection for tests: raise at given steps."""

    def __init__(self, fail_at: Dict[int, int] = None):
        self.fail_at = dict(fail_at or {})   # step -> remaining failures

    def maybe_fail(self, step: int) -> None:
        if self.fail_at.get(step, 0) > 0:
            self.fail_at[step] -= 1
            raise RuntimeError(f"injected node failure at step {step}")


@dataclass
class StragglerWatchdog:
    """EWMA step-time guard: flags steps slower than factor × EWMA."""
    factor: float = 3.0
    alpha: float = 0.2
    min_samples: int = 3
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    ewma: float = 0.0
    n: int = 0
    flagged: List[int] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        slow = self.n >= self.min_samples and dt > self.factor * self.ewma
        if slow:
            self.flagged.append(step)
            log.warning("straggler: step %d took %.3fs (ewma %.3fs)",
                        step, dt, self.ewma)
            if self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
        else:
            self.ewma = dt if self.n == 0 else \
                (1 - self.alpha) * self.ewma + self.alpha * dt
            self.n += 1
        return slow


class FaultTolerantLoop:
    """Run train steps with checkpoint/restart semantics.

    ``step_fn(state, step) -> (state, metrics)`` runs one step (the caller
    binds data loading by step index so replays are deterministic).  On
    failure: restore from the manager and continue; abort only after
    ``max_restarts``.
    """

    def __init__(self, manager, *, checkpoint_every: int = 50,
                 max_restarts: int = 5,
                 watchdog: Optional[StragglerWatchdog] = None,
                 injector: Optional[FailureInjector] = None):
        self.manager = manager
        self.checkpoint_every = checkpoint_every
        self.max_restarts = max_restarts
        self.watchdog = watchdog or StragglerWatchdog()
        self.injector = injector
        self.restarts = 0
        self.metrics_log: List[Dict[str, Any]] = []

    def run(self, state, step_fn, *, start_step: int = 0, num_steps: int = 100):
        step = start_step
        last_good = start_step
        while step < start_step + num_steps:
            t0 = time.perf_counter()
            try:
                if self.injector:
                    self.injector.maybe_fail(step)
                state, metrics = step_fn(state, step)
            except Exception as e:  # noqa: BLE001 — any failure → restart
                self.restarts += 1
                log.warning("step %d failed (%s); restart %d/%d",
                            step, e, self.restarts, self.max_restarts)
                if self.restarts > self.max_restarts:
                    raise
                if self.manager.latest is not None:
                    state, ck_step, _ = self.manager.restore(state)
                    step = ck_step
                    log.info("restored checkpoint at step %d", ck_step)
                else:
                    step = last_good
                continue
            dt = time.perf_counter() - t0
            self.watchdog.observe(step, dt)
            self.metrics_log.append({"step": step, "dt": dt, **(
                {k: float(v) for k, v in metrics.items()
                 if hasattr(v, "item") or isinstance(v, float)}
                if isinstance(metrics, dict) else {})})
            step += 1
            if step % self.checkpoint_every == 0:
                self.manager.save(step, state)
                last_good = step
        self.manager.save(step, state)
        self.manager.wait()
        return state, step
