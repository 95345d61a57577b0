"""Reintegration: swap MEP-optimized kernels back into the full application
and validate end-to-end (paper's "Integrated Speedup").

Port of ``repro.core.integrate`` (``install``, ``uninstall``,
``measure_app``, ``integrated_speedup``; ``integrate.py:51-107``).  The
kernel-variant registry (``repro_torch.kernels.ops``) is the splice point:
model code asks the registry for an implementation at each hotspot site,
so installing the optimized variant requires no model edits.

Two differences from the JAX package:

* ``integrated_speedup`` installs the winner's build for the platform it
  was timed on (``platform.impl``: ``cuda`` on ``h100``, ``torch`` on
  ``torch-cpu``), where JAX always installs the ``jnp`` build; the
  baseline is the naive ``torch`` build either way;
* the application step runs eagerly: ``make_step()`` is called, not jitted.

``guarded_install`` (the serving path's FE-gated hot swap) arrives with the
serve autotuner (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.fe import leaves, to_numpy
from repro_torch.core.kernelcase import KernelCase, Variant
from repro_torch.core.profiler import Platform
from repro_torch.kernels import ops


@dataclass
class IntegrationResult:
    site: str
    baseline_time_s: float
    optimized_time_s: float
    fe_ok: bool
    max_abs_err: float

    @property
    def integrated_speedup(self) -> float:
        return (self.baseline_time_s / self.optimized_time_s
                if self.optimized_time_s else 0.0)


def install(case: KernelCase, variant: Variant, *, impl: str = "torch",
            **meta: Any) -> int:
    """Install the optimized variant at its app hotspot site; returns the
    registry generation (the previous impl stays underneath)."""
    if not case.app_site:
        raise ValueError(f"{case.name} has no app_site to integrate into")
    return ops.install(case.app_site, case.build(variant, impl=impl),
                       case=case.name, variant=dict(variant), impl=impl,
                       **meta)


def uninstall(case: KernelCase) -> None:
    """Pop this case's site back to whatever was active before the last
    install (not necessarily empty — nested installs compose)."""
    if case.app_site:
        ops.rollback(case.app_site)


def measure_app(step_fn: Callable, args, *, r: int = 10, k: int = 1,
                warmup: int = 1) -> float:
    """Time one application step through the measurement engine (CUDA
    events when ``args`` lie on the card): each warmup call synchronises
    on its own output, and the timed reps hold the process-wide timing
    mutex, so an integration measurement never overlaps a concurrent
    campaign's eq. 3 slices in this process."""
    from repro_torch.core.measure import MeasureConfig, measure_fn
    return measure_fn(step_fn, args, r=r, k=k,
                      cfg=MeasureConfig(adaptive=False, race=False,
                                        warmup=warmup)).trimmed_mean_s


def integrated_speedup(case: KernelCase, variant: Variant,
                       make_step: Callable[[], Callable], args, *,
                       platform: Platform, r: int = 10, k: int = 1,
                       baseline_variant: Optional[Variant] = None
                       ) -> IntegrationResult:
    """Measure the full-application step with the naive extracted kernel
    (the application's original hotspot, its ``torch`` build) vs the
    optimized variant's ``platform.impl`` build installed; verify
    end-to-end outputs still match (max abs error < 5e-2, as JAX)."""
    with torch.no_grad():
        install(case, baseline_variant or case.baseline_variant)
        try:
            base_step = make_step()
            t_base = measure_app(base_step, args, r=r, k=k)
            base_out = base_step(*args)
        finally:
            uninstall(case)

        install(case, variant, impl=platform.impl)
        try:
            opt_step = make_step()
            t_opt = measure_app(opt_step, args, r=r, k=k)
            opt_out = opt_step(*args)
        finally:
            uninstall(case)

    max_err = _max_abs_err(base_out, opt_out)
    return IntegrationResult(case.app_site, t_base, t_opt,
                             fe_ok=max_err < 5e-2, max_abs_err=max_err)


def _max_abs_err(a, b) -> float:
    errs = [float(np.max(np.abs(to_numpy(x) - to_numpy(y))))
            for x, y in zip(leaves(a), leaves(b))
            if hasattr(x, "shape")]
    return max(errs) if errs else 0.0
