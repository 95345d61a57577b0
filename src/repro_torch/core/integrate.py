"""Reintegration: swap MEP-optimized kernels back into the full application
and validate end-to-end (paper's "Integrated Speedup").

Port of ``repro.core.integrate``.  The kernel-variant registry
(``repro_torch.kernels.ops``) is the splice point: model code asks the
registry for an implementation at each hotspot site, so installing the
optimized variant requires no model edits.

Two install APIs live here:

* ``install`` / ``uninstall`` — the offline benchmark path: push the
  variant onto the site's generation stack, measure, pop.
* ``guarded_install`` — the online serving path: FE-check the variant at
  the *observed traffic scale* before touching the registry, install a
  new generation, then probe the integrated step and roll back to the
  prior generation if the step regresses or its outputs diverge.  The
  outcome (``GuardedInstall``) has the JAX package's fields, ``to_dict``
  keys and reason strings.

Differences from the JAX package:

* ``integrated_speedup`` installs the winner's build for the platform it
  was timed on (``platform.impl``: ``cuda`` on ``h100``, ``torch`` on
  ``torch-cpu``), where JAX always installs the ``jnp`` build; the
  baseline is the naive ``torch`` build either way (the serve autotuner
  passes ``impl=platform.impl`` to ``guarded_install`` likewise);
* the application step runs eagerly: ``make_step()`` is called, not jitted;
* ``guarded_install`` takes the port's ``device`` argument: where the FE
  check runs.  A guard probe is timed on the host clock around the call
  and a ``torch.cuda.synchronize()`` where its outputs lie on the card:
  the wall time a server pays, launch cost included.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import fe as fe_mod
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


# --------------------------------------------------------------------------
# Guarded online install (serve-layer autotuning)
# --------------------------------------------------------------------------
@dataclass
class GuardedInstall:
    """Outcome of one guarded hot-swap attempt."""
    site: str
    case_name: str
    variant: Variant
    scale: int
    installed: bool = False       # the registry was touched
    rolled_back: bool = False     # ... and then restored
    reason: str = ""
    fe_ok: bool = False
    fe_abs_err: float = 0.0
    probe_baseline_s: float = 0.0
    probe_installed_s: float = 0.0
    probe_max_abs_err: float = 0.0
    generation_before: int = 0
    generation: int = 0           # active generation after the call

    @property
    def active(self) -> bool:
        """True iff the variant is live in the registry right now."""
        return self.installed and not self.rolled_back

    @property
    def probe_speedup(self) -> float:
        return (self.probe_baseline_s / self.probe_installed_s
                if self.probe_installed_s else 0.0)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "site": self.site, "case": self.case_name,
            "variant": dict(self.variant), "scale": self.scale,
            "installed": self.installed, "rolled_back": self.rolled_back,
            "active": self.active, "reason": self.reason,
            "fe_ok": self.fe_ok, "fe_abs_err": self.fe_abs_err,
            "probe_baseline_s": self.probe_baseline_s,
            "probe_installed_s": self.probe_installed_s,
            "probe_speedup": self.probe_speedup,
            "probe_max_abs_err": self.probe_max_abs_err,
            "generation_before": self.generation_before,
            "generation": self.generation,
        }


def _max_abs_err(a, b) -> float:
    errs = [float(np.max(np.abs(to_numpy(x) - to_numpy(y))))
            for x, y in zip(leaves(a), leaves(b))
            if hasattr(x, "shape")]
    return max(errs) if errs else 0.0


def _synchronize(out) -> None:
    """Wait for the card where any leaf of ``out`` lies on it."""
    for x in leaves(out):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
            return


def _probe_stats(probe: Callable[[], Any], r: int, k: int
                 ) -> Tuple[float, Any]:
    """Trimmed-mean wall-clock of ``probe`` plus its (last) outputs; one
    warmup call absorbs first-call costs.  Timed through the measurement
    engine, so guard probes serialize against concurrent campaign timings
    in this process instead of polluting them."""
    from repro_torch.core.measure import MeasureConfig, measure_callable
    out_box = []

    def run_once() -> float:
        t0 = time.perf_counter()
        out = probe()
        _synchronize(out)
        out_box[:] = [out]
        return time.perf_counter() - t0

    with torch.no_grad():
        _synchronize(probe())           # warmup
        res = measure_callable(run_once, r=max(r, 2 * k + 1), k=k,
                               cfg=MeasureConfig(adaptive=False, race=False))
    return res.trimmed_mean_s, out_box[0]


def guarded_install(case: KernelCase, variant: Variant, *, scale: int,
                    impl: str = "torch",
                    probe: Optional[Callable[[], Any]] = None,
                    max_regression: float = 0.25, atol: float = 5e-2,
                    r: int = 3, k: int = 0, fe_input_sets: int = 2,
                    seed: int = 0, device="cuda",
                    **meta: Any) -> GuardedInstall:
    """Hot-swap ``variant``'s ``impl`` build into its app site with pre-
    and post-install guards; never raises on a bad candidate — the outcome
    says what happened and the registry is left in a safe state.

    Guard 1 (pre-install): functional equivalence against the case oracle
    at ``scale`` — the *observed traffic* scale, not the MEP's benchmark
    scale — on ``device``.  A failing candidate never touches the registry.

    Guard 2 (post-install): if a ``probe`` is given (any callable running
    the integrated step through the registry — it must consult the active
    impl per call, e.g. via ``ops.get_impl``), it is timed before and after
    the install.  The install is rolled back to the prior generation when
    the probe's outputs diverge beyond ``atol``, go non-finite, the step
    slows down by more than ``max_regression`` (fractional, 0.25 = 25%),
    or the probe itself raises.
    """
    if not case.app_site:
        raise ValueError(f"{case.name} has no app_site to integrate into")
    site = case.app_site
    res = GuardedInstall(site, case.name, dict(variant), int(scale),
                         generation_before=ops.generation(site),
                         generation=ops.generation(site))

    # -- guard 1: FE at the observed traffic scale -------------------------
    try:
        fr = fe_mod.check(case, variant, scale, impl=impl,
                          n_input_sets=fe_input_sets, seed=seed,
                          device=device)
    except Exception as e:  # noqa: BLE001 — a broken build must not leak
        res.reason = f"fe_error: {type(e).__name__}: {e}"[:300]
        return res
    res.fe_ok, res.fe_abs_err = fr.ok, fr.max_abs_err
    if not fr.ok:
        res.reason = f"fe_fail: {fr.detail}"[:300]
        return res

    # -- baseline probe under the incumbent impl ---------------------------
    base_out = None
    if probe is not None:
        try:
            res.probe_baseline_s, base_out = _probe_stats(probe, r, k)
        except Exception as e:  # noqa: BLE001
            res.reason = f"probe_error(baseline): {type(e).__name__}: {e}"[:300]
            return res

    # -- install a new generation -----------------------------------------
    res.generation = ops.install(site, case.build(variant, impl=impl),
                                 case=case.name, variant=dict(variant),
                                 impl=impl, scale=int(scale), **meta)
    res.installed = True

    # -- guard 2: integrated step must neither diverge nor regress --------
    if probe is not None:
        try:
            res.probe_installed_s, new_out = _probe_stats(probe, r, k)
        except Exception as e:  # noqa: BLE001
            res.generation = ops.rollback(site, res.generation_before)
            res.rolled_back = True
            res.reason = f"probe_error: {type(e).__name__}: {e}"[:300]
            return res
        res.probe_max_abs_err = _max_abs_err(base_out, new_out)
        finite = all(np.all(np.isfinite(to_numpy(x)))
                     for x in leaves(new_out) if hasattr(x, "shape"))
        if res.probe_max_abs_err > atol or not finite:
            res.generation = ops.rollback(site, res.generation_before)
            res.rolled_back = True
            res.reason = (f"diverged: max_abs_err="
                          f"{res.probe_max_abs_err:.3e} > atol={atol:.1e}"
                          if finite else "diverged: non-finite outputs")
            return res
        if res.probe_installed_s > res.probe_baseline_s * (1.0
                                                          + max_regression):
            res.generation = ops.rollback(site, res.generation_before)
            res.rolled_back = True
            res.reason = (f"regressed: {res.probe_installed_s * 1e6:.1f}us vs "
                          f"{res.probe_baseline_s * 1e6:.1f}us baseline "
                          f"(> {1.0 + max_regression:.2f}x)")
            return res

    res.reason = "installed"
    return res
