"""Minimal Executable Program construction (paper §3.1, eq. 1–2).

Port of ``repro.core.mep``: the same constraints and auto-sizing walk;
``emit_script`` renders a standalone PyTorch script in place of the JAX one.

Completes an extracted kernel into a standalone, repeatable benchmark:
picks the problem scale and repetition count so that

    T_ker ≥ T_min        (kernel time significant vs. timer noise)
    T_overall ≤ T_max    (whole MEP cheap to run)
    S_data ≤ S_max       (generated inputs bounded)

and can emit the MEP as a self-contained runnable .py artifact — the
"program" the paper's LLM would have written, generated here from the
KernelCase metadata.
"""
from __future__ import annotations

import dataclasses
import textwrap
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core import datagen
from repro_torch.core.datagen import DataBudget
from repro_torch.core.kernelcase import KernelCase, Variant
from repro_torch.core.measure import MeasureConfig, device_work, probe_time
from repro_torch.core.profiler import Platform, TimingResult


@dataclass(frozen=True)
class MEPConstraints:
    t_min_s: float = 1e-4        # T_min
    t_max_s: float = 10.0        # T_max (whole MEP: R reps + checks)
    s_max_bytes: int = 256 * 1024 * 1024   # S_max
    r: int = 30                  # repeated runs (paper: R=30)
    k: int = 3                   # trim count  (paper: k=3)

    def to_dict(self) -> Dict[str, Any]:
        from dataclasses import asdict
        return asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "MEPConstraints":
        return MEPConstraints(**d)


@dataclass
class MEP:
    case: KernelCase
    platform: Platform
    constraints: MEPConstraints
    scale: int
    seed: int
    inputs: List[np.ndarray] = field(default_factory=list)
    reps: int = 0
    t_ker_baseline_s: float = 0.0
    log: List[str] = field(default_factory=list)

    @property
    def s_data_bytes(self) -> int:
        return sum(a.nbytes for a in self.inputs)

    def measure(self, variant: Variant, *, r: Optional[int] = None,
                k: Optional[int] = None,
                budget: Optional[MeasureConfig] = None,
                incumbent_s: Optional[float] = None) -> TimingResult:
        """Eq. 3 timing of one variant at the MEP's scale.  ``budget``
        selects the adaptive engine's stopping policy (and timing
        lease); ``incumbent_s`` arms incumbent racing."""
        with device_work(self.platform, "time"):
            return self.platform.time_variant(
                self.case, variant, self.scale, self.inputs,
                r=r or self.reps, k=self.constraints.k if k is None else k,
                budget=budget, incumbent_s=incumbent_s)

    def reference_outputs(self):
        """The oracle's outputs on the MEP's inputs, on the platform's
        device."""
        import torch

        from repro_torch.core.fe import as_tensors
        with torch.no_grad(), device_work(self.platform, "ref"):
            return self.case.ref(*as_tensors(self.inputs,
                                             self.platform.device))


def build_mep(case: KernelCase, platform: Platform, *,
              constraints: MEPConstraints = MEPConstraints(),
              seed: int = 0, scale: Optional[int] = None,
              budget: Optional[MeasureConfig] = None) -> MEP:
    """Auto-size the MEP: walk scales from large to small until both the
    data budget (eq. 2) and the time constraints (eq. 1) admit it.

    ``scale`` pins the MEP to one problem size — the serve-layer
    autotuner uses this to optimize at the *observed traffic* scale
    instead of the benchmark grid.  A pinned scale that misses the
    budget is still used (via the fallback path) since it is what the
    workload actually runs.  ``budget`` carries the campaign's
    measurement policy so the auto-sizing probes respect the timing
    lease like every other wall-clock section."""
    data_budget = DataBudget(constraints.s_max_bytes)
    log: List[str] = []
    chosen = None
    candidate_scales = ([int(scale)] if scale is not None
                        else sorted(case.scales, reverse=True))
    for sc in candidate_scales:
        specs = case.input_specs(sc)
        if not data_budget.admits(specs):
            log.append(f"scale {sc}: rejected, S_data="
                       f"{datagen.data_bytes(specs)/2**20:.1f} MiB > S_max")
            continue
        inputs = datagen.generate(specs, seed)
        # probe the baseline once; ``probe_time`` memoizes per (case,
        # variant, platform, scale, seed), so the fallback path below —
        # and any later build_mep at the same coordinates — never
        # re-times a scale this walk already paid for (rejected scales'
        # inputs are dropped here; regeneration is deterministic+cheap)
        t = probe_time(platform, case, case.baseline_variant, sc, inputs,
                       seed=seed, budget=budget)
        overall = t * constraints.r * 1.5          # R reps + FE overhead
        if overall > constraints.t_max_s:
            log.append(f"scale {sc}: rejected, projected T_overall="
                       f"{overall:.2f}s > T_max={constraints.t_max_s}s")
            continue
        chosen = (sc, inputs, t)
        log.append(f"scale {sc}: accepted, T_ker={t*1e3:.3f}ms, "
                   f"S_data={sum(a.nbytes for a in inputs)/2**20:.1f} MiB")
        break
    if chosen is None:
        # last resort: the pinned scale (it is the observed workload), else
        # the smallest benchmark scale (T_min may force more reps).  A
        # scale the walk already probed re-times nothing: the probe memo
        # serves t, only the (deterministic) inputs are regenerated.
        sc = int(scale) if scale is not None else min(case.scales)
        inputs = datagen.generate(case.input_specs(sc), seed)
        t = probe_time(platform, case, case.baseline_variant, sc,
                       inputs, seed=seed, budget=budget)
        chosen = (sc, inputs, t)
        log.append(f"fallback to {'pinned' if scale is not None else 'smallest'}"
                   f" scale {sc}")
    scale, inputs, t = chosen
    # T_ker ≥ T_min: repeat the kernel inside one measurement if too fast
    # (handled by rep scaling of R; the per-measurement loop count is 1 —
    # CPU timers at ~1µs resolution make t_min=100µs achievable directly)
    reps = constraints.r
    mep = MEP(case=case, platform=platform, constraints=constraints,
              scale=scale, seed=seed, inputs=inputs, reps=reps,
              t_ker_baseline_s=t, log=log)
    return mep


def emit_script(mep: MEP, variant: Variant, *,
                measure: Optional[MeasureConfig] = None,
                timing: Optional[TimingResult] = None) -> str:
    """Render the MEP as a standalone runnable .py (the paper's artifact).

    The emitted script times through the adaptive measurement engine —
    same CI-based stopping the campaign used — and its CSV row reports
    the reps actually achieved against the eq. 3 cap plus the CI
    half-width, so a re-run is auditable against the recorded numbers.
    ``timing`` (the in-campaign measurement of ``variant``) is embedded
    in the header as the achieved reps/CI provenance."""
    c = mep.constraints
    # the artifact must run anywhere: the campaign's lease file is not
    # meaningful outside the process fleet that created it
    m = dataclasses.replace(measure, lease_path=None) if measure \
        else MeasureConfig()
    achieved = ""
    if timing is not None:
        achieved = (f"\n    In-campaign measurement: {timing.r}/"
                    f"{timing.r_cap or c.r} reps, CI half-width "
                    f"{timing.ci_half_width_s*1e6:.3f}us "
                    f"({timing.ci_rel*100:.2f}% of the trimmed mean)"
                    + (", raced out" if timing.raced_out else "") + ".")
    return textwrap.dedent(f'''\
    """Auto-generated Minimal Executable Program for hotspot kernel
    {mep.case.name!r} (suite {mep.case.suite}); runs standalone, no
    full-application dependencies.  Constraints: T_min={c.t_min_s}s,
    T_max={c.t_max_s}s, S_max={c.s_max_bytes} bytes; R={c.r}, k={c.k}
    (adaptive CI stop at {m.ci_rel:.3f} relative half-width).  Times the
    {mep.platform.impl!r} build on {mep.platform.device!r}.{achieved}"""
    import numpy as np
    import torch
    from repro_torch.core import datagen
    from repro_torch.core.fe import as_tensors, leaves, to_numpy
    from repro_torch.core.kernelcase import get_case
    from repro_torch.core.measure import MeasureConfig, measure_fn

    CASE = get_case({mep.case.name!r})
    VARIANT = {variant!r}
    SCALE = {mep.scale}
    SEED = {mep.seed}
    IMPL = {mep.platform.impl!r}
    DEVICE = {mep.platform.device!r}
    MEASURE = MeasureConfig.from_dict({m.to_dict()!r})

    specs = CASE.input_specs(SCALE)
    assert sum(s.nbytes for s in specs) <= {c.s_max_bytes}, "S_max violated"
    inputs = as_tensors(datagen.generate(specs, SEED), DEVICE)
    fn = CASE.build(VARIANT, impl=IMPL)
    with torch.no_grad():
        res = measure_fn(fn, inputs, r={c.r}, k={c.k}, cfg=MEASURE)
        out = fn(*inputs)
        ref = CASE.ref(*inputs)
    ok = all(np.allclose(to_numpy(a), to_numpy(b), rtol=2e-2, atol=2e-2)
             for a, b in zip(leaves(out), leaves(ref)))
    print(f"{{CASE.name}},{{res.trimmed_mean_s*1e6:.2f}}us,"
          f"reps={{res.r}}/{{res.r_cap}},"
          f"ci={{res.ci_half_width_s*1e6:.3f}}us,FE={{ok}}")
    ''')
