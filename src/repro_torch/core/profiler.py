"""Timing + platform abstraction.

Port of ``repro.core.profiler``.  Eq. 3 of the paper: each candidate is run
R times, the R measurements are sorted, the lowest and highest k are
discarded, and the rest averaged (trimmed mean).  The measurement loop
lives in ``repro_torch.core.measure``: R is the cap, and the adaptive
engine stops early once the trimmed mean's CI half-width converges (or the
candidate provably loses to the incumbent).

Four platforms:

* ``TorchCPUPlatform`` (``"torch-cpu"``) — wall-clocks a variant's
  ``torch`` build on the host CPU.
* ``H100TorchPlatform`` (``"h100-torch"``) — times a variant's ``torch``
  build on the card with CUDA events (measured).  The JAX package's
  ``CPUPlatform`` times the ``jnp`` build on JAX's default device, which on
  a TPU host is the TPU (the paper's "Platform A" rows of Tables 1–3);
  this is its counterpart on the card.
* ``H100Platform`` (``"h100"``) — times a variant's ``cuda`` build, the
  hand-written kernel, on the card with CUDA events (measured).  Every
  candidate it times passes functional equivalence through the kernel
  first (``check_kernel``).
* ``H100ModelPlatform`` (``"h100-model"``) — an analytic H100 roofline over
  the case's flops/traffic model, deterministic, in the role
  ``TPUModelPlatform`` plays for the JAX package.

Profile feedback keeps the JAX package's keys, which the diagnosis and the
round journal read, with their Hopper meaning:

* ``mxu_utilization`` — tile fill: the share of a 64-row warpgroup MMA tile
  and of K1's 16-wide thread grid that the variant's tile sides fill
  (``variant_mxu_utilization``);
* ``vmem_bytes`` — the shared memory one block of K1 allocates for the
  variant's tile (``variant_smem_bytes``), against ``SMEM_BYTES``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import hw
from repro_torch.core.kernelcase import KernelCase, Variant
from repro_torch.device import resolve_device
from repro_torch.kernels.matmul import fit, smem_bytes


@dataclass
class TimingResult:
    trimmed_mean_s: float
    times_s: List[float]
    r: int                        # reps actually collected
    k: int                        # trim actually applied (effective k)
    ci_half_width_s: float = 0.0  # normal-CI half-width of the trimmed mean
    r_cap: int = 0                # eq. 3 cap in force (0 → legacy/unknown)
    raced_out: bool = False       # aborted: lower bound lost to incumbent
    deterministic: bool = False   # analytic timer, single rep is exact

    @property
    def raw_mean_s(self) -> float:
        return float(np.mean(self.times_s))

    @property
    def ci_rel(self) -> float:
        """CI half-width relative to the trimmed mean."""
        return self.ci_half_width_s / self.trimmed_mean_s \
            if self.trimmed_mean_s else 0.0

    @property
    def lower_bound_s(self) -> float:
        """Optimistic lower bound: the best observed rep minus the CI
        half-width — what incumbent racing compares against."""
        return min(self.times_s) - self.ci_half_width_s


def trimmed_mean(times: Sequence[float], k: int) -> float:
    """Eq. 3: drop lowest/highest k of R sorted measurements (R > 2k)."""
    r = len(times)
    if r <= 2 * k:
        raise ValueError(f"R={r} must exceed 2k={2 * k}")
    s = sorted(times)
    kept = s[k:r - k] if k else s
    return float(np.mean(kept))


# name → zero-arg factory; lets a worker reconstruct the scheduler's
# platform from the name string in an eval spec
_PLATFORM_FACTORIES: Dict[str, Callable[[], "Platform"]] = {}


def register_platform(name: str,
                      factory: Callable[[], "Platform"]) -> None:
    """Register a platform factory under ``name`` so eval specs can refer
    to platforms by string.  Re-registering a name replaces the factory."""
    _PLATFORM_FACTORIES[name] = factory


def platform_from_name(name: str) -> "Platform":
    """Reconstruct a platform from its spec string (wire form):
    ``"<name>"``, or ``"<name>@<device>"`` for a platform the caller put
    on another device than its default (``platform_to_name``)."""
    name, _, device = name.partition("@")
    try:
        factory = _PLATFORM_FACTORIES[name]
    except KeyError:
        raise KeyError(f"unknown platform {name!r}; registered: "
                       f"{sorted(_PLATFORM_FACTORIES)}") from None
    return factory(device=device) if device else factory()


def platform_to_name(platform: "Platform") -> str:
    """The spec string a worker rebuilds ``platform`` from: its registered
    name, with ``@<device>`` when its constructor takes a device and the
    caller chose another than the card (``h100-model@cpu``), so a worker
    runs where the scheduler's platform does."""
    import inspect
    device = str(getattr(platform, "device", ""))
    try:
        takes = "device" in inspect.signature(type(platform)).parameters
    except (TypeError, ValueError):
        takes = False
    if takes and device and device != "cuda":
        return f"{platform.name}@{device}"
    return platform.name


class Platform:
    name: str = "abstract"
    # True → timing is analytic/deterministic: candidates can be timed
    # from concurrent workers with no coordination at all.  Measured
    # platforms stay False, which routes their timing through the
    # measurement engine's timing lease.
    concurrency_safe: bool = False
    # the build the platform times (and integration installs), and where
    # functional-equivalence checks run
    impl: str = "torch"
    device: str = "cpu"
    # True → every timed candidate first passes FE through the kernel
    # build, whatever ``OptConfig.check_kernel`` says
    check_kernel: bool = False

    def time_variant(self, case: KernelCase, variant: Variant, scale: int,
                     inputs, *, r: int, k: int,
                     budget=None,
                     incumbent_s: Optional[float] = None) -> TimingResult:
        """Eq. 3 timing.  ``r`` is the rep cap, ``k`` the trim count;
        ``budget`` (a ``measure.MeasureConfig``) enables the adaptive
        engine's CI-based early stop and carries the timing lease, and
        ``incumbent_s`` arms incumbent racing."""
        raise NotImplementedError

    def profile_feedback(self, case: KernelCase, variant: Variant,
                         scale: int) -> Dict[str, float]:
        """Profiler counters handed to the proposer (arithmetic intensity,
        tile fill, shared memory, ...)."""
        fl = case.flops(scale)
        tb = case.generic_traffic(variant, scale)
        return {
            "flops": fl,
            "traffic_bytes": tb,
            "arithmetic_intensity": fl / max(tb, 1.0),
        }


def _measured(platform: Platform, case, variant, inputs, *, r, k, budget,
              incumbent_s) -> TimingResult:
    import torch

    from repro_torch.core.fe import as_tensors
    from repro_torch.core.measure import measure_fn
    fn = case.build(variant, impl=platform.impl)
    with torch.no_grad():
        return measure_fn(fn, as_tensors(inputs, platform.device), r=r, k=k,
                          cfg=budget, incumbent_s=incumbent_s)


class TorchCPUPlatform(Platform):
    """Wall-clocks the ``torch`` build on the host CPU (measured)."""
    name = "torch-cpu"
    impl = "torch"
    device = "cpu"

    def time_variant(self, case, variant, scale, inputs, *, r, k,
                     budget=None, incumbent_s=None):
        return _measured(self, case, variant, inputs, r=r, k=k,
                         budget=budget, incumbent_s=incumbent_s)


class H100Platform(Platform):
    """Times the ``cuda`` build (the hand-written kernel) on the card with
    CUDA events (measured).  Raises without a GPU."""
    name = "h100"
    impl = "cuda"
    check_kernel = True

    def __init__(self, device="cuda"):
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError("the h100 platform times on the card; use "
                             "torch-cpu or h100-model on the CPU")
        self.device = str(dev)

    def time_variant(self, case, variant, scale, inputs, *, r, k,
                     budget=None, incumbent_s=None):
        return _measured(self, case, variant, inputs, r=r, k=k,
                         budget=budget, incumbent_s=incumbent_s)

    def profile_feedback(self, case, variant, scale):
        return _hopper_feedback(self, case, variant, scale)


class H100TorchPlatform(H100Platform):
    """Times the ``torch`` build on the card with CUDA events (measured),
    as the JAX ``CPUPlatform`` times the ``jnp`` build on JAX's default
    device.  Raises without a GPU."""
    name = "h100-torch"
    impl = "torch"
    check_kernel = False

    def profile_feedback(self, case, variant, scale):
        return Platform.profile_feedback(self, case, variant, scale)


class H100ModelPlatform(Platform):
    """Analytic H100 roofline: t = max(flops/peak ÷ tile fill,
    traffic/3.35 TB/s) + launch overhead + the case's latency term.

    bf16 variants count bf16 bytes and the dense bf16 tensor-core peak,
    f32 variants the f32 CUDA-core peak.  The per-variant traffic model is
    where tiling matters: a GEMM with block (bm, bn, bk) re-reads A
    N/bn times and B M/bm times.  Functional-equivalence checks run the
    ``cuda`` build on ``device``."""
    name = "h100-model"
    impl = "cuda"
    concurrency_safe = True      # analytic, no shared timing state
    LAUNCH_OVERHEAD_S = 5e-6     # one CUDA kernel launch

    def __init__(self, device="cuda"):
        self.device = str(resolve_device(device))

    def time_variant(self, case, variant, scale, inputs, *, r, k,
                     budget=None, incumbent_s=None):
        fl = case.flops(scale)
        tb = case.generic_traffic(variant, scale)
        if variant.get("compute_dtype") == "bf16":
            tb *= 0.5                  # bf16 storage halves the traffic
            fl_t = fl / hw.PEAK_FLOPS_BF16
        else:
            fl_t = fl / hw.PEAK_FLOPS_F32
        mem_t = tb / hw.HBM_BW
        util = variant_mxu_utilization(variant)
        t = (max(fl_t / util, mem_t) + self.LAUNCH_OVERHEAD_S
             + case.variant_latency(variant, scale))
        # a pure function of (variant, scale): one rep is the distribution
        return TimingResult(t, [t], 1, 0, ci_half_width_s=0.0,
                            r_cap=max(1, int(r)), deterministic=True)

    def profile_feedback(self, case, variant, scale):
        return _hopper_feedback(self, case, variant, scale)


def _hopper_feedback(platform, case, variant, scale):
    fb = Platform.profile_feedback(platform, case, variant, scale)
    fb["mxu_utilization"] = variant_mxu_utilization(variant)
    fb["vmem_bytes"] = variant_smem_bytes(variant, scale, case)
    lat = case.variant_latency(variant, scale)
    roof = max(case.flops(scale) / hw.PEAK_FLOPS_BF16,
               case.generic_traffic(variant, scale) / hw.HBM_BW)
    fb["latency_s"] = lat
    fb["latency_fraction"] = lat / max(lat + roof, 1e-12)
    return fb


register_platform(TorchCPUPlatform.name, TorchCPUPlatform)
register_platform(H100Platform.name, H100Platform)
register_platform(H100TorchPlatform.name, H100TorchPlatform)
register_platform(H100ModelPlatform.name, H100ModelPlatform)


def variant_mxu_utilization(variant: Variant) -> float:
    """Tile fill on Hopper: a tile side that is a multiple of 64 fills a
    warpgroup MMA tile (64 rows) and K1's 16 x 16 thread grid; a multiple
    of 16 below 64 fills that share of the MMA tile (0.9 above 64); any
    other side leaves threads of the grid idle (0.5)."""
    util = 1.0
    for key in ("block_m", "block_n", "block_k", "block"):
        b = variant.get(key)
        if b is None or b % 64 == 0:
            continue
        if b % 16 == 0:
            util = min(util, b / 64 if b < 64 else 0.9)
        else:
            util = min(util, 0.5)
    return max(util, 0.05)


def variant_smem_bytes(variant: Variant, scale: Optional[int] = None,
                       case: Optional[KernelCase] = None) -> int:
    """Shared memory one block of K1 (or K5, whose tile is K1's) allocates
    for the variant's tile, equal to the kernel's own allocation
    (``kernels.matmul.smem_bytes``): with ``scale`` the tile is first
    fitted to the GEMM's (M, N, K) at that scale as the wrapper fits it
    (``case.tile_dims``; square without a case); without, the variant's
    tile as named (an upper bound, since fitting only shrinks).  Variants
    without a GEMM tile (``block_m``/``block_n``) allocate nothing that the
    variant changes: 0."""
    if "block_m" not in variant and "block_n" not in variant:
        return 0
    bm = variant.get("block_m", 128)
    bn = variant.get("block_n", 128)
    bk = variant.get("block_k", 128)
    if scale is not None:
        M, N, K = case.tile_dims(scale) if case else (scale,) * 3
        bm, bn, bk = fit(bm, M), fit(bn, N), fit(bk, K)
    dt = 2 if variant.get("compute_dtype") == "bf16" else 4
    return smem_bytes(bm, bn, bk, dt)


SMEM_BYTES = hw.SMEM_PER_BLOCK
