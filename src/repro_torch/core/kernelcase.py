"""KernelCase: the uniform abstraction for an independently-extracted
hotspot kernel (paper §3.1).

Port of ``repro.core.kernelcase``.  The same dataclasses and registry; the
builds return PyTorch callables: ``impl='torch'`` (the counterpart of
``'jnp'``) gives the algorithmic restructuring as plain PyTorch, and
``impl='cuda'`` (the counterpart of ``'pallas'``) calls the hand-written
Hopper kernel where the JAX build calls its Pallas kernel.  The registry
holds every case of the JAX package: PolyBench, APP SDK and the hpc
hotspots.

A case bundles everything the MEP framework needs to optimize a kernel
without its host application:

  * ``ref``                — the plain PyTorch oracle (functional semantics)
  * ``build(variant, impl)`` — construct an executable candidate from a
    point in the variant space (``impl`` 'torch' or 'cuda', above)
  * ``input_specs(scale)``  — shapes/dtypes/generator kinds per input
  * ``variant_space``       — the tunable-parameter grid the proposers walk
  * ``flops/traffic model`` — analytic terms for the roofline platform

Variants are plain dicts so they serialize into the Performance Pattern
Inheritance store.
"""
from __future__ import annotations

import hashlib
import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Variant = Dict[str, Any]


def _fn_fingerprint(fn: Callable) -> str:
    """Stable fingerprint of a function's implementation: its source when
    available, else its compiled code object (dynamically-generated
    functions).  Changing the function body changes the fingerprint."""
    try:
        return inspect.getsource(fn)
    except (OSError, TypeError):
        code = getattr(fn, "__code__", None)
        if code is None:
            return repr(fn)
        return repr((code.co_code, code.co_consts, code.co_names))


@dataclass(frozen=True)
class ArraySpec:
    shape: Tuple[int, ...]
    dtype: str = "float32"
    kind: str = "normal"      # normal | uniform | positive | int | sorted
    #                           | symmetric | spd | tokens
    minval: float = 0.0
    maxval: float = 1.0

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * np.dtype(self.dtype).itemsize


@dataclass
class KernelCase:
    name: str
    suite: str                                    # polybench | appsdk | hpc
    family: str                                   # matmul | matvec | stencil
    #                                               | reduction | scan | sort
    #                                               | elementwise | attention
    ref: Callable[..., Any]
    build: Callable[..., Callable]                # (variant, impl) -> fn
    input_specs: Callable[[int], List[ArraySpec]]
    variant_space: Dict[str, List[Any]]
    baseline_variant: Variant
    flops: Callable[[int], float]
    scales: Sequence[int] = (256, 512, 1024, 2048)
    # analytic per-variant HBM traffic for the roofline platform (None →
    # generic model)
    traffic: Optional[Callable[[Variant, int], float]] = None
    # analytic serialization latency (sequential scan steps, kernel-launch
    # chains)
    latency: Optional[Callable[[Variant, int], float]] = None
    # hotspot site in the full application ('' = standalone benchmark only)
    app_site: str = ""
    # (M, N, K) of the GEMM whose tile the variant's block_m/n/k name, at a
    # scale (None: square, (scale, scale, scale)); the shared-memory
    # estimate fits the tile to it as the kernel's wrapper does
    gemm_dims: Optional[Callable[[int], Tuple[int, int, int]]] = None
    notes: str = ""
    # init=False: dataclasses.replace(case, build=...) must re-derive the
    # digest for the new build, never inherit the stale cached one
    _digest: Optional[str] = field(default=None, init=False, repr=False,
                                   compare=False)

    def source_digest(self) -> str:
        """Digest of the case's kernel-construction code (``build`` and the
        ``ref`` oracle).  Stamped into every EvalCache key so editing a
        case's kernel source invalidates its persisted timings instead of
        silently replaying stale measurements (ROADMAP: eval-cache
        invalidation)."""
        if self._digest is None:
            blob = "\0".join((_fn_fingerprint(self.build),
                              _fn_fingerprint(self.ref)))
            self._digest = hashlib.sha256(blob.encode()).hexdigest()[:12]
        return self._digest

    def to_dict(self) -> Dict[str, Any]:
        """Wire form of a case.  A case's behavior lives in its callables,
        which cannot cross a process boundary — what travels is the
        *reference*: registry name plus the source digest, so the
        receiving worker can prove it reconstructed the same kernel code
        the scheduler shipped (see ``from_dict``)."""
        return {"name": self.name, "suite": self.suite,
                "family": self.family, "digest": self.source_digest()}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "KernelCase":
        """Resolve a wire-form case from the registry, refusing to proceed
        if the local kernel source differs from what the scheduler
        serialized — a silent digest mismatch would evaluate different
        code under the sender's cache keys."""
        case = get_case(d["name"])
        want = d.get("digest")
        if want and case.source_digest() != want:
            raise ValueError(
                f"kernel case {d['name']!r} source digest mismatch: "
                f"scheduler sent {want}, this process has "
                f"{case.source_digest()} — scheduler and worker must run "
                f"the same code")
        return case

    def data_bytes(self, scale: int) -> int:
        return sum(s.nbytes for s in self.input_specs(scale))

    def variant_latency(self, variant: Variant, scale: int) -> float:
        return self.latency(variant, scale) if self.latency else 0.0

    def tile_dims(self, scale: int) -> Tuple[int, int, int]:
        return self.gemm_dims(scale) if self.gemm_dims else (scale,) * 3

    def generic_traffic(self, variant: Variant, scale: int) -> float:
        """Default HBM traffic model: every input read once, output written
        once — cases with tiling-dependent reuse override via ``traffic``."""
        if self.traffic is not None:
            return self.traffic(variant, scale)
        return 2.0 * self.data_bytes(scale)


_REGISTRY: Dict[str, KernelCase] = {}


def register(case: KernelCase) -> KernelCase:
    if case.name in _REGISTRY:
        raise ValueError(f"duplicate kernel case {case.name!r}")
    _REGISTRY[case.name] = case
    return case


def get_case(name: str) -> KernelCase:
    _ensure_suites()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown kernel case {name!r}; have "
                       f"{sorted(_REGISTRY)}") from None


def cases(suite: Optional[str] = None) -> List[KernelCase]:
    _ensure_suites()
    out = [c for c in _REGISTRY.values() if suite is None or c.suite == suite]
    return sorted(out, key=lambda c: c.name)


_loaded = False


def _ensure_suites() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    # importing registers the cases
    from repro_torch.kernels.suites import appsdk, hpc, polybench  # noqa: F401
