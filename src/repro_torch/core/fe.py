"""Functional Equivalence checks (paper eq. 4).

Port of ``repro.core.fe``.  A candidate enters the feasible set C^(d) only
if its outputs match the *baseline* kernel on the MEP's generated inputs,
with dtype-aware tolerances.  Checks run on multiple independently-seeded
input sets to avoid passing by coincidence.

The tolerance table and the verdict rule are the JAX package's.  Where the
JAX side reads a dtype as ``str(np.asarray(arr).dtype)`` (which cannot see
a torch bf16 tensor), this module maps torch dtypes explicitly; where it
flattens with ``jax.tree.leaves``, this one walks tensors, tuples and lists.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core import datagen
from repro_torch.core.kernelcase import KernelCase, Variant
from repro_torch.device import resolve_device

_TOL = {
    "float64": (1e-9, 1e-9),
    "float32": (2e-4, 2e-4),
    "bfloat16": (2e-2, 2e-2),
    "float16": (1e-2, 1e-2),
}
_TORCH_DTYPE_NAME = {torch.float64: "float64", torch.float32: "float32",
                     torch.bfloat16: "bfloat16", torch.float16: "float16"}


@dataclass
class FEResult:
    ok: bool
    max_abs_err: float
    max_rel_err: float
    detail: str = ""


def _dtype_name(arr) -> str:
    if isinstance(arr, torch.Tensor):
        return _TORCH_DTYPE_NAME.get(arr.dtype, str(arr.dtype))
    return str(np.asarray(arr).dtype)


def _tol_for(arr) -> Tuple[float, float]:
    return _TOL.get(_dtype_name(arr), (2e-4, 2e-4))


def leaves(tree) -> List:
    """The arrays of an output: a tensor (or array, or number) is one leaf;
    tuples and lists are walked in order."""
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in leaves(t)]
    return [tree]


def to_numpy(arr, dtype=np.float64) -> np.ndarray:
    """An output leaf as a numpy array (bf16 tensors through f32)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().to("cpu", torch.float64).numpy()
    return np.asarray(arr, dtype)


def outputs_match(got, want, rtol_scale: float = 1.0) -> FEResult:
    got_l, want_l = leaves(got), leaves(want)
    if len(got_l) != len(want_l):
        return FEResult(False, float("inf"), float("inf"),
                        f"output arity {len(got_l)} != {len(want_l)}")
    worst_abs = worst_rel = 0.0
    for g, w in zip(got_l, want_l):
        g, w = to_numpy(g), to_numpy(w)
        if g.shape != w.shape:
            return FEResult(False, float("inf"), float("inf"),
                            f"shape {g.shape} != {w.shape}")
        err = np.abs(g - w)
        # scale-aware relative error: near-zero elements are judged against
        # the tensor's magnitude, not their own (accumulation-order noise)
        scale = float(np.abs(w).max(initial=0.0))
        denom = np.abs(w) + 1e-2 * scale + 1e-6
        worst_abs = max(worst_abs, float(err.max(initial=0.0)))
        worst_rel = max(worst_rel, float((err / denom).max(initial=0.0)))
        if not np.all(np.isfinite(g)):
            return FEResult(False, float("inf"), float("inf"), "non-finite")
    rtol, atol = _tol_for(want_l[0])
    rtol, atol = rtol * rtol_scale, atol * rtol_scale
    ok = bool(worst_abs <= atol + rtol * 1.0 or worst_rel <= rtol * 10)
    return FEResult(ok, worst_abs, worst_rel,
                    "" if ok else f"abs={worst_abs:.2e} rel={worst_rel:.2e}")


def as_tensors(arrays, device) -> List[torch.Tensor]:
    """numpy inputs (``datagen.generate``) as tensors on ``device``."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def check(case: KernelCase, variant: Variant, scale: int, *,
          impl: str = "torch", n_input_sets: int = 2, seed: int = 0,
          rtol_scale: float = 1.0, device="cuda") -> FEResult:
    """FE(K_candidate, K_baseline): candidate vs the plain oracle on
    ``n_input_sets`` generated input sets, both run on ``device``."""
    dev = resolve_device(device)
    fn = case.build(variant, impl=impl)
    worst = FEResult(True, 0.0, 0.0)
    with torch.no_grad():
        for i in range(n_input_sets):
            inputs = as_tensors(datagen.generate(case.input_specs(scale),
                                                 seed + 1000 + i), dev)
            got = fn(*inputs)
            want = case.ref(*inputs)
            r = outputs_match(got, want, rtol_scale)
            if not r.ok:
                return r
            worst = FEResult(True, max(worst.max_abs_err, r.max_abs_err),
                             max(worst.max_rel_err, r.max_rel_err))
    return worst
