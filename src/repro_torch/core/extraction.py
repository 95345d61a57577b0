"""Hotspot kernel extraction (paper §3.1, "independently extracted hotspot
kernels").

Port of ``repro.core.extraction``.  The reference walks the jaxpr of an
application step, multiplying by scan trip counts; the port cannot walk a
jaxpr, so it runs the step once and counts the products that actually run:

* a ``TorchDispatchMode`` sees every aten product (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, ``mv``, ``dot``, ``convolution`` ...) with its
  operand shapes, forward and backward, and counts ``2 · out ·
  contracted`` FLOPs for it, as the reference's ``_prim_flops`` does for a
  ``dot_general``.  A Python loop over the layers runs a layer's product
  once a layer, so ``count`` comes out ``n_layers`` as the reference's trip
  multiplication gives it;
* a ``TorchFunctionMode`` names each product by the call that made it: the
  equation of a ``torch.einsum`` (the reference's sources are the einsum
  specs, ``bsd,df->bsf``), else the call site ``file.py:line function``
  (the port writes projections as ``x @ w``, which has no spec).  It tags
  the autograd nodes the call made, so a product of the backward pass is
  named by the forward call it differentiates, and marked ``backward``.
  A product recomputed in the backward pass (``remat``) is marked too.

``classify`` gives the reference's families and ops-registry splice points:
the attention einsums → ``attention`` at ``'attention'``, the recurrent
ones → ``scan`` at ``'rwkv_wkv / ssm_chunk'``, the MoE expert products
(the reference's ``becd,edf`` specs; the port's batched products of
``layers._moe_experts``) → ``matmul`` at ``'moe_gemm'``, every other product
``matmul``.  Unlike the reference, elementwise operations are not counted
(it counts them at one FLOP an element, family ``elementwise``).

    from repro_torch.core import extraction
    spots = extraction.profile_hotspots(train_step, params, opt, batch)
    print(extraction.report(spots))
"""
from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode


@dataclass
class Hotspot:
    primitive: str                 # the aten product: mm, bmm, addmm, ...
    flops: float
    shapes: Tuple[Tuple[int, ...], ...]
    source: str                    # einsum spec, or file.py:line function
    count: int = 1                 # occurrences in the run
    family: str = ""               # matmul | attention | scan | stencil
    suggested_site: str = ""       # ops-registry splice point, if known
    backward: bool = False         # ran in the backward pass

    def __str__(self) -> str:
        return (f"{self.flops:10.3e} flops  {self.primitive:14s} "
                f"{'x'.join(str(s) for s in self.shapes[:2])!s:40.40s} "
                f"{self.family:10s} {self.source}"
                + ("  (backward)" if self.backward else ""))


def _numel(shape) -> int:
    return math.prod(shape)


def _mm(a, b):                 # [M, K] @ [K, N]
    return 2.0 * a[0] * b[-1] * a[-1]


def _bmm(a, b):                # [B, M, K] @ [B, K, N]
    return 2.0 * a[0] * a[1] * b[-1] * a[-1]


# aten product → (operand positions, FLOPs of their shapes)
_PRODUCTS = {
    "mm": ((0, 1), _mm),
    "addmm": ((1, 2), _mm),
    "bmm": ((0, 1), _bmm),
    "baddbmm": ((1, 2), _bmm),
    "mv": ((0, 1), lambda a, v: 2.0 * a[0] * a[1]),
    "addmv": ((1, 2), lambda a, v: 2.0 * a[0] * a[1]),
    "dot": ((0, 1), lambda a, b: 2.0 * a[0]),
    "vdot": ((0, 1), lambda a, b: 2.0 * a[0]),
    "convolution": ((0, 1), None),
}
PRODUCTS = frozenset(_PRODUCTS)

# the calls that make products, named by the function mode
_NAMED = {torch.einsum, torch.matmul, torch.Tensor.matmul,
          torch.Tensor.__matmul__, torch.Tensor.__rmatmul__, torch.mm,
          torch.Tensor.mm, torch.bmm, torch.Tensor.bmm}
_HERE = os.path.abspath(__file__)
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_TAG = "extraction_source"


def _call_site() -> str:
    frame = sys._getframe(2)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if path != _HERE and not path.startswith(_TORCH_DIR):
            return (f"{os.path.basename(path)}:{frame.f_lineno} "
                    f"{frame.f_code.co_name}")
        frame = frame.f_back
    return "?"


def _tag_nodes(out, args, source: str) -> None:
    """Marks the autograd nodes between ``out`` and the inputs with
    ``source``, so the backward products they run carry its name."""
    if not isinstance(out, torch.Tensor) or out.grad_fn is None:
        return
    stop = {a.grad_fn for a in args
            if isinstance(a, torch.Tensor) and a.grad_fn is not None}
    todo = [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in stop or _TAG in node.metadata \
                or node.name() == "torch::autograd::AccumulateGrad":
            continue
        node.metadata[_TAG] = source
        todo.extend(n for n, _ in node.next_functions)


class _Names(TorchFunctionMode):
    def __init__(self, stack):
        super().__init__()
        self.stack = stack

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _NAMED:
            return func(*args, **kwargs)
        if func is torch.einsum and args and isinstance(args[0], str):
            source = args[0].replace(" ", "")
            operands = args[1:]
        else:
            source, operands = _call_site(), args
        if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
            operands = operands[0]
        self.stack.append(source)
        try:
            out = func(*args, **kwargs)
        finally:
            self.stack.pop()
        _tag_nodes(out, operands, source)
        return out


class _Products(TorchDispatchMode):
    def __init__(self, stack, acc):
        super().__init__()
        self.stack, self.acc = stack, acc

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in _PRODUCTS:
            self._count(name, args, out)
        return out

    def _count(self, name, args, out):
        positions, rule = _PRODUCTS[name]
        shapes = tuple(tuple(args[i].shape) for i in positions)
        if rule is None:        # convolution: 2 · out · (C_in/groups · k...)
            flops = 2.0 * out.numel() * _numel(shapes[1][1:])
        else:
            flops = rule(*shapes)
        node = torch._C._current_autograd_node()
        if self.stack:
            source = self.stack[-1]
        elif node is not None:
            source = node.metadata.get(_TAG, node.name())
        else:
            source = "?"
        key = (name, source, shapes, node is not None)
        spot = self.acc.get(key)
        if spot is None:
            self.acc[key] = Hotspot(name, flops, shapes, source,
                                    backward=node is not None)
        else:
            spot.flops += flops
            spot.count += 1


_ATTENTION_SPECS = ("bckgh", "bkgct", "bkgt", "bskgh", "bkgst")
_SCAN_SPECS = ("bnhk", "bnhkv", "bnts", "bnthp", "bnshp", "bhkv", "bhpn")
_MOE_SPECS = ("becd", "becf", "bsef", "emk", "edf", "efd")
# call sites whose batched products (bmm) are the MoE expert GEMMs
_GROUPED_SITES = {"_moe_experts": "moe_gemm"}


def classify(spot: Hotspot) -> Hotspot:
    src = spot.source
    if spot.primitive == "convolution":
        spot.family = "stencil"
    elif spot.primitive in PRODUCTS:
        spot.family = "matmul"
        if any(t in src for t in _ATTENTION_SPECS):
            spot.family, spot.suggested_site = "attention", "attention"
        elif any(t in src for t in _SCAN_SPECS):
            spot.family = "scan"
            spot.suggested_site = "rwkv_wkv / ssm_chunk"
        elif any(t in src for t in _MOE_SPECS):
            spot.family, spot.suggested_site = "matmul", "moe_gemm"
        elif spot.primitive in ("bmm", "baddbmm"):
            fn = src.rsplit(" ", 1)[-1]
            if fn in _GROUPED_SITES:
                spot.suggested_site = _GROUPED_SITES[fn]
    else:
        spot.family = "elementwise"
    return spot


def profile_all(fn, *args, **kw) -> List[Hotspot]:
    """Every product ``fn(*args, **kw)`` ran, classified, heaviest first."""
    acc: Dict[Tuple, Hotspot] = {}
    stack: List[str] = []
    with _Names(stack), _Products(stack, acc):
        fn(*args, **kw)
    return [classify(s) for s in sorted(acc.values(), key=lambda h: -h.flops)]


def profile_hotspots(fn, *args, top: int = 10, **kw) -> List[Hotspot]:
    """Runs ``fn(*args, **kw)`` once and returns its ``top`` products by
    FLOPs, classified."""
    return profile_all(fn, *args, **kw)[:top]


def report(spots: List[Hotspot]) -> str:
    total = sum(s.flops for s in spots)
    lines = [f"top {len(spots)} hotspots ({total:.3e} flops attributed):"]
    for i, s in enumerate(spots):
        pct = 100.0 * s.flops / total if total else 0.0
        lines.append(f"  {i+1:2d}. [{pct:5.1f}%] {s}")
        if s.suggested_site:
            lines.append(f"       → splice point: ops site "
                         f"'{s.suggested_site}'")
    return "\n".join(lines)
