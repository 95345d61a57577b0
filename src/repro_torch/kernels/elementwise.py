"""1-D blocked map ``o = fn(*arrays)`` on Hopper in Triton, and its plain
PyTorch version.

Port of ``repro.kernels.suites.pallas_lib.elementwise_pallas`` (the Pallas
kernel launched at ``pallas_lib.py:125``): one fused pass over arrays of
one length, each program mapping one block of ``block`` elements (fitted to
a divisor of the length, as ``_fit`` does) through the caller's ``fn``,
the output in ``arrays[0]``'s dtype.

The Pallas kernel traces any ``fn`` into its body (``_map_kernel``).  A
library compiled by nvcc cannot take a Python function, so this kernel is
Triton: the wrapper compiles the caller's ``fn`` with ``triton.jit`` (once
per function) and hands it to the kernel as a compile-time argument, which
calls it on the loaded blocks.  ``fn`` must therefore be a module-level
function whose body is elementwise arithmetic that both PyTorch tensors
and Triton blocks accept (``x + y``); the plain version calls the same
``fn`` on the tensors.  The kernel's block is a power of two, the fitted
block rounded up, with the tail masked.

Bound on the H100 (SXM, 3.35 TB/s HBM): a map reads each input once and
writes the output once with a few operations an element, so bytes bound it:
``vectoradd`` at n = 16,777,216 f32 moves 201 MB, 60 us.

``triton`` is imported, and the kernel compiled, at the first launch, never
at import; compiled kernels go to ``build/triton/`` at the repository root
unless ``TRITON_CACHE_DIR`` says otherwise.  On CPU tensors the wrapper
computes the plain version; on CUDA tensors it launches the kernel or
raises (a compile failure raises).
"""
from __future__ import annotations  # the kernel's annotations stay strings

import os
from typing import Callable, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.matmul import fit

MAX_INPUTS = 3
tl = None                 # triton.language, bound at the first launch
_kernel = None            # the triton.jit of _map_kernel
_jitted: Dict[Callable, object] = {}     # fn -> triton.jit(fn)


def _map_kernel(o_ptr, a_ptr, b_ptr, c_ptr, blk, FN: tl.constexpr,
                N_IN: tl.constexpr, BLOCK: tl.constexpr):
    """Program i maps elements [i * blk, (i + 1) * blk): BLOCK lanes, the
    ones past blk masked; FN takes N_IN loaded blocks."""
    lane = tl.arange(0, BLOCK)
    mask = lane < blk
    offs = tl.program_id(0).to(tl.int64) * blk + lane
    a = tl.load(a_ptr + offs, mask=mask)
    if N_IN == 1:
        out = FN(a)
    elif N_IN == 2:
        out = FN(a, tl.load(b_ptr + offs, mask=mask))
    else:
        out = FN(a, tl.load(b_ptr + offs, mask=mask),
                 tl.load(c_ptr + offs, mask=mask))
    tl.store(o_ptr + offs, out.to(o_ptr.dtype.element_ty), mask=mask)


def _check(arrays) -> None:
    """Raises on what the kernel does not take (shared with the plain
    version, so CPU runs reject what the card would)."""
    if not 1 <= len(arrays) <= MAX_INPUTS:
        raise ValueError(f"takes 1 to {MAX_INPUTS} arrays, got {len(arrays)}")
    n = arrays[0].shape[0] if arrays[0].dim() == 1 else -1
    if n <= 0 or any(a.dim() != 1 or a.shape[0] != n for a in arrays):
        raise ValueError(f"expected non-empty 1-D arrays of one length, got "
                         f"{[tuple(a.shape) for a in arrays]}")


def elementwise_plain(fn, *arrays, block: int = 8192):
    """Plain version of the kernel: ``fn`` on the whole tensors, in
    ``arrays[0]``'s dtype (``block`` only cuts the kernel's grid)."""
    _check(arrays)
    return fn(*arrays).to(arrays[0].dtype)


def _compile(fn):
    """The Triton kernel and ``fn`` jitted for it (each compiled once)."""
    global tl, _kernel
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(build.BUILD_DIR.parent / "triton"))
    import triton
    import triton.language
    tl = triton.language
    if _kernel is None:
        _kernel = triton.jit(_map_kernel)
    if fn not in _jitted:
        _jitted[fn] = triton.jit(fn)
    return _kernel, _jitted[fn]


def elementwise(fn, *arrays, block: int = 8192, device="cuda"):
    """o = fn(*arrays) over 1-D arrays of one length, in ``arrays[0]``'s
    dtype.

    ``device`` names where the caller expects to run (default the GPU) and
    must match the tensors'.  CPU tensors take ``elementwise_plain``; CUDA
    tensors launch the Triton kernel on the current stream, with no
    fallback.
    """
    dev = resolve_device(device)
    for i, a in enumerate(arrays):
        if a.device.type != dev.type:
            raise ValueError(f"array {i} lies on {a.device}, not on {dev}")
    _check(arrays)
    if dev.type == "cpu":
        return elementwise_plain(fn, *arrays, block=block)
    if any(a.device != arrays[0].device for a in arrays):
        raise ValueError("the arrays must lie on one device")
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError("the arrays must be contiguous")
    n = arrays[0].shape[0]
    blk = fit(block, n)
    BLOCK = 1 << (blk - 1).bit_length()
    kernel, fn_jit = _compile(fn)
    o = torch.empty_like(arrays[0])
    ptrs = list(arrays) + [arrays[0]] * (MAX_INPUTS - len(arrays))
    with torch.cuda.device(o.device):
        kernel[(n // blk,)](o, *ptrs, blk, FN=fn_jit, N_IN=len(arrays),
                            BLOCK=BLOCK, num_warps=4 if BLOCK <= 2048 else 8)
    elementwise.launches += 1
    return o


elementwise.launches = 0
