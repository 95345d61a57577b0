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
``vectoradd`` at n = 16,777,216 f32 moves 201 MB, 60 us.  The body sits
near that; what a call loses is host time.  So the launch is cached: the
first call at a launch key (``launch_key``: everything Triton specializes
the kernel on) compiles it through ``JITFunction.run`` and keeps the
``CompiledKernel``; every later call at that key goes straight to the
compiled kernel's own launcher on the raw stream handle, with its checks,
block fitting and grid cached, and enters the device's context only where
the tensors' device is not the current one.  A view off 16 bytes has
another key, so it never runs a kernel compiled for aligned pointers.

``triton`` is imported, and the kernel compiled, at the first launch, never
at import; compiled kernels go to ``build/triton/`` at the repository root
unless ``TRITON_CACHE_DIR`` says otherwise.  On CPU tensors the wrapper
computes the plain version; on CUDA tensors it launches the kernel or
raises (a compile or launch failure raises).
"""
from __future__ import annotations  # the kernel's annotations stay strings

import functools
import os
from typing import Callable, Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.launch import names_cuda, raw_stream
from repro_torch.kernels.matmul import fit

MAX_INPUTS = 3
# The Triton release whose launcher convention ``launch_args`` follows
# (``runtime/jit.py``, ``compiler/compiler.py``); another refuses to launch.
LAUNCHER_TRITON = (3, 6)
tl = None                 # triton.language, bound at the first launch
_kernel = None            # the triton.jit of _map_kernel
_jitted: Dict[Callable, object] = {}     # fn -> triton.jit(fn)
# launch key -> (the compiled kernel's launcher, its CUfunction, its packed
# metadata, the jitted fn, the CompiledKernel), from the first launch at
# that key
_launches: Dict[Tuple, Tuple] = {}


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


def check_triton(version: str) -> None:
    """Raises unless ``version`` is a release of ``LAUNCHER_TRITON``: the
    cached launch passes its arguments in that release's order, which
    Triton has changed between releases."""
    parts = version.split(".")[:2]
    if tuple(int(p) if p.isdigit() else -1 for p in parts) \
            != LAUNCHER_TRITON:
        raise RuntimeError(
            f"elementwise launches through Triton "
            f"{'.'.join(map(str, LAUNCHER_TRITON))}'s launcher convention; "
            f"the installed Triton is {version}")


def _compile(fn):
    """The Triton kernel and ``fn`` jitted for it (each compiled once)."""
    global tl, _kernel
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(build.BUILD_DIR.parent / "triton"))
    import triton
    import triton.language
    check_triton(triton.__version__)
    tl = triton.language
    if _kernel is None:
        _kernel = triton.jit(_map_kernel)
    if fn not in _jitted:
        _jitted[fn] = triton.jit(fn)
    return _kernel, _jitted[fn]


@functools.lru_cache(maxsize=1024)
def _grid(block: int, n: int):
    """(blk, BLOCK, num_warps): the fitted block, the kernel's power-of-two
    block and its warps."""
    blk = fit(block, n)
    BLOCK = 1 << (blk - 1).bit_length()
    return blk, BLOCK, 4 if BLOCK <= 2048 else 8


def launch_key(fn, n_in: int, tensors, blk: int, BLOCK: int,
               num_warps: int) -> Tuple:
    """Everything the Triton kernel is specialized on: ``fn``, N_IN, BLOCK,
    ``num_warps``, the device, each pointer's dtype and whether its address
    is a multiple of 16 bytes (``tensors``: o, then the three input slots),
    and whether ``blk`` is a multiple of 16, is 1, or takes 64 bits.  A
    launch reuses a compiled kernel only at an equal key."""
    return (fn, n_in, BLOCK, num_warps, tensors[0].get_device(),
            blk % 16 == 0, blk == 1, blk >= 2 ** 31,
            *[(t.dtype, t.data_ptr() % 16 == 0) for t in tensors])


def launch_args(entry, grid: int, stream: int, tensors, blk: int, n_in: int,
                BLOCK: int) -> Tuple:
    """The arguments of a cached kernel's launcher, as the installed
    Triton's ``JITFunction.run`` passes them (``kernel.run(grid_0, grid_1,
    grid_2, stream, kernel.function, kernel.packed_metadata,
    launch_metadata, launch_enter_hook, launch_exit_hook,
    *bound_args.values())`` in Triton 3.6's ``runtime/jit.py``): no launch
    metadata and no hooks, then every argument of ``_map_kernel`` in order,
    constexprs included (the launcher skips those).  Pointers go as
    integers, which the launcher takes as they are."""
    _, function, packed, fn_jit, _ = entry
    return (grid, 1, 1, stream, function, packed, None, None, None,
            *[t.data_ptr() for t in tensors], blk, fn_jit, n_in, BLOCK)


def _compile_launch(key, fn, grid, tensors, blk, n_in, BLOCK, num_warps):
    """The first launch at ``key``: through ``JITFunction.run``, which
    compiles (or loads from Triton's cache) and launches; keeps what the
    later launches need.  Counts a compile."""
    kernel, fn_jit = _compile(fn)
    with torch.cuda.device(tensors[0].device):
        compiled = kernel[(grid,)](*tensors, blk, FN=fn_jit, N_IN=n_in,
                                   BLOCK=BLOCK, num_warps=num_warps)
    _launches[key] = (compiled.run, compiled.function,
                      compiled.packed_metadata, fn_jit, compiled)
    elementwise.compiles += 1


def elementwise(fn, *arrays, block: int = 8192, device="cuda"):
    """o = fn(*arrays) over 1-D arrays of one length, in ``arrays[0]``'s
    dtype.

    ``device`` names where the caller expects to run (default the GPU) and
    must match the tensors'.  CPU tensors take ``elementwise_plain``; CUDA
    tensors launch the Triton kernel on the current stream, with no
    fallback.
    """
    a0 = arrays[0] if arrays else None
    if not (a0 is not None and a0.is_cuda and names_cuda(device)):
        dev = resolve_device(device)
        for i, a in enumerate(arrays):
            if a.device.type != dev.type:
                raise ValueError(f"array {i} lies on {a.device}, not on "
                                 f"{dev}")
        return elementwise_plain(fn, *arrays, block=block)
    _check(arrays)
    index = a0.get_device()
    if any(a.get_device() != index for a in arrays):
        raise ValueError("the arrays must lie on one device, not "
                         + ", ".join(str(a.device) for a in arrays))
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError("the arrays must be contiguous")
    n_in, n = len(arrays), a0.shape[0]
    blk, BLOCK, num_warps = _grid(block, n)
    tensors = (torch.empty_like(a0), *arrays,
               *(a0,) * (MAX_INPUTS - n_in))
    key = launch_key(fn, n_in, tensors, blk, BLOCK, num_warps)
    entry = _launches.get(key)
    if entry is None:
        _compile_launch(key, fn, n // blk, tensors, blk, n_in, BLOCK,
                        num_warps)
    else:
        args = launch_args(entry, n // blk, raw_stream(index), tensors, blk,
                           n_in, BLOCK)
        if torch._C._cuda_getDevice() == index:
            entry[0](*args)
        else:
            with torch.cuda.device(index):
                entry[0](*args)
        elementwise.cache_hits += 1
    elementwise.launches += 1
    return tensors[0]


elementwise.launches = 0
elementwise.compiles = 0       # first launches at a key (JITFunction.run)
elementwise.cache_hits = 0     # launches through a cached compiled kernel
