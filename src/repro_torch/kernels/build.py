"""Builds the port's CUDA sources at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``.  Libraries go
to ``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the source, the shared headers (``csrc/*.cuh``) and the
compiler flags, so an edited source or header is rebuilt and an unchanged
one is reused.  Nothing is built at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 if reused), "ptxas": nvcc's report}
build_info: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build(*names: str) -> List[ctypes.CDLL]:
    """The loaded libraries built from ``csrc/<name>.cu``.  The missing
    ones are compiled by one ``nvcc`` each, all started together; a
    failed build raises with nvcc's report."""
    with _lock:
        todo = [n for n in dict.fromkeys(names) if n not in _libs]
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))
                           ) if todo else b""
        jobs = []
        for name in todo:
            src = CSRC / f"{name}.cu"
            digest = hashlib.sha256(src.read_bytes() + headers
                                    + " ".join(FLAGS).encode()).hexdigest()
            out = BUILD_DIR / f"{name}-{digest[:16]}.so"
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = None
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                proc = subprocess.Popen(
                    [_nvcc(), *FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
            jobs.append((name, src, out, tmp, proc, time.perf_counter()))
        errors = []
        for name, src, out, tmp, proc, t0 in jobs:
            log = out.with_suffix(".log")
            seconds = 0.0
            if proc is not None:
                _, err = proc.communicate()
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    errors.append(f"nvcc failed on {src.name} "
                                  f"(exit {proc.returncode}):\n{err}")
                    continue
                log.write_text(err)
                os.replace(tmp, out)    # atomic: concurrent builders agree
            build_info[name] = {"seconds": seconds,
                                "ptxas": log.read_text() if log.exists()
                                else ""}
            _libs[name] = ctypes.CDLL(str(out))
        if errors:
            raise RuntimeError("\n".join(errors))
        return [_libs[n] for n in names]


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if
    missing).  A loaded one is returned without the lock: every launch
    asks."""
    lib = _libs.get(name)
    return lib if lib is not None else build(name)[0]
