"""Builds the port's CUDA sources at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``.  Libraries go
to ``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the source and the compiler flags, so an edited source
is rebuilt and an unchanged one is reused.  Nothing is built at import.
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
from typing import Dict

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


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if missing)."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"{name}-{digest}.so"
        log = out.with_suffix(".log")
        seconds = 0.0
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            res = subprocess.run([_nvcc(), *FLAGS, "-o", str(tmp), str(src)],
                                 capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"(exit {res.returncode}):\n{res.stderr}")
            log.write_text(res.stderr)
            os.replace(tmp, out)        # atomic: concurrent builders agree
        build_info[name] = {"seconds": seconds,
                            "ptxas": log.read_text() if log.exists() else ""}
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib
