"""Guards of the port's boundaries.

* No file of ``src/repro_torch`` and not ``chip_smoke.py`` imports ``jax``
  or ``repro``: the port runs on a GPU host without JAX.
* Every entry point runs on the GPU unless the caller passes
  ``device="cpu"``; without a GPU the default raises.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import H100ModelPlatform, fe, get_case
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul import matmul
from repro_torch.models import get_model
from repro_torch.models.lm import LM
from repro_torch.serve import BatchedServer, generate

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_every_port_module():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("chip_smoke.py", "src/repro_torch/serve/decode.py",
                 "src/repro_torch/kernels/flash_attention.py",
                 "src/repro_torch/models/lm.py",
                 "src/repro_torch/kernels/matmul.py",
                 "src/repro_torch/kernels/suites/polybench.py",
                 "src/repro_torch/kernels/suites/hpc.py",
                 "src/repro_torch/hw.py"):
        assert must in names
    for mod in ("kernelcase", "datagen", "fe", "measure", "evalcache",
                "profiler", "mep", "aer", "diagnosis", "patterns",
                "proposer", "optimizer", "workers", "campaign",
                "integrate"):
        assert f"src/repro_torch/core/{mod}.py" in names


CFG = dataclasses.replace(get_config("glm4-9b").reduced(),
                          param_dtype="float32")


def _cpu_model():
    m = get_model(CFG, device="cpu")
    m.init_params(torch.Generator().manual_seed(0))
    return m


ENTRY_POINTS = {
    "resolve_device": lambda **kw: resolve_device(**kw),
    "get_model": lambda **kw: get_model(CFG, **kw),
    "LM": lambda **kw: LM(CFG, **kw),
    "generate": lambda **kw: generate(_cpu_model(),
                                      np.zeros((1, 4), np.int32),
                                      max_new=2, **kw),
    "BatchedServer": lambda **kw: BatchedServer(_cpu_model(), slots=1,
                                                max_len=16, **kw),
    "flash_attention": lambda **kw: flash_attention(
        torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 1, 16),
        torch.zeros(1, 8, 1, 16), **kw),
    "matmul": lambda **kw: matmul(torch.zeros(8, 16), torch.zeros(16, 8),
                                  **kw),
    "H100ModelPlatform": lambda **kw: H100ModelPlatform(**kw),
    "fe.check": lambda **kw: fe.check(
        get_case("gemm"), get_case("gemm").baseline_variant, 16,
        n_input_sets=1, **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_raises_without_gpu_unless_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()                                   # the default is the GPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(device="cuda")
    call(device="cpu")                           # explicit CPU runs


def test_a_cuda_request_never_runs_cpu_data(monkeypatch):
    """Even with a GPU present, asking for CUDA with data on the CPU raises
    instead of quietly computing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="lies on cpu"):
        ENTRY_POINTS["flash_attention"](device="cuda")
    with pytest.raises(ValueError, match="lies on cpu"):
        ENTRY_POINTS["matmul"](device="cuda")
    with pytest.raises(ValueError, match="model lives on cpu"):
        ENTRY_POINTS["BatchedServer"](device="cuda")
    with pytest.raises(ValueError, match="model lives on cpu"):
        ENTRY_POINTS["generate"](device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
