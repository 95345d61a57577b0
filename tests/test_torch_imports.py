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
from repro_torch.data import SyntheticLMData, make_global_batch
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.elementwise import elementwise
from repro_torch.kernels.matmul import matmul
from repro_torch.kernels.moe_gemm import grouped_matmul
from repro_torch.kernels.reduce_sum import reduce_sum
from repro_torch.kernels.rwkv_wkv import wkv
from repro_torch.kernels.ssd_scan import ssd
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model
from repro_torch.models.lm import LM
from repro_torch.models.whisper import EncDecLM
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
                 "src/repro_torch/models/whisper.py",
                 "src/repro_torch/configs/whisper_medium.py",
                 "src/repro_torch/kernels/matmul.py",
                 "src/repro_torch/kernels/suites/polybench.py",
                 "src/repro_torch/kernels/suites/hpc.py",
                 "src/repro_torch/kernels/suites/appsdk.py",
                 "src/repro_torch/kernels/reduce_sum.py",
                 "src/repro_torch/kernels/elementwise.py",
                 "src/repro_torch/kernels/moe_gemm.py",
                 "src/repro_torch/kernels/rwkv_wkv.py",
                 "src/repro_torch/kernels/ssd_scan.py",
                 "src/repro_torch/models/ssm.py",
                 "src/repro_torch/configs/rwkv6_7b.py",
                 "src/repro_torch/configs/hymba_1_5b.py",
                 "src/repro_torch/hw.py",
                 "src/repro_torch/train/optim.py",
                 "src/repro_torch/train/steps.py",
                 "src/repro_torch/data/pipeline.py",
                 "src/repro_torch/checkpoint/store.py",
                 "src/repro_torch/runtime/ft.py",
                 "src/repro_torch/runtime/compress.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/kernels/no_backward.py"):
        assert must in names
    for mod in ("kernelcase", "datagen", "fe", "measure", "evalcache",
                "profiler", "mep", "aer", "diagnosis", "patterns",
                "proposer", "optimizer", "workers", "campaign",
                "integrate", "extraction"):
        assert f"src/repro_torch/core/{mod}.py" in names


CFG = dataclasses.replace(get_config("glm4-9b").reduced(),
                          param_dtype="float32")
RWKV = dataclasses.replace(get_config("rwkv6-7b").reduced(),
                           param_dtype="float32")
HYMBA = dataclasses.replace(get_config("hymba-1.5b").reduced(),
                            param_dtype="float32")
WHISPER = dataclasses.replace(get_config("whisper-medium").reduced(),
                              param_dtype="float32")


def _cpu_model(cfg=CFG):
    m = get_model(cfg, device="cpu")
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
    "wkv": lambda **kw: wkv(*([torch.zeros(1, 4, 2, 16)] * 4),
                            torch.zeros(2, 16), **kw),
    "ssd": lambda **kw: ssd(torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2),
                            torch.zeros(2), torch.zeros(1, 4, 3),
                            torch.zeros(1, 4, 3), **kw),
    "reduce_sum": lambda **kw: reduce_sum(torch.zeros(16), **kw),
    "elementwise": lambda **kw: elementwise(torch.add, torch.zeros(16),
                                            torch.zeros(16), **kw),
    "grouped_matmul": lambda **kw: grouped_matmul(torch.zeros(2, 8, 16),
                                                  torch.zeros(2, 16, 8),
                                                  **kw),
    "get_model(rwkv6)": lambda **kw: get_model(RWKV, **kw),
    "EncDecLM": lambda **kw: EncDecLM(WHISPER, **kw),
    "get_model(whisper)": lambda **kw: get_model(WHISPER, **kw),
    "generate(whisper)": lambda **kw: generate(
        _cpu_model(WHISPER), np.zeros((1, 4), np.int32), max_new=2,
        frames=np.zeros((1, 16, 64), np.float32), **kw),
    "BatchedServer(hymba)": lambda **kw: BatchedServer(
        _cpu_model(HYMBA), slots=1, max_len=16, **kw),
    "H100ModelPlatform": lambda **kw: H100ModelPlatform(**kw),
    "make_global_batch": lambda **kw: make_global_batch(
        SyntheticLMData(CFG, 8, 2), 0, **kw),
    "launch.train.build": lambda **kw: launch_train.build(
        "stablelm-3b", smoke=True, batch=2, seq=8, lr=1e-3, accum=1,
        compress=False, **kw),
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
    with pytest.raises(ValueError, match="lies on cpu"):
        ENTRY_POINTS["wkv"](device="cuda")
    with pytest.raises(ValueError, match="lies on cpu"):
        ENTRY_POINTS["ssd"](device="cuda")
    for name in ("reduce_sum", "elementwise", "grouped_matmul"):
        with pytest.raises(ValueError, match="lies on cpu"):
            ENTRY_POINTS[name](device="cuda")
    with pytest.raises(ValueError, match="model lives on cpu"):
        ENTRY_POINTS["BatchedServer"](device="cuda")
    with pytest.raises(ValueError, match="model lives on cpu"):
        ENTRY_POINTS["generate"](device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
