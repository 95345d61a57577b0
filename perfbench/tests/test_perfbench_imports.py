"""No run loads JAX or the JAX package; the reference imports nothing of
the program."""
import ast
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

import common  # noqa: E402


def _imports(path: Path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_names_are_compared_whole():
    assert common.forbidden_loaded(["repro_torch", "repro_torch.models",
                                    "reproducible", "jaxtyping"]) == []
    assert common.forbidden_loaded(["repro.core", "jax.numpy", "jaxlib",
                                    "flax.linen", "torch"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & set(common.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert "repro_torch" not in _imports(path), path


def test_a_run_of_the_harness_modules_loads_no_forbidden_module():
    import subprocess
    code = ("import sys; sys.path[:0] = [{src!r}, {pb!r}]; import run, common, "
            "workload, drivers.serve, drivers.train, calibrate; "
            "import repro_torch.serve.decode, repro_torch.train, "
            "repro_torch.data, repro_torch.kernels.flash_attention; "
            "print(common.forbidden_loaded())").format(
                src=str(HERE.parent / "src"), pb=str(HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]"
