"""The ``one_pass`` builds of ``dwthaar1d`` and ``fastwalshtransform``
against the JAX package, on the CPU.

In the JAX package ``one_pass`` is one ``jax.jit`` over every level or
stage, and the baseline one jitted call per level.  In the port ``one_pass``
is ``appsdk.OnePass``: one CUDA graph replay on the card, the eager chain on
the CPU, so here both builds must equal the JAX ``jnp`` builds, and the
baselines must stay plain functions.  The graph itself is held against the
eager build on a card by ``tests/test_torch_cuda.py``.

Inputs come from ``datagen.generate`` with a seed and go to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernelcase import get_case as jax_case
from repro_torch.core import datagen, get_case
from repro_torch.core.fe import as_tensors, outputs_match, to_numpy
from repro_torch.kernels.suites.appsdk import OnePass

# f32 on both sides, the same arithmetic: the test_torch_suites.py
# tolerance, relative to the output's largest magnitude
F32_TOL = 1e-5

VARIANTS = [
    ("dwthaar1d", {"one_pass": True}),
    ("fastwalshtransform", {"reshape_butterfly": False, "one_pass": True}),
    ("fastwalshtransform", {"reshape_butterfly": True, "one_pass": True}),
]


@pytest.mark.parametrize("scale", [256, 16384])
@pytest.mark.parametrize("name,variant", VARIANTS)
def test_one_pass_builds_equal_the_jax_builds(name, variant, scale):
    case, jcase = get_case(name), jax_case(name)
    arrs = datagen.generate(case.input_specs(scale), 11)
    x = as_tensors(arrs, "cpu")
    fn = case.build(variant, impl="torch")
    assert isinstance(fn, OnePass)
    got = fn(*x)
    assert fn.graphs == {}                  # the CPU runs the chain eagerly
    want = np.asarray(jcase.build(variant, impl="jnp")(
        *[jnp.asarray(a) for a in arrs]), np.float64)
    err = np.abs(to_numpy(got) - want).max() / np.abs(want).max()
    assert err <= F32_TOL, err
    assert outputs_match(got, case.ref(*x)).ok
    # the cuda build is the same (no pallas branch in either package)
    assert isinstance(case.build(variant, impl="cuda"), OnePass)


@pytest.mark.parametrize("name", ["dwthaar1d", "fastwalshtransform"])
def test_baselines_stay_eager_level_by_level(name):
    case = get_case(name)
    fn = case.build(dict(case.baseline_variant), impl="torch")
    assert not isinstance(fn, OnePass) and callable(fn)
    x = torch.randn(1024, generator=torch.Generator().manual_seed(0))
    assert outputs_match(fn(x), case.ref(x)).ok
