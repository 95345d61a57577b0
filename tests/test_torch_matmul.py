"""K1 and the PolyBench matmul family of the port against the JAX package.

* K1's plain version (``repro_torch.kernels.matmul``, what the wrapper runs
  on CPU tensors) against the JAX Pallas ``matmul_pallas`` in interpret
  mode, at ``tests/test_kernels.py:133-148``'s shapes and epilogues, plus a
  bf16 case and a ``_fit`` case;
* every ported case's ``torch`` and ``cuda`` builds (the latter through
  K1's plain version here) against the JAX ``jnp`` build and ``case.ref``
  on the baseline and two other variants.

Inputs come from ``datagen.generate`` with a seed and go to both packages.
The CUDA kernel itself is held against its plain version on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datagen as jdatagen
from repro.core.kernelcase import cases as jax_cases
from repro.core.kernelcase import get_case as jax_case
from repro.kernels.suites.pallas_lib import matmul_pallas
from repro_torch.core import datagen
from repro_torch.core.fe import as_tensors, outputs_match, to_numpy
from repro_torch.core.kernelcase import ArraySpec, cases, get_case
from repro_torch.kernels.matmul import fit, matmul, matmul_ref, smem_bytes

# f32 on both sides, summation order only: the test_kernels.py tolerance
F32_TOL = 1e-4


def operands(M, K, N, dtype="float32", seed=0):
    specs = [ArraySpec((M, K)), ArraySpec((K, N)), ArraySpec((M, N))]
    arrs = datagen.generate(specs, seed)
    jx = [jnp.asarray(a) for a in arrs]
    th = as_tensors(arrs, "cpu")
    if dtype == "bfloat16":
        jx[:2] = [x.astype(jnp.bfloat16) for x in jx[:2]]
        th[:2] = [t.to(torch.bfloat16) for t in th[:2]]
    return jx, th


@pytest.mark.parametrize("M,K,N,ep", [(64, 32, 48, "none"),
                                      (128, 128, 128, "alpha_beta"),
                                      (96, 64, 32, "relu")])
def test_k1_plain_matches_pallas_interpret(M, K, N, ep):
    (ja, jb, jc), (ta, tb, tc) = operands(M, K, N)
    kw = dict(block_m=32, block_n=32, block_k=32, epilogue=ep, alpha=1.5,
              beta=1.2)
    want = matmul_pallas(ja, jb, jc if ep == "alpha_beta" else None, **kw)
    before = matmul.launches
    got = matmul(ta, tb, tc if ep == "alpha_beta" else None, device="cpu",
                 **kw)
    assert matmul.launches == before          # CPU tensors launch nothing
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


def test_k1_plain_matches_pallas_interpret_bf16():
    """bf16 operands, f32 accumulation and C, output rounded to bf16 on
    both sides: they may differ by one bf16 ulp of the output (2^-8
    relative) where the f32 sums straddle a rounding boundary; tolerance
    2^-7 relative, plus 1e-4 for outputs near 0."""
    (ja, jb, jc), (ta, tb, tc) = operands(64, 128, 64, "bfloat16", seed=3)
    kw = dict(block_m=32, block_n=64, block_k=64, epilogue="alpha_beta",
              alpha=1.5, beta=1.2)
    want = np.asarray(matmul_pallas(ja, jb, jc, **kw), np.float32)
    got = matmul(ta, tb, tc, device="cpu", **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=1e-4)


def test_k1_fit_turns_256_into_192_at_384():
    assert fit(256, 384) == 192 and fit(128, 384) == 128
    (ja, jb, jc), (ta, tb, tc) = operands(384, 384, 384, seed=1)
    kw = dict(block_m=256, block_n=256, block_k=256, epilogue="alpha_beta",
              alpha=1.5, beta=1.2)
    # 192 x 192 x 192 f32: (128 + 128) * 192 * 4 bytes fit in a block
    assert smem_bytes(192, 192, 192, 4) == 196_608
    want = matmul_pallas(ja, jb, jc, **kw)
    got = matmul(ta, tb, tc, device="cpu", **kw)
    # K = 384 sums: f32 order noise grows with sqrt(K) (test_kernels.py)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL * 2, atol=F32_TOL * 2)


def test_k1_refuses_a_tile_above_the_shared_memory_of_a_block():
    """The same refusal on the CPU as on the card, with the bytes named
    (automatic error repair keys on it)."""
    a = torch.zeros(512, 512)
    with pytest.raises(RuntimeError, match=r"262144 bytes of shared memory"):
        matmul(a, a, block_m=256, block_n=256, block_k=256, device="cpu")
    # bf16 halves the bytes: the same tile fits
    ab = a.to(torch.bfloat16)
    assert matmul(ab, ab, block_m=256, block_n=256, block_k=256,
                  device="cpu").dtype == torch.bfloat16


def test_k1_plain_version_takes_transposed_views():
    (_, _, _), (ta, tb, _) = operands(64, 64, 64, seed=2)
    got = matmul(ta, ta.T, block_m=32, block_n=32, block_k=32, device="cpu")
    np.testing.assert_allclose(got.numpy(), (ta @ ta.T).numpy(),
                               rtol=F32_TOL, atol=F32_TOL)
    assert torch.equal(matmul_ref(ta, tb), (ta @ tb))


CASES = ["gemm", "2mm", "3mm", "syrk", "syr2k"]
VARIANTS = {
    "baseline": None,
    "fused-f32": {"block_m": 128, "block_n": 64, "block_k": 256,
                  "compute_dtype": "f32", "fuse_epilogue": True},
    "unfused-bf16": {"block_m": 256, "block_n": 128, "block_k": 64,
                     "compute_dtype": "bf16", "fuse_epilogue": False},
}
SCALE = 256


def _scaled_err(got, want):
    g, w = to_numpy(got), to_numpy(want)
    return float(np.abs(g - w).max() / np.abs(w).max())


@pytest.mark.parametrize("vname", sorted(VARIANTS))
@pytest.mark.parametrize("name", CASES)
def test_case_builds_match_jax_jnp_build_and_ref(name, vname):
    """Errors are relative to the output's largest magnitude.  f32 builds:
    1e-5 (summation order; seen ~1e-7).  bf16 builds round their operands
    and products to bf16 at the same points on both sides, but a sum can
    round either way: 2e-2, the FE bf16 tolerance.  Each build also passes
    FE against ``case.ref`` at the Evaluator's rtol scale."""
    case, jcase = get_case(name), jax_case(name)
    assert case.variant_space == jcase.variant_space
    assert case.baseline_variant == jcase.baseline_variant
    assert case.scales == jcase.scales
    variant = VARIANTS[vname] or dict(case.baseline_variant)
    for s in (256, 512):
        assert case.flops(s) == jcase.flops(s)
        assert case.generic_traffic(variant, s) == \
            jcase.generic_traffic(variant, s)
    specs = case.input_specs(SCALE)
    assert [dataclasses.astuple(a) for a in specs] == \
        [dataclasses.astuple(a) for a in jcase.input_specs(SCALE)]
    arrs = datagen.generate(specs, 7)
    want = np.asarray(jcase.build(variant, impl="jnp")(
        *[jnp.asarray(a) for a in arrs]), np.float32)
    x = as_tensors(arrs, "cpu")
    ref = case.ref(*x)
    np.testing.assert_allclose(to_numpy(ref, np.float32),
                               np.asarray(jcase.ref(*arrs), np.float32),
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())
    bf16 = variant["compute_dtype"] == "bf16"
    tol = 2e-2 if bf16 else 1e-5
    for impl in ("torch", "cuda"):
        got = case.build(variant, impl=impl)(*x)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _scaled_err(got, want) <= tol, (impl, _scaled_err(got, want))
        assert outputs_match(got, ref, 200.0 if bf16 else 1.0).ok


def test_unported_case_names_its_roadmap_item():
    """Every case is ported now: the registry holds exactly the JAX
    package's case names, suite by suite, and an unknown name is a
    KeyError."""
    for suite in ("polybench", "appsdk", "hpc"):
        assert [c.name for c in cases(suite)] == \
            sorted(c.name for c in jax_cases(suite))
    assert get_case("atax").suite == "polybench"
    with pytest.raises(KeyError, match="no_such_case"):
        get_case("no_such_case")


@pytest.mark.parametrize("kind", ["normal", "uniform", "positive", "int",
                                  "tokens", "sorted", "symmetric", "spd"])
def test_datagen_is_bit_identical(kind):
    dtype = "int32" if kind in ("int", "tokens") else "float32"
    specs = [ArraySpec((3, 5, 5), dtype, kind, minval=1.0, maxval=9.0),
             ArraySpec((2, 4, 4), dtype, kind, minval=-2.0, maxval=2.0)]
    for seed in (0, 11):
        mine = datagen.generate(specs, seed)
        ref = jdatagen.generate(specs, seed)
        for a, b in zip(mine, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
