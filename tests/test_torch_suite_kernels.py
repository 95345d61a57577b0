"""K3 (reduction), K4 (map) and K5 (grouped GEMM) of the port against the
JAX package, on the CPU.

* the plain versions, which the wrappers run on CPU tensors, against the
  Pallas ``reduce_sum_pallas``, ``elementwise_pallas`` and
  ``grouped_matmul`` in interpret mode, at ``tests/test_kernels.py:116-158``'s
  sizes and dtypes, plus fitted blocks;
* K5 (and automatic error repair through it) refusing a tile above the
  shared memory of a block by name, and the shared-memory estimate
  fitting the tile to the case's (M, N, K) as K5's wrapper does.

Inputs come from ``datagen.generate`` with a seed and go to both packages.
The kernels themselves are held against their plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm import grouped_matmul as jax_grouped_matmul
from repro.kernels.ref import grouped_matmul_ref as jax_grouped_matmul_ref
from repro.kernels.suites.pallas_lib import (elementwise_pallas,
                                             reduce_sum_pallas)
from repro_torch.core import (AER, DirectProposer, Evaluator,
                              H100ModelPlatform, MEPConstraints, OptConfig,
                              build_mep, datagen, get_case)
from repro_torch.core.kernelcase import ArraySpec
from repro_torch.core.profiler import SMEM_BYTES, variant_smem_bytes
from repro_torch.kernels.elementwise import elementwise, elementwise_plain
from repro_torch.kernels.moe_gemm import grouped_matmul
from repro_torch.kernels.ref import grouped_matmul_ref
from repro_torch.kernels.reduce_sum import reduce_sum, reduce_sum_plain

# test_kernels.py's kernel tolerances
TOL = {"float32": 2e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def arrays(*shapes, seed=0, dtype="float32"):
    """The same datagen arrays as jax arrays and as CPU tensors."""
    arrs = datagen.generate([ArraySpec(s) for s in shapes], seed)
    return ([jnp.asarray(a).astype(JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


# ------------------------------------------------------------------ K3 ----
@pytest.mark.parametrize("n,block", [
    (8192, 1024),          # test_kernels.py
    (8192, 16384),         # block above n: one block
    (6000, 1024),          # fitted to 1000
    (4099, 4096),          # prime: fitted to blocks of 1
])
def test_k3_plain_matches_pallas_interpret(n, block):
    """f32 sums of the same blocks in another order: test_kernels.py's
    rtol 1e-5, atol 1e-3 (a sum of n unit normals is ~sqrt(n))."""
    (jx,), (tx,) = arrays((n,), seed=n)
    want = reduce_sum_pallas(jx, block=block)
    before = reduce_sum.launches
    got = reduce_sum(tx, block=block, device="cpu")
    assert reduce_sum.launches == before          # CPU tensors launch nothing
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-3)


def test_k3_plain_matches_pallas_interpret_bf16():
    """bf16 input, f32 sums, the total rounded to bf16 on both sides: one
    bf16 ulp (2^-8 relative) apart where the f32 sums straddle a rounding
    boundary; tolerance 2^-7 relative."""
    (jx,), (tx,) = arrays((8192,), seed=3, dtype="bfloat16")
    want = float(np.asarray(reduce_sum_pallas(jx, block=1024), np.float32))
    got = reduce_sum(tx, block=1024, device="cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(float(got), want, rtol=2.0 ** -7, atol=1e-3)


def test_k3_plain_version_sums_the_fitted_blocks():
    x = torch.arange(12, dtype=torch.float32)
    assert float(reduce_sum_plain(x, block=5)) == 66.0     # blocks of 4
    with pytest.raises(ValueError, match="1-D"):
        reduce_sum(torch.zeros(2, 3), device="cpu")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        reduce_sum(torch.zeros(4, dtype=torch.float64), device="cpu")


# ------------------------------------------------------------------ K4 ----
def add(x, y):
    return x + y


def affine(x):
    return 2.0 * x + 1.0


def fma(x, y, z):
    return x * y + z


@pytest.mark.parametrize("fn,n_in,n,block", [
    (add, 2, 8192, 2048),            # test_kernels.py
    (add, 2, 6000, 4096),            # fitted to 3000: a masked tail
    (affine, 1, 4096, 1024),
    (fma, 3, 8192, 8192),
])
def test_k4_plain_matches_pallas_interpret(fn, n_in, n, block):
    """The same f32 arithmetic element by element: test_kernels.py's
    rtol 1e-6, atol 1e-6."""
    jx, tx = arrays(*[(n,)] * n_in, seed=n_in)
    want = elementwise_pallas(fn, *jx, block=block)
    before = elementwise.launches
    got = elementwise(fn, *tx, block=block, device="cpu")
    assert elementwise.launches == before
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_k4_output_takes_the_first_arrays_dtype():
    """As ``_map_kernel`` casts to ``o_ref.dtype``: bf16 first operand,
    f32 second, the sum in f32 rounded to bf16 on both sides."""
    x = torch.linspace(-2, 2, 256).to(torch.bfloat16)
    y = torch.linspace(0, 1, 256)
    want = elementwise_pallas(add, jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(y.numpy()), block=64)
    got = elementwise(add, x, y, block=64, device="cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_k4_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="one length"):
        elementwise(add, x, torch.zeros(9), device="cpu")
    with pytest.raises(ValueError, match="1 to 3 arrays"):
        elementwise(fma, x, x, x, x, device="cpu")
    assert torch.equal(elementwise_plain(affine, x), torch.ones(8))


# ------------------------------------------------------------------ K5 ----
@pytest.mark.parametrize("E,M,K,N,bm,bn,bk", [
    (4, 64, 32, 48, 32, 32, 16),
    (2, 128, 128, 128, 128, 64, 64),
    (8, 32, 16, 32, 64, 64, 64),       # blocks larger than dims → fitted
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_plain_matches_pallas_interpret(E, M, K, N, bm, bn, bk, dtype):
    """test_kernels.py's sweep and tolerance, TOL[dtype]·sqrt(K): f32 sums
    in another order, and in bf16 outputs rounded from f32 on both
    sides."""
    (jx, jw), (tx, tw) = arrays((E, M, K), (E, K, N), seed=M + K,
                                dtype=dtype)
    want = jax_grouped_matmul(jx, jw, block_m=bm, block_n=bn, block_k=bk)
    before = grouped_matmul.launches
    got = grouped_matmul(tx, tw, block_m=bm, block_n=bn, block_k=bk,
                         device="cpu")
    assert grouped_matmul.launches == before
    assert got.dtype == TDT[dtype] and got.shape == (E, M, N)
    tol = TOL[dtype] * K ** 0.5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    # the oracle too: the same f32 einsum, rounded alike
    np.testing.assert_allclose(
        grouped_matmul_ref(tx, tw).float().numpy(),
        np.asarray(jax_grouped_matmul_ref(jx, jw), np.float32),
        rtol=tol, atol=tol)


def test_k5_refuses_a_tile_above_the_shared_memory_of_a_block():
    """The same refusal on the CPU as on the card, with the bytes named
    (automatic error repair keys on it); bf16 halves the bytes."""
    x = torch.zeros(2, 512, 256)
    w = torch.zeros(2, 256, 512)
    with pytest.raises(RuntimeError,
                       match=r"grouped matmul tile 256x256x256 .* 262144 "
                             r"bytes of shared memory"):
        grouped_matmul(x, w, block_m=256, block_n=256, block_k=256,
                       device="cpu")
    got = grouped_matmul(x.bfloat16(), w.bfloat16(), block_m=256,
                         block_n=256, block_k=256, device="cpu")
    assert got.dtype == torch.bfloat16 and got.shape == (2, 512, 512)


def test_smem_estimate_fits_the_tile_to_the_moe_gemm():
    """moe_grouped_gemm's GEMM is M = scale, N 512, K 256: at scale 128 a
    256^3 f32 tile is fitted to 128 x 256 x 256 by K5's wrapper, 262,144
    bytes, where fitting all three to the scale would say 131,072."""
    case = get_case("moe_grouped_gemm")
    v = {"batched": False, "compute_dtype": "f32", "block_m": 256,
         "block_n": 256, "block_k": 256}
    assert case.tile_dims(128) == (128, 512, 256)
    assert variant_smem_bytes(v, 128, case) == 262_144 > SMEM_BYTES
    assert variant_smem_bytes(v, 128) == 131_072
    assert variant_smem_bytes(v, 64, case) == (64 + 128) * 256 * 4
    assert get_case("gemm").tile_dims(384) == (384, 384, 384)


def test_aer_repairs_an_oversized_k5_tile_by_halving_blocks():
    """K5's refusal reaches AER through the kernel check, which halves the
    largest block until the tile fits, at the case's own MEP scale."""
    case = get_case("moe_grouped_gemm")
    mep = build_mep(case, H100ModelPlatform(device="cpu"),
                    constraints=MEPConstraints(t_max_s=2.0, r=5, k=1),
                    scale=512)
    ev = Evaluator(mep, case, "h100-model", AER(case, 512), DirectProposer(),
                   OptConfig(check_kernel=True, fe_scale=128,
                             fe_input_sets=1, r=3, k=0))
    big = {"batched": True, "compute_dtype": "f32", "block_m": 256,
           "block_n": 256, "block_k": 256}
    cl = ev.evaluate(big)
    assert cl.status == "ok" and cl.repairs >= 1
    assert {r.rule for r in ev.aer.records} == {"smem_halve_largest_block"}
    assert "grouped matmul tile" in ev.aer.records[0].error
    assert variant_smem_bytes(cl.variant, 512, case) <= SMEM_BYTES
