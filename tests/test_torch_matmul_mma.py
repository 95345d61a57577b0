"""K1's two bodies, on the CPU: which one a launch takes, and why three TF32
passes are enough for an f32 product.

* ``matmul.path_for``, the rule that sends a launch to the tensor cores
  ("mma") or to the CUDA cores ("simt"), on every tile the pipeline's
  campaigns give K1, in both operand layouts, on the tiles automatic error
  repair shrinks to, and on misaligned operands;
* the shared memory each tile asks for, which the tensor-core ring keeps,
  and the refusal by name of a tile above what a block may use;
* a torch emulation of the f32 product as the kernel forms it
  (hi*hi + hi*lo + lo*hi of TF32 parts), held against K1's gate at
  K = 1024 on the pipeline's inputs, and the one-pass product, which the
  gate must catch.

The kernel itself runs only on a card: ``tests/test_torch_cuda.py`` holds
it against its plain version there.
"""
import pytest
import torch

from repro_torch.core import datagen, get_case
from repro_torch.core.fe import as_tensors
from repro_torch.core.kernelcase import ArraySpec
from repro_torch.kernels.matmul import fit, matmul, path_for, smem_bytes

F32, BF16 = torch.float32, torch.bfloat16


def strides(M, K, N, layout, dtype=F32):
    """A's (m, k) and B's (k, n) strides of contiguous operands, or of the
    transposed views that syrk/syr2k and the cuda tests pass."""
    a = torch.empty(M, K, dtype=dtype)
    b = torch.empty(K, N, dtype=dtype)
    if "A^T" in layout:
        a = torch.empty(K, M, dtype=dtype).T
    if "B^T" in layout:
        b = torch.empty(N, K, dtype=dtype).T
    return (*a.stride(), *b.stride())


# the fitted tiles the pipeline's campaigns give K1 (chip_smoke.py phases 5,
# 12 and 14): the baseline 32^3, the winners 128^3, 256x128x128 and 256^3 in
# bf16, and 256 fitted to 192 at 384
CAMPAIGN_TILES = [
    (1024, F32, (32, 32, 32)),
    (1024, F32, (128, 128, 128)),
    (1024, F32, (256, 128, 128)),
    (768, BF16, (256, 256, 256)),
    (384, F32, (256, 256, 256)),
]


@pytest.mark.parametrize("layout", ["AB", "A^TB", "AB^T", "A^TB^T"])
@pytest.mark.parametrize("S,dtype,tile", CAMPAIGN_TILES)
def test_campaign_tiles_take_the_tensor_cores(S, dtype, tile, layout):
    bm, bn, bk = (fit(t, S) for t in tile)
    assert path_for(dtype, bm, bn, bk, strides(S, S, S, layout, dtype)) \
        == "mma"


def test_fit_sends_256_at_384_to_a_192_tile():
    assert fit(256, 384) == 192 and 192 % 16 == 0


@pytest.mark.parametrize("tile", [(8, 16, 8), (16, 8, 16), (16, 16, 8)])
def test_repaired_tiles_below_16_take_the_cuda_cores(tile):
    assert path_for(F32, *tile, strides(512, 512, 512, "AB")) == "simt"


def test_16_is_the_smallest_tensor_core_tile():
    assert path_for(F32, 16, 16, 16, strides(512, 512, 512, "AB")) == "mma"
    assert path_for(BF16, 16, 16, 16, strides(512, 512, 512, "AB", BF16)) \
        == "mma"


def test_misaligned_operands_take_the_cuda_cores():
    base = torch.empty(130, 129)
    a = base[:128, 1:]             # 4 bytes past a 16-byte boundary
    b = torch.empty(128, 128)
    tile = (128, 128, 128)
    args = (*a.stride(), *b.stride())
    assert a.data_ptr() % 16 == 4
    assert path_for(F32, *tile, args, (a.data_ptr(), b.data_ptr())) \
        == "simt"
    # a leading stride of 129 floats is not a multiple of 16 bytes
    assert path_for(F32, *tile, args) == "simt"
    # the same tile on aligned, contiguous operands
    c = torch.empty(128, 128)
    assert path_for(F32, *tile, (*c.stride(), *b.stride()),
                    (c.data_ptr(), b.data_ptr())) == "mma"
    # a bf16 stride of 12 elements is 24 bytes
    assert path_for(BF16, *tile, (12, 1, 128, 1)) == "simt"


def test_an_operand_strided_on_both_dimensions_takes_the_cuda_cores():
    a = torch.empty(256, 256)[::2, ::2]
    b = torch.empty(128, 128)
    assert path_for(F32, 128, 128, 128, (*a.stride(), *b.stride())) \
        == "simt"


@pytest.mark.parametrize("S,dtype,tile,nbytes", [
    (1024, F32, (32, 32, 32), 8192),
    (1024, F32, (128, 128, 128), 131072),
    (1024, F32, (256, 128, 128), 131072),
    (768, BF16, (256, 256, 256), 131072),
    (384, F32, (256, 256, 256), 196608),
])
def test_shared_memory_of_the_campaign_tiles_is_unchanged(S, dtype, tile,
                                                          nbytes):
    bm, bn, bk = (fit(t, S) for t in tile)
    item = torch.empty((), dtype=dtype).element_size()
    assert smem_bytes(bm, bn, bk, item) == nbytes


def test_the_256_cubed_f32_tile_is_still_refused_by_name():
    assert smem_bytes(256, 256, 256, 4) == 262144
    a = torch.zeros(512, 512)
    before = dict(matmul.launches_by_path)
    with pytest.raises(RuntimeError, match="262144 bytes of shared memory"):
        matmul(a, a, block_m=256, block_n=256, block_k=256, device="cpu")
    assert matmul.launches_by_path == before


def test_cpu_calls_count_no_launch_on_either_path():
    a = torch.randn(64, 64)
    before = (matmul.launches, dict(matmul.launches_by_path))
    matmul(a, a, block_m=32, block_n=32, block_k=32, device="cpu")
    assert (matmul.launches, matmul.launches_by_path) == before
    assert set(matmul.launches_by_path) == {"mma", "simt"}


# ---- three TF32 passes against K1's gate -------------------------------------
def k1_tolerance(a, b, c, want, epilogue, alpha, beta):
    """K1's gate, as chip_smoke.py states it: 4 sqrt(K) 2^-24 M, where
    M = |alpha| (|A| @ |B|) + |beta| |C| (f32 rounding noise of a sum of K
    terms), plus two bf16 ulps for bf16 outputs."""
    K = a.shape[1]
    M = a.float().abs() @ b.float().abs()
    if epilogue == "alpha_beta":
        M = abs(alpha) * M + abs(beta) * c.float().abs()
    tol = 4 * K ** 0.5 * 2.0 ** -24 * M + 1e-6
    if a.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -6 * want.abs()
    return tol


def tf32(x):
    """x rounded to TF32 (10 fraction bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def tf32_pass_ratios(a, b, c, alpha, beta, epilogue):
    """(three passes, one pass): the largest error of alpha A B (+ beta C)
    with the product formed from TF32 parts, summed exactly (float64), as
    a ratio to K1's gate."""
    d = torch.float64
    exact = a.to(d) @ b.to(d)
    want = alpha * exact
    if epilogue == "alpha_beta":
        want = want + beta * c.to(d)
    tol = k1_tolerance(a, b, c, want.float(), epilogue, alpha, beta).to(d)
    (ah, al), (bh, bl) = split(a), split(b)
    three = ah.to(d) @ bh.to(d) + ah.to(d) @ bl.to(d) + al.to(d) @ bh.to(d)
    one = ah.to(d) @ bh.to(d)
    return ((alpha * (three - exact)).abs().div(tol).max().item(),
            (alpha * (one - exact)).abs().div(tol).max().item())


@pytest.mark.parametrize("kind,grouped", [("normal", False),
                                          ("uniform", False),
                                          ("normal", True)],
                         ids=["normal", "uniform", "grouped"])
def test_three_tf32_passes_stay_far_inside_the_gate(kind, grouped):
    """At K = 1024 on the pipeline's inputs (datagen, as gemm's MEP draws
    them), alpha A B + beta C with the product formed from TF32 parts,
    summed exactly (float64): three passes read under a tenth of the gate,
    one pass reads above it.  The exact sum isolates the split's error from
    the summation order, which the gate's own f32 noise covers.
    ``grouped``: K5's product, x [8, 64, 256] @ w [8, 256, 512] as
    moe_grouped_gemm's MEP draws them at its smallest scale, each expert
    against its own gate (no epilogue)."""
    if grouped:
        case = get_case("moe_grouped_gemm")
        x, w = as_tensors(datagen.generate(case.input_specs(64), 5), "cpu")
        calls = [(x[e], w[e], None, 1.0, 0.0, "none")
                 for e in range(x.shape[0])]
    else:
        M, K, N = 128, 1024, 128
        specs = [ArraySpec((M, K), kind=kind), ArraySpec((K, N), kind=kind),
                 ArraySpec((M, N), kind=kind)]
        a, b, c = as_tensors(datagen.generate(specs, 5), "cpu")
        calls = [(a, b, c, 1.5, 1.2, "alpha_beta")]
    for a, b, c, alpha, beta, epilogue in calls:
        ratio3, ratio1 = tf32_pass_ratios(a, b, c, alpha, beta, epilogue)
        assert ratio3 < 0.1, ratio3
        assert ratio1 > 1.0, ratio1


def test_the_tf32_rounding_matches_its_definition():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -1.0 - 2.0 ** -11, 3.0e-3])
    got = tf32(x)
    assert got[0] == 1.0
    assert got[1] == 1.0 + 2.0 ** -10        # a tie rounds away from zero
    assert got[2] == 1.0 + 2.0 ** -10
    assert got[3] == -1.0 - 2.0 ** -10
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    hi, lo = split(x)
    assert ((hi + lo - x).abs() <= 2.0 ** -22 * x.abs()).all()
