"""K5's two bodies, on the CPU: which one a launch takes, and the shared
memory of its tiles.

* ``moe_gemm.path_for``, the rule that sends a launch to the tensor cores
  ("mma", K1's tile in ``csrc/mma_tile.cuh``) or to the CUDA cores
  ("simt"), on every tile the ``moe_grouped_gemm`` campaigns give K5 at
  each of the case's scales, on the tiles automatic error repair shrinks
  to, and on operands off 16 bytes: an expert stride, a base address, an
  operand strided on both dimensions;
* the shared memory each campaign tile asks for, unchanged by the
  tensor-core body, and the refusal by name of the 256^3 f32 tile;
* CPU calls, which count no launch on either body.

Three TF32 passes against K1's gate, expert by expert on the case's own
inputs, are the ``grouped`` case of
``tests/test_torch_matmul_mma.py::test_three_tf32_passes_stay_far_inside_the_gate``.
The kernel itself runs only on a card: ``tests/test_torch_cuda.py`` holds
both bodies against the plain version there.
"""
import itertools

import pytest
import torch

from repro_torch.core import get_case
from repro_torch.core.profiler import variant_smem_bytes
from repro_torch.kernels.matmul import fit, smem_bytes
from repro_torch.kernels.moe_gemm import grouped_matmul, path_for

F32, BF16 = torch.float32, torch.bfloat16
E, K, N = 8, 256, 512                  # moe_grouped_gemm's experts, K, N
CASE = get_case("moe_grouped_gemm")
BLOCKS = CASE.variant_space["block_m"]


def rule(x, w, tile):
    return path_for(x.dtype, *tile, x.stride(), w.stride(),
                    (x.data_ptr(), w.data_ptr()))


def test_the_campaign_blocks_are_32_to_256():
    assert BLOCKS == CASE.variant_space["block_n"] \
        == CASE.variant_space["block_k"] == [32, 64, 128, 256]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("M", CASE.scales)
def test_campaign_tiles_take_the_tensor_cores(dtype, M):
    """Every (block_m, block_n, block_k) of the variant space, fitted to
    the case's x [8, M, 256] and w [8, 256, 512] as the wrapper fits it,
    on contiguous operands."""
    x = torch.empty(E, M, K, dtype=dtype)
    w = torch.empty(E, K, N, dtype=dtype)
    for bm, bn, bk in itertools.product(BLOCKS, repeat=3):
        tile = (fit(bm, M), fit(bn, N), fit(bk, K))
        assert rule(x, w, tile) == "mma", tile


@pytest.mark.parametrize("tile", [(8, 16, 16), (16, 8, 16), (16, 16, 8),
                                  (8, 8, 8), (24, 32, 32), (32, 24, 32)])
def test_repaired_tiles_below_16_take_the_cuda_cores(tile):
    """Automatic error repair halves a tile to 16 and 8; a block of 32
    fitted to a dimension of 48 is 24."""
    x = torch.empty(E, 48, K)
    w = torch.empty(E, K, 48)
    assert rule(x, w, tile) == "simt"


def test_16_is_the_smallest_tensor_core_tile():
    for dtype in (F32, BF16):
        x = torch.empty(E, 64, K, dtype=dtype)
        w = torch.empty(E, K, N, dtype=dtype)
        assert rule(x, w, (16, 16, 16)) == "mma"


@pytest.mark.parametrize("dtype,extra,path", [
    (F32, 1, "simt"),      # 4 bytes past a multiple of 16
    (F32, 2, "simt"),
    (F32, 4, "mma"),       # 16 bytes: every expert aligned
    (BF16, 4, "simt"),     # 8 bytes
    (BF16, 8, "mma"),
])
def test_an_expert_stride_off_16_bytes_takes_the_cuda_cores(dtype, extra,
                                                           path):
    """x's experts lie ``extra`` elements apart beyond M*K: the first
    expert's operand is aligned, the second's only when the expert stride
    is a multiple of 16 bytes.  The same for w."""
    M = 128
    x_buf = torch.empty(E * (M * K + extra), dtype=dtype)
    x = x_buf.as_strided((E, M, K), (M * K + extra, K, 1))
    w = torch.empty(E, K, N, dtype=dtype)
    assert rule(x, w, (128, 128, 128)) == path
    w_buf = torch.empty(E * (K * N + extra), dtype=dtype)
    w2 = w_buf.as_strided((E, K, N), (K * N + extra, N, 1))
    x2 = torch.empty(E, M, K, dtype=dtype)
    assert rule(x2, w2, (128, 128, 128)) == path


def test_a_view_off_16_bytes_takes_the_cuda_cores():
    """``big[:, :, 1:]``: the base 4 bytes past a 16-byte boundary and rows
    of K + 1 floats."""
    big = torch.empty(E, 128, K + 1)
    x = big[:, :, 1:]
    w = torch.empty(E, K, N)
    assert x.data_ptr() % 16 == 4
    assert rule(x, w, (128, 128, 128)) == "simt"
    assert rule(x.contiguous(), w, (128, 128, 128)) == "mma"


def test_a_base_address_off_16_bytes_takes_the_cuda_cores():
    """Contiguous strides, but the tensor starts one float into its
    buffer."""
    x = torch.empty(E * 128 * K + 1)[1:].view(E, 128, K)
    w = torch.empty(E, K, N)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    assert rule(x, w, (128, 128, 128)) == "simt"
    assert path_for(F32, 128, 128, 128, x.stride(), w.stride()) == "mma"


def test_an_operand_strided_on_both_dimensions_takes_the_cuda_cores():
    x = torch.empty(E, 256, 2 * K)[:, ::2, ::2]
    w = torch.empty(E, K, N)
    assert rule(x, w, (128, 128, 128)) == "simt"
    wt = torch.empty(E, 2 * K, 2 * N)[:, ::2, ::2]
    assert rule(torch.empty(E, 128, K), wt, (128, 128, 128)) == "simt"


def test_transposed_experts_keep_the_tensor_cores():
    """x stored [E, K, M] and w stored [E, N, K] (each expert's operand
    transposed, as K1's syrk passes A^T): contiguous along one dimension
    with 16-byte rows, so "mma", in the other operand layout."""
    x = torch.empty(E, K, 128).transpose(1, 2)
    w = torch.empty(E, N, K).transpose(1, 2)
    assert rule(x, w, (128, 128, 128)) == "mma"


@pytest.mark.parametrize("M,dtype,tile,nbytes", [
    (512, F32, (32, 32, 32), 8192),          # the case's baseline tile
    (512, F32, (128, 128, 128), 131072),     # K5's main shape
    (512, BF16, (128, 128, 128), 65536),
    (512, F32, (256, 128, 64), 65536),
    (512, BF16, (256, 256, 256), 131072),
    (64, F32, (256, 256, 128), 98304),       # fitted to 64 x 256 x 128
])
def test_shared_memory_of_the_campaign_tiles_is_unchanged(M, dtype, tile,
                                                          nbytes):
    bm, bn, bk = fit(tile[0], M), fit(tile[1], N), fit(tile[2], K)
    item = torch.empty((), dtype=dtype).element_size()
    assert smem_bytes(bm, bn, bk, item) == nbytes
    variant = {"block_m": tile[0], "block_n": tile[1], "block_k": tile[2],
               "compute_dtype": "bf16" if dtype == BF16 else "f32"}
    assert variant_smem_bytes(variant, M, CASE) == nbytes


def test_the_256_cubed_f32_tile_is_still_refused_by_name():
    x = torch.zeros(2, 512, K)
    w = torch.zeros(2, K, N)
    before = dict(grouped_matmul.launches_by_path)
    with pytest.raises(RuntimeError, match="262144 bytes of shared memory"):
        grouped_matmul(x, w, block_m=256, block_n=256, block_k=256,
                       device="cpu")
    assert grouped_matmul.launches_by_path == before
    # bf16 halves it
    got = grouped_matmul(x.bfloat16(), w.bfloat16(), block_m=256,
                         block_n=256, block_k=256, device="cpu")
    assert got.shape == (2, 512, N)


def test_cpu_calls_count_no_launch_on_either_path():
    x = torch.randn(2, 64, 32)
    w = torch.randn(2, 32, 48)
    before = (grouped_matmul.launches, dict(grouped_matmul.launches_by_path))
    grouped_matmul(x, w, block_m=32, block_n=32, block_k=32, device="cpu")
    grouped_matmul(x, w, block_m=8, block_n=8, block_k=8, device="cpu")
    assert (grouped_matmul.launches, grouped_matmul.launches_by_path) \
        == before
    assert set(grouped_matmul.launches_by_path) == {"mma", "simt"}
