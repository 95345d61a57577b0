"""K6's geometry, shared memory and packed launch on the CPU, and the
arithmetic of its split body against the JAX package.

The kernel (``csrc/rwkv_wkv.cu``) runs a grid over (head, batch, column
slice): VB value columns a block (``geometry``), G = K / 8 lanes a column,
each lane 8 state rows in two runs of 4, a stage of ``chunk`` steps at a
time.  Here: the slices cover V once, a block is whole warps, the grid
fills the card where V allows, every stage the wrapper accepts fits a
block, and an emulation of the lanes' arithmetic (the bonus folded into
each lane's partial sum, the partials added by the xor tree, the masked
last slice) matches the JAX oracle ``ref.wkv_ref`` and the Pallas kernel
in interpret mode, at 1e-4 (f32 on both sides, sums in another order), as
``tests/test_torch_recurrent_kernels.py`` holds the plain version.  The
kernel itself runs only on a card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv_wkv import wkv_pallas
from repro_torch import hw
from repro_torch.kernels import rwkv_wkv as k6
from repro_torch.kernels.rwkv_wkv import (HEAD_SIZES, MAX_THREADS, ROWS,
                                          TARGET_BLOCKS, geometry,
                                          smem_bytes, wkv)

SHAPES = [(BH, K, V) for BH in (1, 2, 16, 64, 128, 256, 1024)
          for K in HEAD_SIZES for V in (1, 7, 48, 64, 100, 1024)]


@pytest.mark.parametrize("BH,K,V", SHAPES)
def test_the_column_slices_cover_v_exactly_once(BH, K, V):
    _, VB, slices = geometry(BH, K, V)
    covered = [j for z in range(slices) for j in range(z * VB, (z + 1) * VB)
               if j < V]
    assert covered == list(range(V))
    assert (slices - 1) * VB < V                 # no slice lies past V


@pytest.mark.parametrize("BH,K,V", SHAPES)
def test_a_block_is_whole_warps_within_1024_threads(BH, K, V):
    G, VB, _ = geometry(BH, K, V)
    assert G * VB <= 1024 and G * VB <= MAX_THREADS
    assert G * VB % 32 == 0                      # full-mask shuffles
    assert VB % 8 == 0                           # a bf16 v row is 16 bytes


@pytest.mark.parametrize("K", HEAD_SIZES)
def test_each_column_takes_k_over_8_lanes(K):
    G, _, _ = geometry(64, K, 64)
    assert G == K // 8 and G * ROWS == K


@pytest.mark.parametrize("BH,blocks", [(16, 128), (64, 256), (256, 512)])
def test_the_grid_reaches_the_target_blocks_where_v_allows(BH, blocks):
    """At rwkv6-7b's K = V = 64: B·H = 64 (B=1) and 256 (B=4) give about
    two blocks an SM or more; the Table 4 case's B·H = 16 takes the
    narrowest slice, 8 columns, as many blocks as V allows."""
    G, VB, slices = geometry(BH, 64, 64)
    assert BH * slices == blocks
    unit = max(32 // G, 8)
    assert BH * slices >= 0.9 * TARGET_BLOCKS or VB == unit
    assert TARGET_BLOCKS == 2 * hw.SMS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [16, 32, 64, 128])
@pytest.mark.parametrize("K", HEAD_SIZES)
@pytest.mark.parametrize("B", [1, 4])
def test_the_stage_fits_a_block_wherever_the_wrapper_accepts(B, K, chunk,
                                                             dtype):
    """The kernel stages one chunk at a time; the refusal is by its
    bytes."""
    r = torch.zeros(B, 256, 64, K, dtype=dtype)
    v = torch.zeros(B, 256, 64, 64, dtype=dtype)
    lw = torch.zeros(B, 256, 64, K)
    u = torch.zeros(64, K, dtype=dtype)
    _, S, H, K_, V, c, VB = k6._check(r, r, v, lw, u, chunk)
    assert (S, H, K_, V, c) == (256, 64, K, 64, chunk)
    assert smem_bytes(c, K, VB, dtype.itemsize) <= hw.SMEM_PER_BLOCK \
        == 232_448


def test_the_served_chunks_stage_sizes():
    """rwkv6-7b's chunk 128 at K = V = 64, bf16, VB 16: the stage takes
    69,632 bytes, so three blocks share an SM's 228 KB; the stage grows
    linearly in the chunk (half at chunk 64)."""
    _, VB, _ = geometry(64, 64, 64)
    assert VB == 16
    assert smem_bytes(128, 64, VB, 2) == 69_632
    assert 3 * smem_bytes(128, 64, VB, 2) <= 228 * 1024
    assert 2 * smem_bytes(64, 64, VB, 2) == smem_bytes(128, 64, VB, 2)


def test_the_refusal_names_the_bytes():
    """A stage past a block's shared memory raises before launch, on the
    CPU too, naming its bytes."""
    r = torch.zeros(1, 300, 1, 128)
    v = torch.zeros(1, 300, 1, 128)
    u = torch.zeros(1, 128)
    _, VB, _ = geometry(1, 128, 128)
    need = smem_bytes(300, 128, VB, 4)
    assert need > hw.SMEM_PER_BLOCK
    with pytest.raises(RuntimeError, match=f"{need} bytes of shared memory"):
        wkv(r, r, v, r, u, chunk=300, device="cpu")
    wkv(r, r, v, r, u, chunk=128, device="cpu")   # 128 fits


def test_the_packed_arguments_match_the_c_struct():
    """``static_assert(sizeof(Args) == 29 * 8)`` in csrc/rwkv_wkv.cu:
    eight pointers (the stream last) and 21 signed fields, no ring depth
    among them."""
    assert len(k6._ENTRY.pack(*[0] * 29)) == 29 * 8
    k6._ENTRY.pack(*[2 ** 64 - 1] * 8, *[-1] * 21)
    with pytest.raises(Exception):
        k6._ENTRY.pack(-1, *[0] * 28)
    with pytest.raises(Exception):
        k6._ENTRY.pack(*[0] * 30)


def test_cpu_calls_launch_nothing():
    r = torch.zeros(1, 4, 2, 16)
    before = wkv.launches
    o, s = wkv(r, r, r, r, torch.zeros(2, 16), device="cpu")
    assert wkv.launches == before and o.shape == (1, 4, 2, 16)


def lane_rows(K: int, G: int):
    """``row_of`` in csrc/rwkv_wkv.cu: lane l holds two runs of 4 rows,
    4l..4l+3 and K/2 + 4l..K/2 + 4l + 3; ``[G, 8]``."""
    return torch.tensor([[c * (K // 2) + lane * 4 + i for c in range(2)
                          for i in range(4)] for lane in range(G)])


def test_the_lanes_of_a_column_hold_every_row_once():
    for K in HEAD_SIZES:
        rows = lane_rows(K, K // ROWS)
        assert sorted(rows.flatten().tolist()) == list(range(K))


def split_emulation(r, k, v, lw, u):
    """The kernel's arithmetic in f32, slice by slice: lane l of a column
    holds the state rows ``lane_rows`` gives it and forms sum_c r (s + u k
    v_j) over them; the G partials are added by the xor tree (off G/2 ..
    1) and lane 0's sum is o; s = exp(lw) s + k v_j.  Columns past V in the
    last slice compute on NaN and are never stored."""
    B, S, H, K = r.shape
    V = v.shape[3]
    G, VB, slices = geometry(B * H, K, V)
    rows = lane_rows(K, G)
    o = torch.full((B, S, H, V), float("nan"))
    state = torch.full((B, H, K, V), float("nan"))
    lanes = torch.arange(G)
    for z in range(slices):
        cols = torch.arange(z * VB, (z + 1) * VB)
        live = cols < V
        vz = torch.full((B, S, H, VB), float("nan"))
        vz[..., live] = v[..., cols[live]]
        s = torch.zeros(B, H, K, VB)
        for t in range(S):
            kv = k[:, t, :, :, None] * vz[:, t, :, None, :]    # [B,H,K,VB]
            terms = r[:, t, :, :, None] * (u[None, :, :, None] * kv + s)
            p = terms[:, :, rows].sum(dim=3)                   # [B,H,G,VB]
            off = G // 2
            while off:
                p = p + p[:, :, lanes ^ off]
                off //= 2
            o[:, t, :, cols[live]] = p[:, :, 0, live]
            s = torch.exp(lw[:, t, :, :, None]) * s + kv
        state[..., cols[live]] = s[..., live]
    return o, state


def numpy_inputs(B, S, H, K, V, seed):
    rng = np.random.default_rng(seed)
    r, k = (0.5 * rng.standard_normal((B, S, H, K)) for _ in range(2))
    v = 0.5 * rng.standard_normal((B, S, H, V))
    lw = -np.abs(rng.standard_normal((B, S, H, K))) - 0.01
    u = 0.5 * rng.standard_normal((H, K))
    return [a.astype(np.float32) for a in (r, k, v, lw, u)]


@pytest.mark.parametrize("B,S,H,K", [
    (1, 24, 2, 16),              # one slice, G = 2
    (2, 17, 3, 32),              # four slices of 8
    (1, 12, 2, 64),              # rwkv6-7b's head, G = 8
    (1, 6, 128, 64),             # slices of 24: the last masked to 16
    (1, 9, 1, 128),              # the widest head, G = 16
])
def test_the_lane_split_matches_the_jax_oracle(B, S, H, K):
    """The JAX oracle and kernel take V = K (the state is [K, K])."""
    arrays = numpy_inputs(B, S, H, K, K, seed=S * K)
    got_o, got_s = split_emulation(*map(torch.from_numpy, arrays))
    want_o, want_s = jref.wkv_ref(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-4, atol=1e-4)
    pallas_o = wkv_pallas(*map(jnp.asarray, arrays), chunk=4)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(pallas_o),
                               rtol=1e-3, atol=1e-3)
