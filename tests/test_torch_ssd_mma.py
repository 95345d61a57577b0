"""K7's tensor-core body on the CPU: its grid, the rule that chooses it, its
shared memory and packed launch, and its arithmetic against the JAX
package.

The ``mma`` body (``csrc/ssd_scan.cu``) runs a grid over (head, batch,
slice of PB columns of P) (``geometry``); per chunk it forms C·Bᵀ, the
decay-weighted G' = (C·B) exp(la_t − la_s) dt_s, G'·xh, exp(la_t) C·Sᵀ and
the state update xhᵀ·(dt exp(la_end − la) B) on the tensor cores.  Here:

* the slices cover P once and fill the grid at hymba-1.5b's served B = 1;
* ``ssd_scan.path_for`` gives ``mma`` at hymba's, the ``mamba_ssd``
  case's and the reduced config's shapes and ``simt`` for an xh off 16
  bytes, a row stride off 16 bytes, or stages that do not fit a block;
* the ``mma`` stages fit a block at every chunk of the case space;
* the packed launch struct, and no launch counted on a CPU call;
* a torch emulation of the ``mma`` arithmetic (bf16: the raw operands
  exact, G', the state and the scaled B as bf16 hi + lo; f32: three TF32
  passes) against the JAX oracle ``ref.ssd_ref`` and the Pallas kernel in
  interpret mode, within 0.75 of the card test's gate (y: f32 rtol 1e-3,
  bf16 2^-6, atol 1e-3; state 1e-3), beside the one-pass control (G', the
  state and the scaled B in plain bf16, or one TF32 pass), which must read
  worse;
* the shape of the card's f32 control: three passes on xh, B and C
  rounded to TF32 read above the card test's f32 gate at hymba-1.5b's
  served heads (H 50, P 64, N 16, S 256, chunk 128) and at the
  ``mamba_ssd`` case's (B 2, S 1024, H 8).

The kernel itself runs only on a card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_pallas
from repro_torch import hw
from repro_torch.kernels import ssd_scan as k7
from repro_torch.kernels.ssd_scan import (MIN_BLOCKS, geometry,
                                          mma_smem_bytes, path_for, ssd,
                                          smem_bytes)

BF16, F32 = torch.bfloat16, torch.float32
# the card test's gate (tests/test_torch_cuda.py recurrence_tolerance):
# y as (rtol, atol) by dtype, the f32 state (1e-3, 1e-3)
Y_GATE = {F32: (1e-3, 1e-3), BF16: (2.0 ** -6, 1e-3)}
STATE_GATE = (1e-3, 1e-3)


# ---------------------------------------------------------------- grid ----
@pytest.mark.parametrize("B,H,P", [(B, H, P) for B in (1, 2, 4)
                                   for H in (1, 2, 8, 50)
                                   for P in (16, 32, 48, 64, 128)])
def test_the_slices_cover_p_exactly_once(B, H, P):
    PB, slices = geometry(B, H, P)
    assert PB in (16, 32) and PB * slices == P
    cols = sorted(z * PB + j for z in range(slices) for j in range(PB))
    assert cols == list(range(P))


def test_hymba_at_b1_fills_at_least_100_blocks():
    """hymba-1.5b (H 50, P 64) at its served B = 1: one block a head gave
    50 blocks; the slices give at least MIN_BLOCKS."""
    PB, slices = geometry(1, 50, 64)
    assert 50 * slices >= MIN_BLOCKS >= 100
    assert 50 * slices >= 2 * 50


def test_the_case_takes_the_narrowest_slice():
    """The ``mamba_ssd`` case (B 2, H 8, P 64): 16 heads, so the narrowest
    slice, 64 blocks where one block a head gave 16."""
    assert geometry(2, 8, 64) == (16, 4)


# ---------------------------------------------------------------- rule ----
def strides_of(B, S, H, P, dtype):
    return torch.empty(B, S, H, P, dtype=dtype).stride()[:3]


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_hymba_takes_the_tensor_cores(dtype):
    """The model's xh is a reshape of the conv output (contiguous); its B_t
    and C_t, two halves of one projection, are copied at the widest width
    their rows allow and do not enter the rule."""
    xi = torch.empty(1, 256, 50 * 64, dtype=dtype)
    xh = xi.reshape(1, 256, 50, 64)
    bc = torch.empty(1, 256, 32, dtype=dtype)
    B_t, C_t = torch.chunk(bc, 2, dim=-1)
    assert not B_t.is_contiguous() and C_t.stride(1) == 32
    assert path_for(dtype, 128, B_t.shape[2], xh.stride()[:3], 4096) == "mma"


@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
def test_the_case_takes_the_tensor_cores_at_every_chunk(chunk):
    for S in (256, 512, 1024, 2048):         # the case's scales
        assert path_for(F32, min(chunk, S), 16,
                        strides_of(2, S, 8, 64, F32)) == "mma"


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_the_reduced_config_takes_the_tensor_cores(dtype):
    """P 16, N 4: N is zero-padded to 16 in shared memory."""
    assert path_for(dtype, 32, 4, strides_of(2, 70, 8, 16, dtype)) == "mma"


def test_a_base_off_16_bytes_takes_the_cuda_cores():
    strides = strides_of(1, 64, 4, 64, BF16)
    assert path_for(BF16, 64, 16, strides, 16) == "mma"
    assert path_for(BF16, 64, 16, strides, 18) == "simt"
    assert path_for(F32, 64, 16, strides_of(1, 64, 4, 64, F32), 8) == "simt"


def test_a_row_stride_off_16_bytes_takes_the_cuda_cores():
    xh = torch.empty(1, 64, 4, 65, dtype=BF16)[..., :64]     # 130-byte rows
    assert xh.stride(-1) == 1 and xh.stride(2) * 2 % 16
    assert path_for(BF16, 64, 16, xh.stride()[:3]) == "simt"
    xh = torch.empty(1, 64, 4, 72, dtype=BF16)[..., :64]     # 144-byte rows
    assert path_for(BF16, 64, 16, xh.stride()[:3]) == "mma"


def test_stages_past_a_block_take_the_cuda_cores_and_still_run():
    """N 128 at chunk 128 (f32): the ``mma`` stages need more than a block
    has, the ``simt`` body fits, so the wrapper still accepts the shape."""
    assert mma_smem_bytes(128, 32, 128, 4) > hw.SMEM_PER_BLOCK
    assert smem_bytes(128, 16, 128) <= hw.SMEM_PER_BLOCK
    assert path_for(F32, 128, 128, strides_of(1, 128, 2, 16, F32)) == "simt"
    xh = torch.zeros(1, 128, 2, 16)
    y, s = ssd(xh, torch.zeros(1, 128, 2), torch.zeros(2),
               torch.zeros(1, 128, 128), torch.zeros(1, 128, 128),
               chunk=128, device="cpu")
    assert y.shape == xh.shape and s.shape == (1, 2, 16, 128)


# --------------------------------------------------------------- smem -----
@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("PB", [16, 32])
def test_the_stages_fit_a_block_at_every_chunk_of_the_case(chunk, dtype,
                                                            PB):
    for N in (4, 16):                           # the reduced config, served
        assert mma_smem_bytes(chunk, PB, N, dtype.itemsize) \
            <= hw.SMEM_PER_BLOCK == 232_448


def test_the_served_chunks_shared_memory():
    """hymba's chunk 128, N 16, bf16: 45,056 bytes at slices of 16 and
    58,880 at 32, so three or more blocks fit an SM's 228 KB; the f32 case
    at its largest chunk 256 and slices of 32: 165,888."""
    assert mma_smem_bytes(128, 16, 16, 2) == 45_056
    assert mma_smem_bytes(128, 32, 16, 2) == 58_880
    assert 3 * mma_smem_bytes(128, 32, 16, 2) <= 228 * 1024
    assert mma_smem_bytes(256, 32, 16, 4) == 165_888


def test_the_refusal_names_the_bytes():
    """A chunk past a block's shared memory raises before launch, on the
    CPU too, naming the bytes; no shape the wrapper took before is
    refused now (the refusal is the ``simt`` body's, as it was)."""
    need = smem_bytes(512, 64, 16)
    assert need > hw.SMEM_PER_BLOCK
    x = torch.zeros(1, 512, 1, 64)
    with pytest.raises(RuntimeError, match=f"{need} bytes of shared memory"):
        ssd(x, torch.zeros(1, 512, 1), torch.zeros(1),
            torch.zeros(1, 512, 16), torch.zeros(1, 512, 16), chunk=512,
            device="cpu")


# ------------------------------------------------------------- launch -----
def test_the_packed_arguments_match_the_c_struct():
    """``static_assert(sizeof(Args) == 27 * 8)`` in csrc/ssd_scan.cu: eight
    pointers (the stream last) and 19 signed fields."""
    assert len(k7._ENTRY.pack(*[0] * 27)) == 27 * 8
    k7._ENTRY.pack(*[2 ** 64 - 1] * 8, *[-1] * 19)
    with pytest.raises(Exception):
        k7._ENTRY.pack(-1, *[0] * 26)
    with pytest.raises(Exception):
        k7._ENTRY.pack(*[0] * 28)


def test_cpu_calls_count_no_launch_on_either_body():
    before = (ssd.launches, dict(ssd.launches_by_path))
    y, s = ssd(torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2), torch.zeros(2),
               torch.zeros(1, 8, 4), torch.zeros(1, 8, 4), device="cpu")
    assert y.shape == (1, 8, 2, 16) and s.shape == (1, 2, 16, 4)
    assert (ssd.launches, ssd.launches_by_path) == before


# ---------------------------------------------------------- arithmetic ----
def tf32(x):
    """x rounded to TF32 (10 fraction bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds."""
    return ((x.contiguous().view(torch.int32) + 0x1000)
            & ~0x1FFF).view(torch.float32)


def product(a, b, dtype, split, hi_lo=True):
    """a @ b as the ``mma`` body forms it.  f32: three TF32 passes, lo·hi +
    hi·lo + hi·hi (one pass: hi·hi).  bf16: the side named by ``split``
    ("a", "b" or None) is an f32 value and goes in as bf16 hi + lo (one
    pass: hi); the other side is a raw bf16 operand, exact."""
    if dtype == F32:
        ah, bh = tf32(a), tf32(b)
        if not hi_lo:
            return ah @ bh
        return tf32(a - ah) @ bh + ah @ tf32(b - bh) + ah @ bh
    if split is None:
        return a @ b
    x = a if split == "a" else b
    hi = x.to(BF16).float()
    parts = [hi, (x - hi).to(BF16).float()] if hi_lo else [hi]
    return sum(p @ b if split == "a" else a @ p for p in parts)


def emulate_mma(xh, dt, a_log, B_t, C_t, chunk, hi_lo=True):
    """The ``mma`` body's arithmetic on xh [B,S,H,P], dt [B,S,H], a_log
    [H], B_t/C_t [B,S,N] (xh, B_t, C_t in their working dtype), chunk by
    chunk with the last one masked: la the cumsum of −exp(a_log) dt;
    y = exp(la_t) C·Sᵀ + G'·xh with G' = (C·Bᵀ) exp(la_t − la_s) dt_s below
    the diagonal; S ← exp(la_end) S + xhᵀ·(dt exp(la_end − la) B).  y in
    xh's dtype, the state in f32."""
    dtype = xh.dtype
    Bb, S, H, P = xh.shape
    N = B_t.shape[2]
    c = min(chunk, S)
    neg_a = -torch.exp(a_log.float())
    X = xh.float().permute(0, 2, 1, 3)                      # B H S P
    D = dt.float().permute(0, 2, 1)                         # B H S
    Bm, Cm = B_t.float()[:, None], C_t.float()[:, None]     # B 1 S N
    y = torch.empty(Bb, H, S, P)
    state = torch.zeros(Bb, H, P, N)
    for t0 in range(0, S, c):
        n = min(c, S - t0)
        x, d = X[:, :, t0:t0 + n], D[:, :, t0:t0 + n]
        b, cc = Bm[:, :, t0:t0 + n], Cm[:, :, t0:t0 + n]
        la = torch.cumsum(neg_a[None, :, None] * d, dim=-1)
        ela = torch.exp(la)
        dend = d * torch.exp(la[..., -1:] - la)
        score = product(cc, b.transpose(-1, -2), dtype, None, hi_lo)
        decay = (torch.exp(la[..., :, None] - la[..., None, :])
                 * d[..., None, :])
        keep = torch.ones(n, n, dtype=torch.bool).tril()
        G = torch.where(keep, score * decay, torch.zeros(()))
        intra = product(G, x, dtype, "a", hi_lo)
        cross = product(cc, state.transpose(-1, -2), dtype, "b", hi_lo)
        y[:, :, t0:t0 + n] = cross * ela[..., None] + intra
        state = torch.exp(la[..., -1])[..., None, None] * state + product(
            x.transpose(-1, -2), dend[..., None] * b, dtype, "b", hi_lo)
    return y.permute(0, 2, 1, 3).to(dtype), state


def gate_ratio(got, want, gate):
    """The largest |got - want| / (atol + rtol |want|): within the gate
    when at most 1."""
    rtol, atol = gate
    got, want = got.float(), want.float()
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def seeded_inputs(B, S, H, P, N, seed):
    """The card test's distributions, made with numpy."""
    rng = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        rng.standard_normal((B, S, H, P)),
        rng.random((B, S, H)) * 0.1 + 0.001,
        rng.random(H) * 2 - 1,
        rng.standard_normal((B, S, N)),
        rng.standard_normal((B, S, N)))]


# (B, S, H, P, N, chunk): hymba's head at its served S and chunk; a ragged
# S at the case's smallest chunk; the reduced config's P 16 and N 4, ragged
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 256, 4, 64, 16, 128),
    (2, 100, 3, 32, 16, 32),
    (1, 70, 2, 16, 4, 32),
])
def test_the_mma_arithmetic_stays_inside_the_gate(B, S, H, P, N, chunk,
                                                  dtype):
    arrays = seeded_inputs(B, S, H, P, N, seed=S * P + N)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    jargs = [jnp.asarray(a, jdt) if i in (0, 3, 4) else jnp.asarray(a)
             for i, a in enumerate(arrays)]
    want_y, want_s = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                      for a in jref.ssd_ref(*jargs))
    pallas_y = torch.from_numpy(np.array(
        ssd_pallas(*jargs, chunk=chunk).astype(jnp.float32)))
    args = [torch.from_numpy(a) for a in arrays]
    args = [t.to(dtype) if i in (0, 3, 4) else t for i, t in enumerate(args)]

    y, s = emulate_mma(*args, chunk)
    assert y.dtype == dtype and y.shape == (B, S, H, P)
    assert s.shape == (B, H, P, N)
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(s).all())
    hi_lo = max(gate_ratio(y, want_y, Y_GATE[dtype]),
                gate_ratio(s, want_s, STATE_GATE))
    assert hi_lo <= 0.75
    assert gate_ratio(y, pallas_y, Y_GATE[dtype]) <= 0.75

    y1, s1 = emulate_mma(*args, chunk, hi_lo=False)
    one = max(gate_ratio(y1, want_y, Y_GATE[dtype]),
              gate_ratio(s1, want_s, STATE_GATE))
    print(f"one-pass control {one:.3g} of the gate, hi + lo {hi_lo:.3g}")
    assert one > hi_lo, (f"the one-pass control reads {one:.3g} of the gate,"
                         f" no worse than hi + lo ({hi_lo:.3g})")


# (B, S, H, P, N, chunk, seed): hymba-1.5b's served heads at B = 1, S 256
# (the card control's shape, tests/test_torch_cuda.py and chip_smoke.py),
# and the mamba_ssd case's B 2, S 1024, H 8
@pytest.mark.parametrize("B,S,H,P,N,chunk,seed", [
    (1, 256, 50, 64, 16, 128, 0),
    (1, 256, 50, 64, 16, 128, 1),
    (2, 1024, 8, 64, 16, 128, 0),
])
def test_tf32_rounded_operands_read_above_the_f32_gate(B, S, H, P, N, chunk,
                                                       seed):
    """The card's f32 control runs K7 (three TF32 passes) on xh, B and C
    rounded to TF32 and holds it against the plain version on the exact
    operands, as K5's control does.  Emulated here against the JAX oracle:
    it reads above the card test's f32 gate (1.76-1.89 of it in the runs
    that chose the shape), while the exact operands read within 0.75; at
    the reduced config's P 16, N 4 it read 0.60-0.83, under the gate, so
    the control is not taken there."""
    arrays = seeded_inputs(B, S, H, P, N, seed)
    want_y, want_s = (torch.from_numpy(np.array(a)) for a in jref.ssd_ref(
        *[jnp.asarray(a) for a in arrays]))
    args = [torch.from_numpy(a) for a in arrays]
    rounded = [tf32(t) if i in (0, 3, 4) else t for i, t in enumerate(args)]

    def ratio(y, s):
        return max(gate_ratio(y, want_y, Y_GATE[F32]),
                   gate_ratio(s, want_s, STATE_GATE))
    exact = ratio(*emulate_mma(*args, chunk))
    control = ratio(*emulate_mma(*rounded, chunk))
    print(f"TF32-rounded operands {control:.3g} of the gate, exact "
          f"{exact:.3g}")
    assert exact <= 0.75
    assert control > 1.5
