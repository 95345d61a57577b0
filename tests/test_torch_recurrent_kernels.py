"""The plain versions of K6 (``kernels/rwkv_wkv.py``) and K7
(``kernels/ssd_scan.py``) against the JAX package's Pallas kernels in
interpret mode and its sequential oracles, on the same numpy inputs.

Tolerances: against the Pallas kernels those of ``test_kernels.py:57-99``
(1e-3 for WKV, 2e-3 for SSD, absolute and relative: both sides are f32
with the recurrences summed in another order); against the oracles
``ref.wkv_ref``/``ref.ssd_ref`` 1e-4 for outputs and states, as
``test_kernels.py`` holds the chunked model paths.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv_wkv import wkv_pallas
from repro.kernels.ssd_scan import ssd_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.rwkv_wkv import geometry
from repro_torch.kernels.rwkv_wkv import smem_bytes as wkv_smem
from repro_torch.kernels.rwkv_wkv import wkv, wkv_plain
from repro_torch.kernels.ssd_scan import smem_bytes as ssd_smem
from repro_torch.kernels.ssd_scan import ssd, ssd_plain


def wkv_inputs(B, S, H, K, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, S, H, K)) for _ in range(3))
    lw = -np.abs(rng.standard_normal((B, S, H, K))) - 0.01
    u = 0.5 * rng.standard_normal((H, K))
    return [a.astype(np.float32) for a in (r, k, v, lw, u)]


def ssd_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P))
    dt = np.abs(0.3 * rng.standard_normal((B, S, H))) + 0.01
    a_log = 0.3 * rng.standard_normal(H)
    B_t, C_t = rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N))
    return [a.astype(np.float32) for a in (xh, dt, a_log, B_t, C_t)]


def torch_of(arrays):
    return [torch.from_numpy(a) for a in arrays]


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------- K6 -----
@pytest.mark.parametrize("S,H,K,chunk", [
    (64, 2, 16, 16), (128, 4, 32, 32), (96, 2, 16, 32), (128, 2, 64, 64),
])
def test_wkv_plain_matches_pallas_kernel(S, H, K, chunk):
    """test_kernels.py:57-69's sweep: the Pallas kernel (interpret mode)
    returns o only; the port returns (o, state)."""
    arrays = wkv_inputs(2, S, H, K, seed=S + K)
    want = wkv_pallas(*map(jnp.asarray, arrays), chunk=chunk)
    got, state = wkv(*torch_of(arrays), chunk=chunk, device="cpu")
    assert got.dtype == torch.float32 and tuple(state.shape) == (2, H, K, K)
    close(got, want, 1e-3)


@pytest.mark.parametrize("S,chunk", [(96, 64), (64, 16), (7, 64), (1, 8)])
def test_wkv_plain_output_and_state_match_the_oracle(S, chunk):
    """Outputs and final state against the JAX sequential oracle, including
    an S the chunk does not divide (96 with chunk 64)."""
    arrays = wkv_inputs(2, S, 2, 16, seed=S)
    want_o, want_s = jref.wkv_ref(*map(jnp.asarray, arrays))
    got_o, got_s = wkv_plain(*torch_of(arrays), chunk=chunk)
    close(got_o, want_o, 1e-4)
    close(got_s, want_s, 1e-4)
    ref_o, ref_s = ref.wkv_ref(*torch_of(arrays))     # the port's oracle
    close(ref_o, want_o, 1e-4)
    close(ref_s, want_s, 1e-4)


def test_wkv_plain_casts_o_to_the_input_dtype_and_keeps_f32_state():
    r, k, v, lw, u = torch_of(wkv_inputs(1, 12, 2, 16, seed=3))
    bf = [t.to(torch.bfloat16) for t in (r, k, v)]
    o, s = wkv_plain(*bf, lw, u.to(torch.bfloat16), chunk=4)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    want_o, want_s = ref.wkv_ref(*bf, lw, u.to(torch.bfloat16))
    torch.testing.assert_close(o, want_o.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(s, want_s, rtol=0, atol=0)


def test_wkv_wrapper_refuses_what_the_kernel_does_not_take():
    r, k, v, lw, u = torch_of(wkv_inputs(1, 8, 2, 16, seed=0))
    with pytest.raises(TypeError, match="lw"):
        wkv(r, k, v, lw.to(torch.bfloat16), u, device="cpu")
    with pytest.raises(TypeError, match="share"):
        wkv(r, k, v.to(torch.bfloat16), lw, u, device="cpu")
    with pytest.raises(ValueError, match="head size"):
        wkv(*(t[..., :12] for t in (r, k, v, lw)), u[:, :12], device="cpu")
    with pytest.raises(ValueError, match=r"u \(2, 8\)"):
        wkv(r, k, v, lw, u[:, :8], device="cpu")
    big = torch_of(wkv_inputs(1, 300, 1, 128, seed=0))
    # the one stage the kernel stages, at the column slice B·H = 1 takes
    need = wkv_smem(300, 128, geometry(1, 128, 128)[1], 4)
    with pytest.raises(RuntimeError, match=f"{need} bytes of shared memory"):
        wkv(*big, chunk=300, device="cpu")
    before = wkv.launches
    wkv(r, k, v, lw, u, device="cpu")
    assert wkv.launches == before       # the plain version is no launch


# ---------------------------------------------------------------- K7 -----
@pytest.mark.parametrize("S,H,P,N,chunk", [
    (64, 2, 16, 8, 16), (128, 4, 32, 16, 32), (128, 2, 64, 16, 64),
])
def test_ssd_plain_matches_pallas_kernel(S, H, P, N, chunk):
    """test_kernels.py:88-99's sweep (Pallas in interpret mode, y only)."""
    arrays = ssd_inputs(2, S, H, P, N, seed=S + P)
    want = ssd_pallas(*map(jnp.asarray, arrays), chunk=chunk)
    got, state = ssd(*torch_of(arrays), chunk=chunk, device="cpu")
    assert got.dtype == torch.float32 and tuple(state.shape) == (2, H, P, N)
    close(got, want, 2e-3)


@pytest.mark.parametrize("S,chunk", [(96, 64), (64, 16), (50, 128), (1, 32)])
def test_ssd_plain_output_and_state_match_the_oracle(S, chunk):
    """Outputs and final state against the JAX sequential oracle, including
    an S the chunk does not divide (the masked last chunk)."""
    arrays = ssd_inputs(2, S, 3, 16, 8, seed=S)
    want_y, want_s = jref.ssd_ref(*map(jnp.asarray, arrays))
    got_y, got_s = ssd_plain(*torch_of(arrays), chunk=chunk)
    close(got_y, want_y, 1e-4)
    close(got_s, want_s, 1e-4)
    ref_y, ref_s = ref.ssd_ref(*torch_of(arrays))
    close(ref_y, want_y, 1e-4)
    close(ref_s, want_s, 1e-4)


def test_ssd_plain_reads_the_models_strided_b_and_c():
    """The model's B_t and C_t are the two halves of one projection (a
    strided view each); the result equals that of contiguous copies."""
    xh, dt, a_log, B_t, C_t = torch_of(ssd_inputs(2, 40, 2, 16, 4, seed=1))
    bc = torch.cat([B_t, C_t], dim=-1)
    Bv, Cv = torch.chunk(bc, 2, dim=-1)
    assert not Bv.is_contiguous()
    got = ssd(xh, dt, a_log, Bv, Cv, chunk=16, device="cpu")
    want = ssd(xh, dt, a_log, B_t, C_t, chunk=16, device="cpu")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take():
    xh, dt, a_log, B_t, C_t = torch_of(ssd_inputs(1, 8, 2, 16, 4, seed=0))
    with pytest.raises(TypeError, match="dt"):
        ssd(xh, dt.to(torch.bfloat16), a_log, B_t, C_t, device="cpu")
    with pytest.raises(ValueError, match="head size P=24"):
        ssd(torch.zeros(1, 8, 2, 24), dt, a_log, B_t, C_t, device="cpu")
    with pytest.raises(ValueError, match="dt"):
        ssd(xh, dt[:, :4], a_log, B_t, C_t, device="cpu")
    need = ssd_smem(512, 64, 16)
    big = torch_of(ssd_inputs(1, 512, 1, 64, 16, seed=0))
    with pytest.raises(RuntimeError, match=f"{need} bytes of shared memory"):
        ssd(*big, chunk=512, device="cpu")
    assert ssd_smem(256, 64, 16) == 140_672     # the case's largest chunk fits
    before = ssd.launches
    ssd(xh, dt, a_log, B_t, C_t, device="cpu")
    assert ssd.launches == before
