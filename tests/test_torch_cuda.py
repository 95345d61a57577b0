"""The port's kernels (K1, K2, K3, K4, K5, K6, K7) against their plain
PyTorch versions, on a card, and a small population search on the
measured ``h100`` platform.

Imports no JAX, so it runs on the GPU machine:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Without a CUDA device every test skips (a CUDA kernel has no CPU mode).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels import elementwise as k4_mod
from repro_torch.kernels.elementwise import elementwise, elementwise_plain
from repro_torch.kernels.matmul import fit, matmul, matmul_ref, path_for
from repro_torch.kernels import reduce_sum as k3_mod
from repro_torch.kernels.moe_gemm import grouped_matmul, run_body
from repro_torch.kernels.moe_gemm import path_for as k5_path_for
from repro_torch.kernels.reduce_sum import reduce_sum, reduce_sum_plain
from repro_torch.kernels.ref import grouped_matmul_ref
from repro_torch.kernels import rwkv_wkv as k6_mod
from repro_torch.kernels.rwkv_wkv import wkv, wkv_plain
from repro_torch.kernels import ssd_scan as k7_mod
from repro_torch.kernels.ssd_scan import ssd, ssd_plain
from repro_torch.core import get_case
from repro_torch.core.fe import outputs_match

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def flash_gate(got, want):
    """K2 vs its plain version, element by element: |got - want| <= atol +
    rtol |want|.  f32: summation order only; bf16: both round an f32 result
    to bf16, at most one ulp (<= 2^-7 |want|) apart, allowed two."""
    rtol = 1e-4 if got.dtype == torch.float32 else 2.0 ** -6
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5)


def flash_inputs(cuda, dtype, B, S, T, H, KV, hd):
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn(B, S, H, hd, device=cuda, generator=g).to(dtype)
    k = torch.randn(B, T, KV, hd, device=cuda, generator=g).to(dtype)
    v = torch.randn(B, T, KV, hd, device=cuda, generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal", [
    (1, 8, 8, 32, 2, 128, True),
    (4, 96, 96, 32, 2, 128, True),       # ragged: not a multiple of the tile
    (2, 130, 130, 4, 2, 256, True),      # the widest head_dim
    (2, 70, 70, 4, 1, 16, False),
    (1, 24, 200, 8, 8, 64, False),       # non-causal, S != T
    (2, 256, 256, 25, 5, 64, True),      # hymba-1.5b's heads
    (1, 100, 100, 32, 32, 80, True),     # stablelm-3b's head_dim
])
def test_flash_kernel_matches_plain_version(cuda, dtype, B, S, T, H, KV, hd,
                                            causal):
    q, k, v = flash_inputs(cuda, dtype, B, S, T, H, KV, hd)
    # bf16 up to head_dim 128 on the tensor cores, the rest on the CUDA cores
    path = "mma" if dtype == torch.bfloat16 and hd <= 128 else "simt"
    before, by_path = flash_attention.launches, dict(
        flash_attention.launches_by_path)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.launches_by_path[path] == by_path[path] + 1
    assert got.dtype == dtype and got.shape == q.shape
    flash_gate(got, flash_attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T", [
    (4, 1500, 1500),     # whisper's encoder: 1500 = 23 x 64 + 28 keys
    (4, 8, 1500),        # cross-attention at prefill
    (4, 1, 1500),        # cross-attention at decode
    (2, 200, 150),       # S > T, both edges ragged
])
def test_flash_kernel_takes_whisper_non_causal_shapes(cuda, dtype, B, S, T):
    """whisper-medium's regimes at its heads (H 16, hd 64), non-causal: bf16
    on the tensor cores, f32 on the CUDA cores."""
    q, k, v = flash_inputs(cuda, dtype, B, S, T, 16, 16, 64)
    path = "mma" if dtype == torch.bfloat16 else "simt"
    by_path = dict(flash_attention.launches_by_path)
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_path[path] == by_path[path] + 1
    assert got.dtype == dtype and got.shape == q.shape
    flash_gate(got, flash_attention_ref(q, k, v, causal=False))


@pytest.mark.parametrize("B,S,T,H,KV,hd,causal", [
    (2, 256, 256, 32, 2, 128, True),     # glm4-9b's main shape
    (2, 256, 256, 25, 5, 64, True),
    (1, 100, 100, 32, 32, 80, True),
    (1, 24, 200, 8, 8, 64, False),
])
def test_flash_bodies_agree_on_bf16(cuda, B, S, T, H, KV, hd, causal):
    """The tensor-core body and the CUDA-core body on the same bf16 inputs:
    each within the gate of the plain version, and of each other."""
    q, k, v = flash_inputs(cuda, torch.bfloat16, B, S, T, H, KV, hd)
    mma = fa_mod.run_body(q, k, v, causal=causal, path="mma")
    simt = fa_mod.run_body(q, k, v, causal=causal, path="simt")
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=causal)
    flash_gate(mma, want)
    flash_gate(simt, want)
    flash_gate(mma, simt)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("off", [0, 1024])
def test_flash_with_a_query_offset_at_the_cp_shard_shape(cuda, dtype, off):
    """A context-parallel rank's call at glm4-9b's heads: 1024 query rows
    at sequence positions ``off``.. against all 2048 keys, on the body the
    rule gives (``mma`` for bf16, ``simt`` for f32), within the gate of
    the plain version; the other body on bf16 agrees; the launch is
    counted by its offset."""
    q, k, v = flash_inputs(cuda, dtype, 1, 2048, 2048, 32, 2, 128)
    qs = q[:, off:off + 1024]
    path = "mma" if dtype == torch.bfloat16 else "simt"
    before = dict(flash_attention.launches_by_offset)
    by_path = dict(flash_attention.launches_by_path)
    got = flash_attention(qs, k, v, causal=True, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_offset[off] == before.get(off, 0) + 1
    assert flash_attention.launches_by_path[path] == by_path[path] + 1
    flash_gate(got, flash_attention_ref(qs, k, v, causal=True, q_offset=off))
    if dtype == torch.bfloat16:
        simt = fa_mod.run_body(qs, k, v, causal=True, path="simt",
                               q_offset=off)
        flash_gate(simt, flash_attention_ref(qs, k, v, causal=True,
                                             q_offset=off))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,KV,hd", [(25, 5, 64), (4, 2, 256)])
def test_flash_offset_shards_join_into_the_whole_causal_call(cuda, dtype, H,
                                                            KV, hd):
    """Shards of the queries at their offsets (ragged ones too) give the
    whole causal call's rows, within the gate, on either body (head_dim
    256 runs on the CUDA cores in bf16 too)."""
    q, k, v = flash_inputs(cuda, dtype, 2, 300, 300, H, KV, hd)
    whole = flash_attention(q, k, v, causal=True)
    cuts = [0, 37, 128, 200, 300]
    parts = [flash_attention(q[:, a:b], k, v, causal=True, q_offset=a)
             for a, b in zip(cuts, cuts[1:])]
    torch.cuda.synchronize()
    flash_gate(torch.cat(parts, 1), whole)


def test_flash_misaligned_view_takes_the_cuda_cores(cuda):
    """A bf16 view whose rows start 2 bytes off 16: the rule sends it to
    ``simt``, which matches the plain version; ``mma`` is refused on it."""
    g = torch.Generator(device=cuda).manual_seed(1)
    base = torch.randn(2, 64, 32, 129, device=cuda,
                       generator=g).to(torch.bfloat16)
    q = base[..., 1:]
    k = torch.randn(2, 64, 2, 128, device=cuda,
                    generator=g).to(torch.bfloat16)
    v = torch.randn(2, 64, 2, 128, device=cuda,
                    generator=g).to(torch.bfloat16)
    assert fa_mod.path_for(q.dtype, 128, (q.stride(), k.stride(), v.stride()),
                           (q.data_ptr(), k.data_ptr(), v.data_ptr())) \
        == "simt"
    before = dict(flash_attention.launches_by_path)
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_path["simt"] == before["simt"] + 1
    assert flash_attention.launches_by_path["mma"] == before["mma"]
    flash_gate(got, flash_attention_ref(q, k, v))
    with pytest.raises(RuntimeError, match="mma body"):
        fa_mod.run_body(q, k, v, causal=True, path="mma")


def test_flash_kernel_reads_strided_inputs(cuda):
    """q/k/v as views of one fused projection (non-contiguous B/S/H
    strides, contiguous head_dim) need no copy."""
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(2, 64, 32 + 2 + 2, 128, device=cuda, generator=g)
    q, k, v = qkv[:, :, :32], qkv[:, :, 32:34], qkv[:, :, 34:]
    assert not q.is_contiguous()
    torch.testing.assert_close(flash_attention(q, k, v),
                               flash_attention_ref(q, k, v),
                               rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)


def k1_tolerance(a, b, c, want, epilogue, alpha, beta):
    """K1 vs its plain version, element by element (as in chip_smoke.py):
    both sum the same f32 products in another order, so they differ by
    rounding noise that grows with sqrt(K) times the size of the terms
    summed, M = |alpha| (|A| @ |B|) + |beta| |C|: 4 sqrt(K) 2^-24 M.  bf16
    outputs are rounded from f32 on both sides and may land one ulp
    (<= 2^-7 |want|) apart: two ulps are allowed."""
    M = a.float().abs() @ b.float().abs()
    if epilogue == "alpha_beta":
        M = abs(alpha) * M + abs(beta) * c.float().abs()
    tol = 4 * a.shape[1] ** 0.5 * 2.0 ** -24 * M + 1e-6
    if a.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -6 * want.abs()
    return tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,bm,bn,bk,ep,view,a_scale", [
    (64, 32, 48, 32, 32, 32, "none", "", 1),      # test_kernels.py shapes
    (128, 128, 128, 32, 32, 32, "alpha_beta", "", 1),
    (96, 64, 32, 32, 32, 32, "relu", "", 1),
    (384, 384, 384, 256, 256, 256, "alpha_beta", "", 1),  # fitted to 192
    (512, 512, 512, 8, 16, 8, "alpha_beta", "", 1),   # repaired-size tiles
    (256, 256, 256, 128, 256, 64, "alpha_beta", "b.T", 1),  # syrk's A.T
    (256, 128, 256, 64, 64, 128, "none", "a.T", 1),
    # 2mm's second product: A = 1.5 (A0 @ B0), entries ~40, outputs ~1e3
    (768, 768, 768, 128, 128, 128, "alpha_beta", "", 40),
])
def test_matmul_kernel_matches_plain_version(cuda, dtype, M, K, N, bm, bn,
                                             bk, ep, view, a_scale):
    g = torch.Generator(device=cuda).manual_seed(M + K)
    a = (a_scale * torch.randn(M, K, device=cuda, generator=g)).to(dtype)
    b = torch.randn(K, N, device=cuda, generator=g).to(dtype)
    c = torch.randn(M, N, device=cuda, generator=g)
    if view == "b.T":
        b = b.T.contiguous().T
    elif view == "a.T":
        a = a.T.contiguous().T
    kw = dict(block_m=bm, block_n=bn, block_k=bk, epilogue=ep, alpha=1.5,
              beta=1.2)
    tile = (fit(bm, M), fit(bn, N), fit(bk, K))
    # aligned operands: every tile in multiples of 16 runs on the tensor
    # cores, the others (here 24 and the repaired 8) on the CUDA cores
    path = "mma" if all(t % 16 == 0 for t in tile) else "simt"
    assert path_for(dtype, *tile, (*a.stride(), *b.stride()),
                    (a.data_ptr(), b.data_ptr())) == path
    before, by_path = matmul.launches, dict(matmul.launches_by_path)
    got = matmul(a, b, c, **kw)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    assert matmul.launches_by_path[path] == by_path[path] + 1
    assert got.dtype == dtype and got.shape == (M, N)
    want = matmul_ref(a, b, c, epilogue=ep, alpha=1.5, beta=1.2).float()
    tol = k1_tolerance(a, b, c, want, ep, 1.5, 1.2)
    assert bool(((got.float() - want).abs() <= tol).all())


def tf32(x):
    """x rounded to TF32 to nearest, ties away from zero (cvt.rna)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("layout", ["AB", "A^TB", "AB^T", "A^TB^T"])
def test_matmul_main_shape_runs_on_the_tensor_cores(cuda, layout):
    """gemm's winner, 1024^3 f32 alpha*AB + beta*C on a 128^3 tile, in each
    operand layout: three TF32 passes on the tensor cores, within the
    gate; positive inputs, where every error has one sign, included."""
    g = torch.Generator(device=cuda).manual_seed(1)
    for a, b in ((torch.randn(1024, 1024, device=cuda, generator=g),
                  torch.randn(1024, 1024, device=cuda, generator=g)),
                 (torch.rand(1024, 1024, device=cuda, generator=g),
                  torch.rand(1024, 1024, device=cuda, generator=g))):
        c = torch.randn(1024, 1024, device=cuda, generator=g)
        if "A^T" in layout:
            a = a.T.contiguous().T
        if "B^T" in layout:
            b = b.T.contiguous().T
        before = matmul.launches_by_path["mma"]
        got = matmul(a, b, c, epilogue="alpha_beta", alpha=1.5, beta=1.2)
        torch.cuda.synchronize()
        assert matmul.launches_by_path["mma"] == before + 1
        want = matmul_ref(a, b, c, epilogue="alpha_beta", alpha=1.5, beta=1.2)
        tol = k1_tolerance(a, b, c, want, "alpha_beta", 1.5, 1.2)
        assert bool(((got - want).abs() <= tol).all())


def test_matmul_gate_sees_one_tf32_pass(cuda):
    """The control: K1 on operands rounded to TF32 makes the error of one
    TF32 pass, which the gate, held against the exact operands, must
    catch."""
    g = torch.Generator(device=cuda).manual_seed(2)
    a, b, c = (torch.randn(1024, 1024, device=cuda, generator=g)
               for _ in range(3))
    want = matmul_ref(a, b, c, epilogue="alpha_beta", alpha=1.5, beta=1.2)
    tol = k1_tolerance(a, b, c, want, "alpha_beta", 1.5, 1.2)
    got = matmul(tf32(a), tf32(b), c, epilogue="alpha_beta", alpha=1.5,
                 beta=1.2)
    torch.cuda.synchronize()
    assert ((got - want).abs() / tol).max().item() > 1.0


def test_matmul_kernel_refuses_an_oversized_tile(cuda):
    a = torch.zeros(512, 512, device=cuda)
    before = matmul.launches
    with pytest.raises(RuntimeError, match="shared memory"):
        matmul(a, a, block_m=256, block_n=256, block_k=256)
    assert matmul.launches == before


def recurrence_tolerance(dtype):
    """(rtol, atol) of K6/K7 against their plain versions: f32 sums the
    same terms in another order (chunked vs sequential for K7's plain
    version); bf16 outputs are rounded from f32 on both sides, two ulps."""
    return (1e-3, 1e-3) if dtype == torch.float32 else (2.0 ** -6, 1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,chunk", [
    (1, 8, 64, 64, 128),          # rwkv6-7b decode-sized prefill
    (4, 256, 64, 64, 128),        # rwkv6-7b, two stages of 128 steps
    (2, 96, 8, 64, 64),           # ragged last stage
    (2, 33, 4, 16, 16),           # the reduced config's head size
    (1, 40, 2, 128, 32),          # the widest head
    (2, 1024, 8, 64, 64),         # the Table 4 case: slices of 8 columns
    (1, 1, 64, 64, 128),          # S = 1: one step, one stage
])
def test_wkv_kernel_matches_plain_version(cuda, dtype, B, S, H, K, chunk):
    g = torch.Generator(device=cuda).manual_seed(S + K)
    r, k, v = (0.5 * torch.randn(B, S, H, K, device=cuda, generator=g)
               for _ in range(3))
    lw = -torch.rand(B, S, H, K, device=cuda, generator=g) * 3 - 0.01
    u = 0.5 * torch.randn(H, K, device=cuda, generator=g)
    r, k, v, u = (t.to(dtype) for t in (r, k, v, u))
    before = wkv.launches
    o, st = wkv(r, k, v, lw, u, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv.launches == before + 1
    assert o.dtype == dtype and st.dtype == torch.float32
    want_o, want_st = wkv_plain(r, k, v, lw, u, chunk=chunk)
    rtol, atol = recurrence_tolerance(dtype)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(st, want_st, rtol=1e-3, atol=1e-3)


def wkv_check(o, st, want_o, want_st, dtype):
    rtol, atol = recurrence_tolerance(dtype)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(st, want_st, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_kernel_takes_a_v_the_column_slice_does_not_divide(cuda, dtype):
    """V 48 at B·H 64: six slices of 8 columns; V 44: the last slice holds
    4 of its 8 columns (the rest masked), and bf16 rows of 88 bytes take
    8-byte copies."""
    g = torch.Generator(device=cuda).manual_seed(48)
    for V in (48, 44):
        r, k = (0.5 * torch.randn(1, 70, 64, 64, device=cuda, generator=g)
                for _ in range(2))
        v = 0.5 * torch.randn(1, 70, 64, V, device=cuda, generator=g)
        lw = -torch.rand(1, 70, 64, 64, device=cuda, generator=g) * 3 - 0.01
        u = 0.5 * torch.randn(64, 64, device=cuda, generator=g)
        r, k, v, u = (t.to(dtype) for t in (r, k, v, u))
        assert k6_mod.geometry(64, 64, V)[1:] == (8, 6)
        o, st = wkv(r, k, v, lw, u, chunk=32)
        torch.cuda.synchronize()
        assert o.shape == (1, 70, 64, V) and st.shape == (1, 64, 64, V)
        wkv_check(o, st, *wkv_plain(r, k, v, lw, u, chunk=32), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_kernel_takes_strided_views_of_one_projection(cuda, dtype):
    """r, k, v and lw cut from one [B, S, H, 4K] projection, as a model
    may pass them; and r one element off 4 bytes (bf16: element copies)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    B, S, H, K = 2, 70, 4, 64
    proj = (0.5 * torch.randn(B, S, H, 4 * K, device=cuda,
                              generator=g)).to(dtype)
    r, k, v = (proj[..., i * K:(i + 1) * K] for i in range(3))
    lw = -proj[..., 3 * K:].float().abs() - 0.01
    u = (0.5 * torch.randn(H, K, device=cuda, generator=g)).to(dtype)
    assert not r.is_contiguous() and r.stride(-1) == 1
    o, st = wkv(r, k, v, lw, u, chunk=32)
    torch.cuda.synchronize()
    wkv_check(o, st, *wkv_plain(r, k, v, lw, u, chunk=32), dtype)
    buf = torch.empty(r.numel() + 1, dtype=dtype, device=cuda)
    off = buf[1:].view(B, S, H, K)
    off.copy_(r)
    o2, st2 = wkv(off, k, v, lw, u, chunk=32)
    torch.cuda.synchronize()
    assert torch.equal(o2, o) and torch.equal(st2, st)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_entry_runs_a_slice_off_16_bytes(cuda, dtype):
    """One stage starts at the base of shared memory, so a column slice
    whose v rows are not a multiple of 16 bytes runs (its copies take the
    widest width the row allows): K 128 (16 lanes a column), VB 2 (8 bytes
    in f32, 4 in bf16) and the 16-byte slice agree with the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, S, H, K, V, chunk = 1, 3, 2, 128, 16, 3
    r, k, v = (0.5 * torch.randn(B, S, H, n, device=cuda, generator=g)
               .to(dtype) for n in (K, K, V))
    lw = -torch.rand(B, S, H, K, device=cuda, generator=g) * 3 - 0.01
    u = (0.5 * torch.randn(H, K, device=cuda, generator=g)).to(dtype)
    want = wkv_plain(r, k, v, lw, u, chunk=chunk)
    for VB in (2, 16 // r.element_size()):
        o, st = k6_mod._launch(r, k, v, lw, u, (B, S, H, K, V, chunk, VB))
        torch.cuda.synchronize()
        wkv_check(o, st, *want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 8, 50, 64, 16, 128),      # hymba, one short chunk
    (4, 256, 50, 64, 16, 128),    # hymba, two chunks
    (2, 200, 8, 64, 16, 256),     # the case's largest chunk, ragged
    (2, 70, 8, 16, 4, 32),        # the reduced config's P and N
    (1, 64, 2, 128, 16, 64),      # the widest head
])
def test_ssd_kernel_matches_plain_version(cuda, dtype, B, S, H, P, N,
                                          chunk):
    """Every row takes the tensor cores (``mma``): xh is contiguous, and
    B_t and C_t are two halves of one projection, as the model passes
    them."""
    xh, dt, a_log, B_t, C_t = ssd_inputs(cuda, dtype, B, S, H, P, N)
    before = ssd.launches
    mma = ssd.launches_by_path["mma"]
    y, st = ssd(xh, dt, a_log, B_t, C_t, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    assert ssd.launches_by_path["mma"] == mma + 1
    assert y.dtype == dtype and st.dtype == torch.float32
    ssd_check(y, st, *ssd_plain(xh, dt, a_log, B_t, C_t, chunk=chunk), dtype)


def ssd_inputs(cuda, dtype, B, S, H, P, N):
    g = torch.Generator(device=cuda).manual_seed(S + P)
    xh = torch.randn(B, S, H, P, device=cuda, generator=g)
    dt = torch.rand(B, S, H, device=cuda, generator=g) * 0.1 + 0.001
    a_log = torch.rand(H, device=cuda, generator=g) * 2 - 1
    bc = torch.randn(B, S, 2 * N, device=cuda, generator=g)
    B_t, C_t = (t.to(dtype) for t in torch.chunk(bc, 2, dim=-1))
    return xh.to(dtype), dt, a_log, B_t, C_t


def ssd_check(y, st, want_y, want_st, dtype):
    rtol, atol = recurrence_tolerance(dtype)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(st, want_st, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 256, 50, 64, 16, 128),    # hymba at its served B = 1
    (2, 200, 8, 64, 16, 256),     # the case's largest chunk, ragged
    (2, 70, 8, 16, 4, 32),        # the reduced config's P and N
])
def test_ssd_bodies_and_slices_agree(cuda, dtype, B, S, H, P, N, chunk):
    """The ``mma`` body at each column slice that divides P against the
    ``simt`` body on the same inputs, each within the gate of the plain
    version, with nothing counted."""
    args = ssd_inputs(cuda, dtype, B, S, H, P, N)
    want = ssd_plain(*args, chunk=chunk)
    before = (ssd.launches, dict(ssd.launches_by_path))
    simt = k7_mod.run_body(*args, chunk=chunk, path="simt")
    torch.cuda.synchronize()
    ssd_check(*simt, *want, dtype)
    for width in [w for w in (16, 32) if P % w == 0]:
        y, st = k7_mod.run_body(*args, chunk=chunk, path="mma", width=width)
        torch.cuda.synchronize()
        ssd_check(y, st, *want, dtype)
        ssd_check(y, st, *simt, dtype)
    assert (ssd.launches, ssd.launches_by_path) == before


def ssd_gate_ratio(y, st, want_y, want_st, dtype):
    """The largest |got - want| over the gate of ``ssd_check``, output and
    state: within it at most 1."""
    rtol, atol = recurrence_tolerance(dtype)
    return max(((y.float() - want_y.float()).abs()
                / (atol + rtol * want_y.float().abs())).max().item(),
               ((st - want_st).abs() / (1e-3 + 1e-3 * want_st.abs()))
               .max().item())


def test_ssd_gate_sees_one_tf32_pass(cuda):
    """The f32 control, as K5's: K7 on xh, B and C rounded to TF32 makes
    the error of one TF32 pass on its operands, which the gate, held
    against the plain version on the exact operands, must catch at
    hymba-1.5b's served heads (H 50, P 64, N 16; the CPU emulation read
    1.84-1.89 of the gate there, tests/test_torch_ssd_mma.py); on the
    exact operands the three passes read within it."""
    args = ssd_inputs(cuda, torch.float32, 1, 256, 50, 64, 16)
    xh, dt, a_log, B_t, C_t = args
    want = ssd_plain(*args, chunk=128)
    rounded = (tf32(xh.contiguous()), dt, a_log, tf32(B_t.contiguous()),
               tf32(C_t.contiguous()))
    mma = ssd.launches_by_path["mma"]
    control = ssd_gate_ratio(*ssd(*rounded, chunk=128), *want,
                             torch.float32)
    exact = ssd_gate_ratio(*ssd(*args, chunk=128), *want, torch.float32)
    torch.cuda.synchronize()
    assert ssd.launches_by_path["mma"] == mma + 2
    assert exact <= 1.0
    assert control > 1.0


def test_ssd_view_off_16_bytes_takes_the_cuda_cores(cuda):
    """xh one element past a 16-byte boundary: the wrapper takes ``simt``
    and agrees with the plain version; the kernel's entry refuses an
    ``mma`` launch there."""
    xh, dt, a_log, B_t, C_t = ssd_inputs(cuda, torch.bfloat16, 1, 96, 4, 64,
                                         16)
    buf = torch.empty(xh.numel() + 1, dtype=xh.dtype, device=cuda)
    off = buf[1:].view(xh.shape)
    off.copy_(xh)
    assert off.data_ptr() % 16
    simt = ssd.launches_by_path["simt"]
    y, st = ssd(off, dt, a_log, B_t, C_t, chunk=64)
    torch.cuda.synchronize()
    assert ssd.launches_by_path["simt"] == simt + 1
    ssd_check(y, st, *ssd_plain(xh, dt, a_log, B_t, C_t, chunk=64),
              torch.bfloat16)
    with pytest.raises(RuntimeError, match="launch failed"):
        k7_mod.run_body(off, dt, a_log, B_t, C_t, chunk=64, path="mma")


def test_recurrent_kernels_refuse_an_oversized_stage(cuda):
    x = torch.zeros(1, 512, 1, 64, device=cuda)
    before = ssd.launches
    with pytest.raises(RuntimeError, match="shared memory"):
        ssd(x, torch.zeros(1, 512, 1, device=cuda), torch.zeros(1,
                                                                 device=cuda),
            torch.zeros(1, 512, 16, device=cuda),
            torch.zeros(1, 512, 16, device=cuda), chunk=512)
    assert ssd.launches == before


# ------------------------------------------------------------------ K3 ----
def reduce_tolerance(x, want):
    """K3 vs its plain version: both sum the same n terms in f32 in
    another order; rounding moves each sum by far less than 2^-20 sum|x|
    (16 ulps of the sum of magnitudes, where the random-walk error of n
    roundings is ~sqrt(n) ulps of a partial sum).  A bf16 total is also
    rounded from f32 on both sides: one ulp (2^-8 |want|) more."""
    tol = 2.0 ** -20 * x.float().abs().sum().item()
    if x.dtype == torch.bfloat16:
        tol += 2.0 ** -8 * abs(float(want))
    return tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,block", [
    (8192, 1024),                 # test_kernels.py
    (4194304, 1024),              # the reduction case's largest scale
    (4194304, 4096),              # four blocks a CUDA block (16 at 1024)
    (1048576, 16384),
    (6000, 1024),                 # fitted to 1000: not a multiple of 256
    (4099, 4096),                 # prime: 4099 blocks of one
    (1, 4096),
])
def test_reduce_kernel_matches_plain_version(cuda, dtype, n, block):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, device=cuda, generator=g).to(dtype)
    before = reduce_sum.launches
    got = reduce_sum(x, block=block)
    torch.cuda.synchronize()
    assert reduce_sum.launches == before + 1
    assert got.dtype == dtype and got.shape == ()
    want = reduce_sum_plain(x, block=block)
    assert abs(float(got) - float(want)) <= reduce_tolerance(x, want)
    # bit-identical on every call: no atomic adds a value
    again = reduce_sum(x, block=block)
    assert torch.equal(got, again)
    # integers in [-2, 2]: every partial sum is exact in f32, so any order
    # gives the same bits; a lost or doubled element shows
    xi = torch.randint(-2, 3, (n,), device=cuda, generator=g).to(dtype)
    assert torch.equal(reduce_sum(xi, block=block),
                       reduce_sum_plain(xi, block=block))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,block,offset", [
    (4194304, 16384, 1),          # the reduction case's main shape
    (4194304, 4096, 1),
    (1048576, 1024, 3),
    (6000, 1024, 1),              # blocks of 1000: 250 f32 chunks a block
    (4099, 4096, 2),              # blocks of one: element by element
])
def test_reduce_kernel_is_bitwise_equal_at_an_address_off_16_bytes(
        cuda, dtype, n, block, offset):
    """The same values at an address ``offset`` elements past a 16-byte
    boundary (a view into a larger buffer) take the element-by-element
    loads, with the 16-byte path's grouping: the same bits."""
    g = torch.Generator(device=cuda).manual_seed(n + offset)
    x = torch.randn(n, device=cuda, generator=g).to(dtype)
    buf = torch.empty(n + 8, device=cuda, dtype=dtype)
    view = buf[offset:offset + n]
    view.copy_(x)
    assert view.data_ptr() % 16 != 0 and x.data_ptr() % 16 == 0
    got = reduce_sum(x, block=block)
    assert torch.equal(reduce_sum(view, block=block), got)
    assert torch.equal(reduce_sum(x, block=block, keepdim=True)[0], got)
    want = reduce_sum_plain(x, block=block)
    assert abs(float(got) - float(want)) <= reduce_tolerance(x, want)


def test_reduce_kernel_is_right_on_two_streams_at_once(cuda):
    """Launches on two streams overlap; each stream has its own ticket, so
    every result is the single-stream one, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(7)
    xs = [torch.randn(4194304, device=cuda, generator=g),
          torch.randn(2097152, device=cuda, generator=g)]
    want = [reduce_sum(x, block=4096) for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    assert streams[0].cuda_stream != streams[1].cuda_stream
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(50):
        for i, (x, st) in enumerate(zip(xs, streams)):
            with torch.cuda.stream(st):
                got[i].append(reduce_sum(x, block=4096))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(r, want[i]) for r in got[i]), i
    index = torch.cuda.current_device()
    assert {(index, st.cuda_stream) for st in streams} <= set(k3_mod._workspaces)


# ------------------------------------------------------------------ K4 ----
def add(x, y):
    return x + y


def affine(x):
    return 2.0 * x + 1.0


def fma(x, y, z):
    return x * y + z


@pytest.mark.parametrize("fn,n_in,n,block,dtype", [
    (add, 2, 8192, 2048, torch.float32),          # test_kernels.py
    (add, 2, 16777216, 16384, torch.float32),     # vectoradd's largest
    (add, 2, 6000, 4096, torch.float32),          # fitted to 3000: masked
    (add, 2, 4096, 4096, torch.bfloat16),
    (affine, 1, 1000, 8192, torch.float32),
    (fma, 3, 65536, 8192, torch.float32),
])
def test_elementwise_kernel_matches_plain_version(cuda, fn, n_in, n, block,
                                                  dtype):
    """Element by element the same IEEE arithmetic, but Triton may contract
    a product and a sum into one FMA (one rounding fewer), which moves the
    result by at most an ulp of the terms: within 2^-22 fn(|args|), the
    size of the terms for these maps; a sum alone is exact."""
    g = torch.Generator(device=cuda).manual_seed(n)
    arrs = [torch.randn(n, device=cuda, generator=g).to(dtype)
            for _ in range(n_in)]
    before = elementwise.launches
    got = elementwise(fn, *arrs, block=block)
    torch.cuda.synchronize()
    assert elementwise.launches == before + 1
    assert got.dtype == dtype and got.shape == (n,)
    want = elementwise_plain(fn, *arrs)
    if fn is add:
        assert torch.equal(got, want)
    else:
        terms = fn(*[a.float().abs() for a in arrs])
        assert bool(((got.float() - want.float()).abs()
                     <= 2.0 ** -22 * terms).all())


def test_elementwise_hits_its_cached_kernel_after_the_first_call(
        cuda, monkeypatch):
    monkeypatch.setattr(k4_mod, "_launches", {})
    g = torch.Generator(device=cuda).manual_seed(100)
    a, b = (torch.randn(65536, device=cuda, generator=g) for _ in range(2))
    compiles, hits = elementwise.compiles, elementwise.cache_hits
    for _ in range(100):
        got = elementwise(add, a, b, block=8192)
    torch.cuda.synchronize()
    assert elementwise.compiles == compiles + 1
    assert elementwise.cache_hits == hits + 99
    assert torch.equal(got, elementwise_plain(add, a, b))


def test_elementwise_view_one_element_off_compiles_a_second_kernel(
        cuda, monkeypatch):
    """A view off 16 bytes has its own launch key, so it never runs the
    kernel compiled for aligned pointers; both agree with the plain
    version bit for bit (a sum alone is exact)."""
    monkeypatch.setattr(k4_mod, "_launches", {})
    g = torch.Generator(device=cuda).manual_seed(101)
    n = 1 << 20
    a, b = (torch.randn(n, device=cuda, generator=g) for _ in range(2))
    buf = torch.empty(n + 1, device=cuda)
    off = buf[1:]
    off.copy_(a)
    compiles = elementwise.compiles
    aligned = [elementwise(add, a, b) for _ in range(2)]
    shifted = [elementwise(add, off, b) for _ in range(2)]
    torch.cuda.synchronize()
    assert elementwise.compiles == compiles + 2 and len(k4_mod._launches) == 2
    want = elementwise_plain(add, a, b)
    for got in aligned + shifted:
        assert torch.equal(got, want)


# ------------------------------------------------------------------ K5 ----
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,K,N,bm,bn,bk", [
    (4, 64, 32, 48, 32, 32, 16),       # test_kernels.py
    (2, 128, 128, 128, 128, 64, 64),
    (8, 32, 16, 32, 64, 64, 64),       # blocks larger than dims → fitted
    (8, 512, 256, 512, 128, 128, 128),  # moe_grouped_gemm's largest scale
    (8, 64, 256, 512, 32, 32, 32),     # its baseline tile at its smallest
    (8, 384, 256, 512, 256, 256, 64),  # 256-wide tiles: 128^2 sub-tiles
])
def test_grouped_matmul_kernel_matches_plain_version(cuda, dtype, E, M, K,
                                                     N, bm, bn, bk):
    g = torch.Generator(device=cuda).manual_seed(M + K)
    x = torch.randn(E, M, K, device=cuda, generator=g).to(dtype)
    w = torch.randn(E, K, N, device=cuda, generator=g).to(dtype)
    tile = (fit(bm, M), fit(bn, N), fit(bk, K))
    # contiguous operands: every tile in multiples of 16 runs on the tensor
    # cores, the others (here 24) on the CUDA cores
    path = "mma" if all(t % 16 == 0 for t in tile) else "simt"
    assert k5_path_for(dtype, *tile, x.stride(), w.stride(),
                       (x.data_ptr(), w.data_ptr())) == path
    before = grouped_matmul.launches
    by_path = dict(grouped_matmul.launches_by_path)
    got = grouped_matmul(x, w, block_m=bm, block_n=bn, block_k=bk)
    torch.cuda.synchronize()
    assert grouped_matmul.launches == before + 1
    assert grouped_matmul.launches_by_path[path] == by_path[path] + 1
    assert got.dtype == dtype and got.shape == (E, M, N)
    want = grouped_matmul_ref(x, w).float()
    for e in range(E):
        tol = k1_tolerance(x[e], w[e], None, want[e], "none", 1.0, 0.0)
        assert bool(((got[e].float() - want[e]).abs() <= tol).all()), e


def k5_gate_ratio(got, x, w):
    """The largest |got - want| over K1's gate, expert by expert."""
    want = grouped_matmul_ref(x, w).float()
    return max(((got[e].float() - want[e]).abs()
                / k1_tolerance(x[e], w[e], None, want[e], "none", 1.0,
                               0.0)).max().item()
               for e in range(x.shape[0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [64, 128, 256, 512])
@pytest.mark.parametrize("tile", [(128, 128, 128), (32, 32, 32),
                                  (64, 256, 64), (256, 128, 128)])
def test_grouped_matmul_takes_the_tensor_cores_at_the_case_scales(
        cuda, dtype, M, tile):
    """moe_grouped_gemm's x [8, M, 256] @ w [8, 256, 512] at each of its
    scales, on campaign tiles (fitted to M; the widest that f32 fits):
    the "mma" body, within K1's gate expert by expert, and the "simt" body
    on the same inputs within it too."""
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn(8, M, 256, device=cuda, generator=g).to(dtype)
    w = torch.randn(8, 256, 512, device=cuda, generator=g).to(dtype)
    before = grouped_matmul.launches_by_path["mma"]
    got = grouped_matmul(x, w, block_m=tile[0], block_n=tile[1],
                         block_k=tile[2])
    torch.cuda.synchronize()
    assert grouped_matmul.launches_by_path["mma"] == before + 1
    assert k5_gate_ratio(got, x, w) <= 1.0
    fitted = (fit(tile[0], M), fit(tile[1], 512), fit(tile[2], 256))
    simt = run_body(x, w, fitted, "simt")
    torch.cuda.synchronize()
    assert k5_gate_ratio(simt, x, w) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_tile_8_takes_the_cuda_cores(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(8, 64, 256, device=cuda, generator=g).to(dtype)
    w = torch.randn(8, 256, 512, device=cuda, generator=g).to(dtype)
    before = dict(grouped_matmul.launches_by_path)
    got = grouped_matmul(x, w, block_m=8, block_n=8, block_k=8)
    torch.cuda.synchronize()
    assert grouped_matmul.launches_by_path == {
        "mma": before["mma"], "simt": before["simt"] + 1}
    assert k5_gate_ratio(got, x, w) <= 1.0


def test_grouped_matmul_views_off_16_bytes_take_the_cuda_cores(cuda):
    """An expert stride off 16 bytes, and x at an address off 16 bytes:
    "simt", right; an "mma" launch of either is refused by the kernel's
    entry."""
    g = torch.Generator(device=cuda).manual_seed(9)
    E, M, K, N = 8, 128, 256, 512
    buf = torch.randn(E * (M * K + 1), device=cuda, generator=g)
    views = [buf.as_strided((E, M, K), (M * K + 1, K, 1)),
             buf[1:E * M * K + 1].view(E, M, K)]
    w = torch.randn(E, K, N, device=cuda, generator=g)
    for x in views:
        before = dict(grouped_matmul.launches_by_path)
        got = grouped_matmul(x, w)
        torch.cuda.synchronize()
        assert grouped_matmul.launches_by_path["simt"] == before["simt"] + 1
        assert k5_gate_ratio(got, x, w) <= 1.0
        with pytest.raises(RuntimeError, match="invalid argument"):
            run_body(x, w, (128, 128, 128), "mma")


def test_grouped_matmul_gate_sees_one_tf32_pass(cuda):
    """The control: K5 on operands rounded to TF32 makes the error of one
    TF32 pass, which the gate, held against the exact operands, must
    catch."""
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(8, 512, 256, device=cuda, generator=g)
    w = torch.randn(8, 256, 512, device=cuda, generator=g)
    got = grouped_matmul(tf32(x), tf32(w))
    torch.cuda.synchronize()
    assert k5_gate_ratio(got, x, w) > 1.0


def test_grouped_matmul_kernel_refuses_an_oversized_tile(cuda):
    x = torch.zeros(2, 512, 256, device=cuda)
    w = torch.zeros(2, 256, 512, device=cuda)
    before = grouped_matmul.launches
    with pytest.raises(RuntimeError, match="shared memory"):
        grouped_matmul(x, w, block_m=256, block_n=256, block_k=256)
    assert grouped_matmul.launches == before


# ---- one_pass builds: one CUDA graph replay --------------------------------
ONE_PASS = [("dwthaar1d", {"one_pass": True}),
            ("fastwalshtransform", {"reshape_butterfly": False,
                                    "one_pass": True}),
            ("fastwalshtransform", {"reshape_butterfly": True,
                                    "one_pass": True})]


@pytest.mark.parametrize("name,variant", ONE_PASS)
def test_one_pass_graph_equals_the_eager_build(cuda, name, variant):
    """The replayed graph against the baseline's eager chain within the
    case's FE tolerance; a second call with new data returns its own result
    (not the first call's buffer); a second shape captures a second
    graph."""
    case = get_case(name)
    fn = case.build(variant, impl="torch")
    eager = case.build(dict(case.baseline_variant), impl="torch")
    g = torch.Generator(device=cuda).manual_seed(3)
    x1 = torch.randn(65536, device=cuda, generator=g)
    x2 = torch.randn(65536, device=cuda, generator=g)
    y1 = fn(x1)
    y2 = fn(x2)
    torch.cuda.synchronize()
    assert len(fn.graphs) == 1
    assert y1.data_ptr() != y2.data_ptr()
    assert outputs_match(y1, eager(x1)).ok
    assert outputs_match(y2, eager(x2)).ok
    assert not torch.equal(y1, y2)
    x3 = torch.randn(16384, device=cuda, generator=g)
    y3 = fn(x3)
    torch.cuda.synchronize()
    assert len(fn.graphs) == 2 and y3.shape == x3.shape
    assert outputs_match(y3, eager(x3)).ok
    assert outputs_match(fn(x1), y1).ok     # the first graph still replays


# ---- the population search on the card ------------------------------------
def test_population_campaign_on_the_card_runs_k1_on_the_tensor_cores(cuda):
    """A small population search (gemm, size 3, 2 generations, the four
    personae) on the measured ``h100`` platform: every candidate is
    FE-checked and timed through K1, which takes the tensor cores at
    every call (all the case's tiles are multiples of 16)."""
    from repro_torch.core import (Campaign, CaseJob, H100Platform,
                                  HeuristicProposer, MEPConstraints,
                                  OptConfig, PatternStore, PopulationConfig)
    platform = H100Platform()
    before = dict(matmul.launches_by_path)
    camp = Campaign(platform, patterns=PatternStore(),
                    population=PopulationConfig(size=3, generations=2))
    res = camp.run([CaseJob(
        get_case("gemm"), HeuristicProposer(0, None, platform.name),
        cfg=OptConfig(r=5, k=1),
        constraints=MEPConstraints(t_max_s=2.0, r=5, k=1))])[0]
    torch.cuda.synchronize()
    launched = {p: matmul.launches_by_path[p] - before[p] for p in before}
    cands = [c for rl in res.rounds for c in rl.candidates]
    assert res.persona_stats and len(res.rounds) <= 2
    assert any(c.status == "ok" for c in cands)
    assert res.best_time_s <= res.baseline_time_s
    assert launched["mma"] > len(cands) and launched["simt"] == 0


# ---- training on the card -------------------------------------------------
@pytest.mark.parametrize("name", ["flash_attention", "wkv", "ssd"])
def test_kernels_refuse_under_grad_on_the_card(cuda, name):
    """K2, K6 and K7 on CUDA tensors that require grad raise the named
    error and launch nothing; without grad the same call launches."""
    from repro_torch.kernels.no_backward import NoBackwardKernelError
    g = torch.Generator(device=cuda).manual_seed(0)
    if name == "flash_attention":
        fn, shapes = flash_attention, [(1, 64, 4, 64), (1, 64, 2, 64),
                                       (1, 64, 2, 64)]
    elif name == "wkv":
        fn, shapes = wkv, [(1, 64, 2, 64)] * 4 + [(2, 64)]
    else:
        fn, shapes = ssd, [(1, 64, 2, 64), (1, 64, 2), (2,), (1, 64, 16),
                           (1, 64, 16)]
    args = [torch.randn(s, device=cuda, generator=g) for s in shapes]
    if name == "wkv":
        args[3] = -args[3].abs()
    if name == "ssd":
        args[1] = args[1].abs()
    before = fn.launches
    with pytest.raises(NoBackwardKernelError):
        fn(*[a.clone().requires_grad_(i == 0) for i, a in enumerate(args)])
    assert fn.launches == before
    with torch.no_grad():
        fn(*[a.clone().requires_grad_(i == 0) for i, a in enumerate(args)])
    assert fn.launches == before + 1


def test_reduced_train_step_on_the_card_matches_the_cpu(cuda):
    """Two AdamW steps of reduced stablelm-3b in float32 (TF32 off) on the
    card and on the CPU, from the same weights and batches: the first
    step's gradients within 1e-4 relative plus 1e-5 of the largest, each
    step's loss and grad norm within 1e-5 relative, the moments within
    1e-4 of their largest, and the parameters within 2 lr per step (an
    Adam step of a gradient near 0 may take either sign)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData, make_global_batch
    from repro_torch.models import get_model
    from repro_torch.train import (AdamWConfig, init_state, make_train_step,
                                   model_params)
    from repro_torch.train.optim import schedule
    cfg = dataclasses.replace(get_config("stablelm-3b").reduced(),
                              param_dtype="float32")
    opt_cfg = AdamWConfig(lr=1e-3)
    data = SyntheticLMData(cfg, 64, 4, seed=0)
    state = None
    runs = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            model = get_model(cfg, device=dev)
            if state is None:
                model.init_params(torch.Generator().manual_seed(0))
                state = {k: v.clone() for k, v in model.state_dict().items()}
            else:
                model.load_state_dict(state)
            first = {}

            def record(grads, first=first):
                if not first:
                    first.update({n: t.clone() for n, t in grads.items()})
                return grads
            step = make_train_step(model, opt_cfg, grad_hook=record)
            params = model_params(model)
            opt = init_state(params)
            metrics = []
            for s in range(2):
                params, opt, m = step(params, opt,
                                      make_global_batch(data, s, device=dev))
                metrics.append({k: float(v) for k, v in m.items()})
            runs[dev] = (first, params, opt, metrics)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (g0, p0, o0, m0), (g1, p1, o1, m1) = runs["cpu"], runs["cuda"]
    scale = max(float(t.abs().max()) for t in g0.values())
    for n in g0:
        torch.testing.assert_close(g1[n].cpu(), g0[n], rtol=1e-4,
                                   atol=1e-5 * scale)
    for a, b in zip(m0, m1):
        for k in ("loss", "grad_norm", "lr"):
            assert b[k] == pytest.approx(a[k], rel=1e-5)
    for key in ("mu", "nu"):
        top = max(float(t.abs().max()) for t in o0[key].values())
        for n in o0[key]:
            torch.testing.assert_close(o1[key][n].cpu(), o0[key][n],
                                       rtol=0, atol=1e-4 * top)
    step_lrs = float(schedule(opt_cfg, 1)) + float(schedule(opt_cfg, 2))
    for n in p0:
        torch.testing.assert_close(p1[n].cpu(), p0[n], rtol=0,
                                   atol=2 * step_lrs)
