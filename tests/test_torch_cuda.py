"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no JAX, so it runs on the GPU machine:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Without a CUDA device every test skips (a CUDA kernel has no CPU mode).
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.matmul import matmul, matmul_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal", [
    (1, 8, 8, 32, 2, 128, True),
    (4, 96, 96, 32, 2, 128, True),       # ragged: not a multiple of the tile
    (2, 130, 130, 4, 2, 256, True),      # the widest head_dim
    (2, 70, 70, 4, 1, 16, False),
    (1, 24, 200, 8, 8, 64, False),       # non-causal, S != T
])
def test_flash_kernel_matches_plain_version(cuda, dtype, B, S, T, H, KV, hd,
                                            causal):
    # element by element, |got - want| <= atol + rtol |want|.  f32: summation
    # order only; bf16: both round an f32 result to bf16, at most one ulp
    # (<= 2^-7 |want|) apart, allowed two
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn(B, S, H, hd, device=cuda, generator=g).to(dtype)
    k = torch.randn(B, T, KV, hd, device=cuda, generator=g).to(dtype)
    v = torch.randn(B, T, KV, hd, device=cuda, generator=g).to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5)


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
    before = matmul.launches
    got = matmul(a, b, c, **kw)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (M, N)
    want = matmul_ref(a, b, c, epilogue=ep, alpha=1.5, beta=1.2).float()
    tol = k1_tolerance(a, b, c, want, ep, 1.5, 1.2)
    assert bool(((got.float() - want).abs() <= tol).all())


def test_matmul_kernel_refuses_an_oversized_tile(cuda):
    a = torch.zeros(512, 512, device=cuda)
    before = matmul.launches
    with pytest.raises(RuntimeError, match="shared memory"):
        matmul(a, a, block_m=256, block_n=256, block_k=256)
    assert matmul.launches == before
