"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no JAX, so it runs on the GPU machine:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Without a CUDA device every test skips (a CUDA kernel has no CPU mode).
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)

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
