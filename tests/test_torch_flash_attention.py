"""The port's flash attention (repro_torch.kernels.flash_attention) against
the JAX package's Pallas kernel run in interpret mode, as
tests/test_kernels.py runs it, and against ``ref.attention_ref``.

On CPU tensors the wrapper computes the kernel's plain version; the CUDA
kernel itself is checked on a card by tests/test_torch_cuda.py and
chip_smoke.py.  Inputs are made by numpy from a seed and handed to both
packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)

# the tolerances of tests/test_kernels.py: f32 differs by summation order,
# bf16 by at most an ulp of the output (both sides compute in f32)
TOL = {"float32": 2e-4, "bfloat16": 5e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def qkv(B, S, T, H, KV, hd, dtype="float32", seed=0):
    """The same inputs for both packages: (jax triple, torch triple)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))]
    jx = tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    th = tuple(torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs)
    return jx, th


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("S,H,KV,hd,bq,bk", [
    (128, 4, 2, 64, 64, 64),
    (256, 4, 4, 32, 128, 64),
    (64, 2, 1, 128, 64, 32),
    (128, 8, 2, 64, 128, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_interpret(S, H, KV, hd, bq, bk, dtype):
    (jq, jk, jv), (q, k, v) = qkv(2, S, S, H, KV, hd, dtype)
    want = jax_flash(jq, jk, jv, causal=True, block_q=bq, block_k=bk)
    got = flash_attention(q, k, v, causal=True, device="cpu")
    assert got.dtype == TORCH_DT[dtype] and got.shape == q.shape
    close(got, want, TOL[dtype])


def test_flash_attention_noncausal():
    (jq, jk, jv), (q, k, v) = qkv(1, 128, 128, 4, 4, 32, seed=1)
    want = jax_flash(jq, jk, jv, causal=False, block_q=64, block_k=64)
    close(flash_attention(q, k, v, causal=False, device="cpu"), want, 2e-4)
    # non-causal admits S != T (cross-attention shape)
    (jq, jk, jv), (q, k, v) = qkv(1, 24, 40, 4, 2, 32, seed=2)
    close(flash_attention(q, k, v, causal=False, device="cpu"),
          jref.attention_ref(jq, jk, jv, causal=False), 2e-4)


@pytest.mark.parametrize("S", [8, 96, 130])
def test_flash_attention_ragged_matches_attention_ref(S):
    """S not a multiple of any tile (the server's last bucket is max_len):
    the Pallas kernel asserts there, the port masks the edge."""
    (jq, jk, jv), (q, k, v) = qkv(2, S, S, 8, 2, 64, seed=S)
    got = flash_attention(q, k, v, causal=True, device="cpu")
    close(got, jref.attention_ref(jq, jk, jv, causal=True), 2e-4)
    close(tref.attention_ref(q, k, v, causal=True),
          jref.attention_ref(jq, jk, jv, causal=True), 2e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, (q, k, v) = qkv(1, 16, 16, 4, 2, 32)
    with pytest.raises(NotImplementedError, match="softcap"):
        flash_attention(q, k, v, softcap=30.0, device="cpu")
    _, (q2, k2, v2) = qkv(1, 8, 16, 4, 2, 32)
    with pytest.raises(ValueError, match="S=8 != T=16"):
        flash_attention(q2, k2, v2, causal=True, device="cpu")
    _, (q3, k3, v3) = qkv(1, 16, 16, 4, 2, 24)
    with pytest.raises(ValueError, match="head_dim 24"):
        flash_attention(q3, k3, v3, device="cpu")
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half(), device="cpu")
    with pytest.raises(ValueError, match="do not group"):
        flash_attention(q[:, :, :3], k, v, device="cpu")
    # the plain version rejects the same inputs
    with pytest.raises(NotImplementedError):
        flash_attention_ref(q, k, v, softcap=30.0)


def test_cuda_request_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (q, k, v) = qkv(1, 16, 16, 4, 2, 32)
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_attention(q, k, v)                  # default device: cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_attention(q, k, v, device="cuda")
    assert flash_attention.launches == before
