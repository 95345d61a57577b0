"""K2's two bodies, on the CPU: which one a launch takes, and why P must be
applied as a bf16 hi + lo pair on the tensor cores.

* ``flash_attention.path_for``, the rule that sends a launch to the tensor
  cores ("mma") or to the CUDA cores ("simt"), at the serving shapes of
  glm4-9b, hymba-1.5b and stablelm-3b, and on f32, head_dim 256, a view
  whose base is off 16 bytes and a row stride off 16 bytes;
* a CPU call, which takes the plain version and counts no launch;
* a torch emulation of the ``mma`` body's arithmetic (bf16 q, k, v; 64-key
  tiles; online softmax in f32 with exp2; P split into bf16 hi + lo, two
  PV products into an f32 accumulator; bf16 output), held against the JAX
  package's ``attention_ref`` with K2's gate, and the one-pass bf16 P of
  ``attention_chunked``, which the gate must catch.

The kernel itself runs only on a card: ``tests/test_torch_cuda.py`` holds
both bodies against the plain version there.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels.flash_attention import flash_attention, path_for

BF16, F32 = torch.bfloat16, torch.float32
# K2's gate (chip_smoke.KERNEL_TOL, tests/test_torch_cuda.py):
# |got - want| <= ATOL + RTOL |want|
RTOL, ATOL = 2.0 ** -6, 1e-5
BK = 64                         # the kernel's key tile


def layout(B, S, H, KV, hd, dtype=BF16):
    """Strides and 16-byte aligned addresses of contiguous q, k, v."""
    q = torch.empty(B, S, H, hd, dtype=dtype)
    k = torch.empty(B, S, KV, hd, dtype=dtype)
    return (q.stride(), k.stride(), k.stride()), (0, 4096, 8192)


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 256, 32, 2, 128),       # glm4-9b
    (4, 8, 32, 2, 128),
    (2, 256, 25, 5, 64),        # hymba-1.5b
    (1, 100, 32, 32, 80),       # stablelm-3b
])
def test_serving_shapes_take_the_tensor_cores(B, S, H, KV, hd):
    assert path_for(BF16, hd, *layout(B, S, H, KV, hd)) == "mma"


@pytest.mark.parametrize("hd", [16, 32, 48, 96, 112])
def test_every_head_dim_in_multiples_of_16_to_128_takes_mma(hd):
    assert path_for(BF16, hd, *layout(1, 64, 4, 2, hd)) == "mma"


def test_f32_takes_the_cuda_cores():
    assert path_for(F32, 128, *layout(2, 256, 32, 2, 128, F32)) == "simt"


def test_head_dim_256_takes_the_cuda_cores():
    assert path_for(BF16, 256, *layout(2, 130, 4, 2, 256)) == "simt"


def test_a_base_off_16_bytes_takes_the_cuda_cores():
    base = torch.empty(2, 64, 32, 136, dtype=BF16)
    q = base[..., 8:]                      # rows 16-byte strided ...
    strides, ptrs = layout(2, 64, 32, 2, 128)
    assert path_for(BF16, 128, (q.stride(),) + strides[1:],
                    (16,) + ptrs[1:]) == "mma"
    # ... but starting 2 bytes past a 16-byte boundary
    assert path_for(BF16, 128, (q.stride(),) + strides[1:],
                    (18,) + ptrs[1:]) == "simt"


def test_a_row_stride_off_16_bytes_takes_the_cuda_cores():
    q = torch.empty(2, 64, 32, 129, dtype=BF16)[..., :128]
    assert q.stride(-1) == 1 and q.stride(2) * 2 % 16
    strides, ptrs = layout(2, 64, 32, 2, 128)
    assert path_for(BF16, 128, (q.stride(),) + strides[1:], ptrs) == "simt"
    v = torch.empty(2, 64 * 3, 2, 128, dtype=BF16)[:, ::3]   # S stride 768
    assert path_for(BF16, 128, strides[:2] + (v.stride(),), ptrs) == "mma"
    v = torch.empty(2, 64, 2, 132, dtype=BF16)[..., 2:130]   # 264-byte rows
    assert path_for(BF16, 128, strides[:2] + (v.stride(),), ptrs) == "simt"


def test_cpu_calls_count_no_launch_on_either_body():
    q = torch.randn(1, 64, 4, 64).to(BF16)
    k = torch.randn(1, 64, 2, 64).to(BF16)
    before = (flash_attention.launches,
              dict(flash_attention.launches_by_path))
    out = flash_attention(q, k, k, device="cpu")
    assert out.shape == q.shape and out.dtype == BF16
    assert (flash_attention.launches,
            flash_attention.launches_by_path) == before


def emulate_mma(q, k, v, *, causal: bool, hi_lo: bool = True):
    """The ``mma`` body's arithmetic on bf16 q [B,S,H,hd], k/v [B,T,KV,hd]:
    exact bf16 products summed in f32, 64-key tiles, the running max and
    sum in f32 in the exp2 domain, P applied as bf16 hi + lo (or, with
    ``hi_lo=False``, cast once to bf16 as ``attention_chunked`` does), an
    f32 accumulator rounded to bf16 at the end."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().permute(0, 2, 1, 3)                          # B H S hd
    kf = k.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    sl2 = (1.0 / math.sqrt(hd)) * math.log2(math.e)
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros(B, H, S, 1)
    acc = torch.zeros(B, H, S, hd)
    rows = torch.arange(S)[:, None]
    for k0 in range(0, T, BK):
        s = (qf @ kf[:, :, k0:k0 + BK].transpose(-1, -2)) * sl2
        keys = k0 + torch.arange(s.shape[-1])[None, :]
        if causal:
            s = torch.where(keys <= rows, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        vt = vf[:, :, k0:k0 + BK]
        hi = p.to(BF16).float()
        acc = acc * alpha + hi @ vt
        if hi_lo:
            acc = acc + (p - hi).to(BF16).float() @ vt
        m = m_new
    return (acc / l).to(BF16).permute(0, 2, 1, 3)


def gate_ratio(got, want):
    """The largest |got - want| / (ATOL + RTOL |want|): within the gate
    when at most 1."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (ATOL + RTOL * want.abs())).max().item()


# (B, S, H, KV, hd): a small GQA case, glm4-9b's main serving shape and
# hymba-1.5b's heads at a ragged S
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 4, 2, 128),
    (2, 256, 32, 2, 128),
    (1, 96, 25, 5, 64),
])
def test_hi_lo_p_stays_inside_the_gate_and_one_pass_does_not(B, S, H, KV,
                                                             hd):
    rng = np.random.default_rng(B * 1000 + S + hd)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    q, k, v = (torch.from_numpy(a).to(BF16) for a in arrs)
    want = torch.from_numpy(np.array(jref.attention_ref(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrs), causal=True
    ).astype(jnp.float32)))
    hi_lo = emulate_mma(q, k, v, causal=True)
    one_pass = emulate_mma(q, k, v, causal=True, hi_lo=False)
    assert hi_lo.shape == q.shape and bool(torch.isfinite(hi_lo.float()).all())
    assert gate_ratio(hi_lo, want) <= 0.75
    assert gate_ratio(one_pass, want) > 10
