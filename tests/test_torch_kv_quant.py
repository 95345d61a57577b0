"""The port's int8 KV cache (``LM(cfg, kv_quant=True)``; ``kv_quantize``,
``kv_dequantize`` and ``attention_decode``'s scales in
``repro_torch.models.layers``) against the JAX package's, in float32 on
converted parameters.

* ``kv_quantize`` equals JAX's bit for bit, int8 values and bf16 scales
  (both round half to even);
* prefill cache and decode logits against JAX with ``kv_quant=True``, for
  reduced codeqwen1.5-7b (dense) and hymba-1.5b (hybrid: K/V beside the
  recurrent state), at a shared and at per-slot positions: logits within
  1e-4; the int8 cache equal except where the f32 K/V (which differ by
  summation order, ~1e-6) straddle a rounding boundary, there by one step;
* against the exact cache, as the reference checks it
  (tests/test_perf_variants.py::test_kv_quant_decode_matches_exact): 16
  prompt tokens, 8 teacher-forced decode steps, logits within 0.25 and the
  argmax equal;
* ``BatchedServer`` and ``FixedBatchServer`` serve the JAX servers' tokens
  from the int8 cache on reduced codeqwen1.5-7b.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import get_model as jax_model
from repro.models import layers as JL
from repro.serve import BatchedServer as JBatchedServer
from repro.serve import FixedBatchServer as JFixedBatchServer
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import BatchedServer, FixedBatchServer

TOL = 1e-4
ARCHS = ("codeqwen1.5-7b", "hymba-1.5b")
QUANT = ("k", "v", "k_scale", "v_scale")


def reduced(get, arch):
    return dataclasses.replace(get(arch).reduced(), param_dtype="float32")


@functools.lru_cache(maxsize=None)
def models(arch):
    """(JAX int8 model, JAX params, port int8 model, port exact model) on
    the same weights; norms and biases moved off their ones and zeros."""
    jm = jax_model(reduced(jax_config, arch), kv_quant=True)
    jp = jax.tree.map(lambda a: a + 0.05,
                      jm.init_params(jax.random.PRNGKey(0)))
    cfg = reduced(get_config, arch)
    sd = params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    out = []
    for kv_quant in (True, False):
        tm = get_model(cfg, device="cpu", kv_quant=kv_quant)
        tm.load_state_dict(sd)
        out.append(tm)
    return jm, jp, *out


@pytest.fixture(autouse=True)
def _clean_registry():
    ops.clear_all()
    ops.telemetry.reset()
    yield
    ops.clear_all()
    ops.telemetry.reset()


def tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def bits(t):
    """A tensor's bits as numpy (bf16 viewed as int16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 7, 3, 16), (1, 33, 8, 128),
                                   (4, 1, 2, 80)])
def test_kv_quantize_is_bit_exact(dtype, shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape) * 3.0
    jx = jnp.asarray(x, dtype=dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = JL.kv_quantize(jx)
    tq, ts = L.kv_quantize(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tuple(ts.shape) == shape[:-1] + (1,)
    np.testing.assert_array_equal(bits(tq), jbits(jq))
    np.testing.assert_array_equal(bits(ts), jbits(js))
    np.testing.assert_array_equal(
        L.kv_dequantize(tq, ts).numpy(),
        np.asarray(JL.kv_dequantize(jq, js)))


def test_kv_quantize_rounds_half_to_even():
    """A row whose scale is exactly 1.0 (max 127; the 1e-8 vanishes in
    f32) puts every value on its own quotient: halves go to the even
    neighbour on both sides."""
    row = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5],
                   np.float32)
    jq, _ = JL.kv_quantize(jnp.asarray(row))
    tq, ts = L.kv_quantize(torch.from_numpy(row))
    assert ts.item() == 1.0
    assert tq.tolist() == [127, 0, 2, 2, 0, -2, -2, 4]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_cache_bytes_are_130_of_256_at_head_dim_128():
    """int8 values and one bf16 scale a position and kv head: (128 + 2) /
    (2 x 128) of the bf16 cache's bytes."""
    cfg = dataclasses.replace(get_config("codeqwen1.5-7b").reduced(),
                              head_dim=128)

    def nbytes(kv_quant):
        cache = get_model(cfg, device="cpu",
                          kv_quant=kv_quant).init_cache(4, 256)
        return sum(t.numel() * t.element_size() for t in cache.values())
    assert nbytes(True) * 256 == nbytes(False) * 130


def assert_cache_matches(got, want, exact=None):
    """The port's int8 cache against JAX's: scales bit for bit, and int8
    values equal but for a few one step apart; with ``exact``, the port's
    unquantized cache of the same K/V (prefill attends in full precision,
    so the exact model's prefill writes the very values quantized), each of
    those must lie within 1e-3 of a rounding boundary."""
    for name in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(bits(got[name]), jbits(want[name]))
    for name in ("k", "v"):
        g = got[name].numpy().astype(np.int32)
        w = np.asarray(want[name]).astype(np.int32)
        off = g != w
        assert np.abs(g - w).max() <= 1 and off.mean() < 1e-3
        if off.any() and exact is not None:
            q = (exact[name].float() / got[f"{name}_scale"].float()).numpy()
            frac = np.abs(q[off] - np.floor(q[off]) - 0.5)
            assert frac.max() < 1e-3, frac.max()


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_cache_matches_jax(arch, per_slot):
    jm, jp, tq, te = models(arch)
    toks = tokens(2, 16, seed=1)
    want_l, jc = jm.prefill(jp, jnp.asarray(toks), max_len=24)
    got_l, tc = tq.prefill(torch.from_numpy(toks).long(), max_len=24)
    _, exact = te.prefill(torch.from_numpy(toks).long(), max_len=24)
    close(got_l, want_l)
    assert set(tc) == set(jc) and set(QUANT) <= set(tc)
    assert tc["k"].dtype == torch.int8
    assert tc["k_scale"].shape == tc["k"].shape[:-1] + (1,)
    assert_cache_matches(tc, jc, exact)
    for step in range(3):
        pos = [16 + step, 9 + step] if per_slot else 16 + step
        nxt = tokens(2, 1, seed=10 + step)
        want, jc = jm.decode_step(jp, jc, jnp.asarray(nxt),
                                  jnp.asarray(pos, jnp.int32))
        t_pos = torch.tensor(pos) if per_slot else pos
        got, tc = tq.decode_step(tc, torch.from_numpy(nxt).long(), t_pos)
        close(got, want)
        assert_cache_matches(tc, jc)
        if "ssm" in tc:
            close(tc["ssm"], jc["ssm"])


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_decode_tracks_the_exact_cache(arch, per_slot):
    """The reference's check: 16 prompt tokens, then 8 teacher-forced
    steps; per-slot, row 1 decodes four positions behind row 0."""
    _, _, tq, te = models(arch)
    toks = torch.from_numpy(tokens(2, 24, seed=4)).long()
    _, c1 = tq.prefill(toks[:, :16], max_len=24)
    _, c0 = te.prefill(toks[:, :16], max_len=24)
    vocab = tq.cfg.vocab_size
    for i in range(16, 24):
        pos = torch.tensor([i, i - 4]) if per_slot else i
        g0, c0 = te.decode_step(c0, toks[:, i:i + 1], pos)
        g1, c1 = tq.decode_step(c1, toks[:, i:i + 1], pos)
        g0, g1 = g0[..., :vocab], g1[..., :vocab]
        assert (g0 - g1).abs().max().item() < 0.25
        assert torch.equal(g0.argmax(-1), g1.argmax(-1))


def serve_pair(jsrv, srv, prompts):
    out = []
    for s in (jsrv, srv):
        reqs = [s.submit(p, max_new=5) for p in prompts]
        s.run()
        assert all(r.done for r in reqs)
        out.append([r.tokens for r in reqs])
    return out


def test_batched_server_int8_cache_matches_jax():
    jm, jp, tq, _ = models("codeqwen1.5-7b")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (3, 20, 9, 14, 3, 30)]
    want, got = serve_pair(
        JBatchedServer(jm, jp, slots=3, max_len=32, aot=False),
        BatchedServer(tq, slots=3, max_len=32, device="cpu"), prompts)
    assert got == want


def test_fixed_batch_server_int8_cache_matches_jax():
    jm, jp, tq, _ = models("codeqwen1.5-7b")
    prompts = [tokens(1, 8, seed=20 + i)[0] for i in range(4)]
    want, got = serve_pair(
        JFixedBatchServer(jm, jp, slots=2, max_len=32, prompt_len=8),
        FixedBatchServer(tq, slots=2, max_len=32, prompt_len=8,
                         device="cpu"), prompts)
    assert got == want
