"""The port's dense layers (repro_torch.models.layers) against their JAX
twins in repro.models.layers, on the same numpy inputs, in float32.

Tolerances: the two sides run the same f32 arithmetic in another order
(XLA vs PyTorch's CPU kernels), so values agree to ~1e-6 relative; 1e-5 is
stated for elementwise layers and 1e-4 for those with contractions.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.sharding.ctx import ShardCtx
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as TL

CFG = dataclasses.replace(get_config("glm4-9b").reduced(),
                          param_dtype="float32")
JCFG = dataclasses.replace(jax_config("glm4-9b").reduced(),
                           param_dtype="float32")
NULL = ShardCtx.null()


def arrays(*shapes, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.fixture(autouse=True)
def _clean_registry():
    ops.clear_all()
    yield
    ops.clear_all()


def test_config_is_the_jax_config():
    full = get_config("glm4-9b")
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jax_config("glm4-9b"))
    assert full.param_counts() == (9_399_947_264, 9_399_947_264)
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)


def test_rms_norm():
    x, s = arrays((2, 5, 64), (64,))
    close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5),
          JL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5), 1e-5)


@pytest.mark.parametrize("positions", ["row", "per_slot"])
def test_rope_partial(positions):
    """glm4 rotates half the head dim as split halves; positions as the
    parallel forward gives them ([1, S]) and as ragged decode does
    ([B, 1], one position per slot)."""
    B, S = (2, 7) if positions == "row" else (3, 1)
    (x,) = arrays((B, S, 4, 16))
    pos = (np.arange(S)[None, :] if positions == "row"
           else np.array([[5], [0], [113]]))
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos),
                  CFG.rope_theta, CFG.partial_rotary)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                   JCFG.rope_theta, JCFG.partial_rotary)
    close(got, want, 1e-5)
    # the second half of head_dim passes through untouched
    np.testing.assert_array_equal(got[..., 8:].numpy(), x[..., 8:])


def qkv_params(seed=0):
    spec = TL.attn_param_spec(CFG)
    assert set(spec) == set(JL.attn_param_spec(JCFG))
    vals = arrays(*spec.values(), seed=seed, scale=0.2)
    return dict(zip(spec, vals))


def test_project_qkv_with_bias():
    p = qkv_params()
    (x,) = arrays((2, 6, CFG.d_model), seed=1)
    pos = np.arange(6)[None, :]
    got = TL._project_qkv(torch.from_numpy(x),
                          {k: torch.from_numpy(v) for k, v in p.items()},
                          CFG, torch.from_numpy(pos))
    want = JL._project_qkv(jnp.asarray(x),
                           {k: jnp.asarray(v) for k, v in p.items()},
                           JCFG, NULL, jnp.asarray(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g, w, 1e-4)


@pytest.mark.parametrize("S,q_chunk", [(16, 8), (12, 8), (24, 256)])
def test_attention_chunked_plain(S, q_chunk):
    """Including S not divisible by the chunk (largest divisor ≤ chunk)."""
    q, k, v = arrays((2, S, 4, 16), (2, S, 2, 16), (2, S, 2, 16), seed=S)
    got = TL.attention_chunked(*map(torch.from_numpy, (q, k, v)),
                               causal=True, q_chunk=q_chunk)
    want = JL.attention_chunked(*map(jnp.asarray, (q, k, v)), causal=True,
                                ctx=NULL, q_chunk=q_chunk)
    close(got, want, 1e-5)


def test_attention_chunked_takes_the_installed_impl():
    q, k, v = arrays((2, 16, 4, 16), (2, 16, 2, 16), (2, 16, 2, 16), seed=3)
    calls = []

    def impl(q, k, v, *, causal, softcap):
        calls.append(tuple(q.shape))
        return flash_attention(q, k, v, causal=causal, softcap=softcap,
                               device="cpu")

    with ops.use_impl("attention", impl):
        got = TL.attention_chunked(*map(torch.from_numpy, (q, k, v)),
                                   causal=True, q_chunk=8)
    assert calls == [(2, 16, 4, 16)]
    want = JL.attention_chunked(*map(jnp.asarray, (q, k, v)), causal=True,
                                ctx=NULL, q_chunk=8)
    close(got, want, 1e-5)
    # use_impl=False bypasses the registry
    with ops.use_impl("attention", functools.partial(flash_attention,
                                                     device="cpu")):
        TL.attention_chunked(*map(torch.from_numpy, (q, k, v)), causal=True,
                             use_impl=False)
    assert len(calls) == 1


def test_attention_decode_with_lengths():
    q, kc, vc = arrays((3, 1, 4, 16), (3, 20, 2, 16), (3, 20, 2, 16), seed=4)
    length = np.array([1, 13, 20])
    got = TL.attention_decode(*map(torch.from_numpy, (q, kc, vc)),
                              torch.from_numpy(length))
    want = JL.attention_decode(*map(jnp.asarray, (q, kc, vc)),
                               jnp.asarray(length, jnp.int32))
    close(got, want, 1e-5)


@pytest.mark.parametrize("pos", [5, [0, 7, 19]])
def test_cache_update_and_lengths(pos):
    cache, new = arrays((3, 20, 2, 16), (3, 1, 2, 16), seed=5)
    t_cache = torch.from_numpy(cache.copy())
    t_pos = pos if isinstance(pos, int) else torch.tensor(pos)
    out = TL.cache_update(t_cache, torch.from_numpy(new), t_pos)
    assert out is t_cache                          # updated in place
    want = JL.cache_update(jnp.asarray(cache), jnp.asarray(new),
                           jnp.asarray(pos, jnp.int32))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        TL.decode_lengths(t_pos, 3).numpy(),
        np.asarray(JL.decode_lengths(jnp.asarray(pos, jnp.int32), 3)))


def test_mlp_swiglu():
    spec = TL.mlp_param_spec(CFG)
    assert spec == {k: s for k, (s, _) in JL.mlp_param_spec(JCFG).items()}
    p = dict(zip(spec, arrays(*spec.values(), seed=6, scale=0.2)))
    (x,) = arrays((2, 5, CFG.d_model), seed=7)
    got = TL.mlp(torch.from_numpy(x),
                 {k: torch.from_numpy(v) for k, v in p.items()}, CFG)
    want = JL.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                  JCFG, NULL)
    close(got, want, 1e-4)
