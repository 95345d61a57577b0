"""The port's state-space blocks (``repro_torch.models.ssm``) against
``repro.models.ssm`` on the same numpy inputs and parameters, in float32.

Tolerance 1e-5 (absolute and relative) where both sides run the same f32
arithmetic in another order; 1e-4 for outputs that sum a chunked
recurrence over 32+ steps (seen: ~1e-6).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import ssm as JS
from repro.sharding.ctx import ShardCtx
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import ssm as S

CTX = ShardCtx.null()


def reduced(get, arch):
    return dataclasses.replace(get(arch).reduced(), param_dtype="float32")


def params(spec, seed):
    """numpy parameters for a spec (name → shape): normal, std 0.3."""
    rng = np.random.default_rng(seed)
    return {n: (0.3 * rng.standard_normal(shp)).astype(np.float32)
            for n, shp in sorted(spec.items())}


def both(p):
    return ({n: jnp.asarray(a) for n, a in p.items()},
            {n: torch.from_numpy(a) for n, a in p.items()})


def randn(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                                np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(autouse=True)
def _clean_registry():
    ops.clear_all()
    yield
    ops.clear_all()


@pytest.mark.parametrize("S_,chunk", [(32, 8), (48, 16), (8, 16)])
def test_wkv_chunked_matches_jax(S_, chunk):
    r, k, v = (randn((2, S_, 2, 16), s, 0.5) for s in (1, 2, 3))
    lw = -np.abs(randn((2, S_, 2, 16), 4)) - 0.01
    u = randn((2, 16), 5, 0.5)
    want_o, want_s = JS._wkv_chunked(*map(jnp.asarray, (r, k, v, lw, u)),
                                     chunk, use_impl=False)
    got_o, got_s = S._wkv_chunked(*map(torch.from_numpy, (r, k, v, lw, u)),
                                  chunk, use_impl=False)
    close(got_o, want_o, 1e-4)
    close(got_s, want_s, 1e-4)


@pytest.mark.parametrize("S_,chunk", [(32, 8), (64, 32), (8, 16)])
def test_ssd_chunked_matches_jax(S_, chunk):
    xh = randn((2, S_, 3, 16), 1)
    dt = np.abs(randn((2, S_, 3), 2, 0.3)) + 0.01
    a_log = randn((3,), 3, 0.3)
    B_t, C_t = randn((2, S_, 4), 4), randn((2, S_, 4), 5)
    args = (xh, dt, a_log, B_t, C_t)
    want_y, want_s = JS._ssd_chunked(*map(jnp.asarray, args), chunk,
                                     use_impl=False)
    got_y, got_s = S._ssd_chunked(*map(torch.from_numpy, args), chunk,
                                  use_impl=False)
    close(got_y, want_y, 1e-4)
    close(got_s, want_s, 1e-4)


def test_chunked_paths_assert_divisibility_as_jax_does():
    r = torch.zeros(1, 12, 1, 16)
    with pytest.raises(AssertionError):
        S._wkv_chunked(r, r, r, r, torch.zeros(1, 16), 8, use_impl=False)
    with pytest.raises(AssertionError):
        S._ssd_chunked(torch.zeros(1, 12, 1, 16), torch.zeros(1, 12, 1),
                       torch.zeros(1), torch.zeros(1, 12, 4),
                       torch.zeros(1, 12, 4), 8, use_impl=False)


@pytest.mark.parametrize("seq", [16, 2])      # 2 < conv_dim - 1: padded tail
def test_mamba_block_parallel_matches_jax(seq):
    jcfg, cfg = reduced(jax_config, "hymba-1.5b"), reduced(get_config,
                                                          "hymba-1.5b")
    jp, tp = both(params(S.mamba_param_spec(cfg), seed=0))
    x = randn((2, seq, cfg.d_model), 7)
    want, wst = JS.mamba_block(jnp.asarray(x), jp, jcfg, CTX)
    got, gst = S.mamba_block(torch.from_numpy(x), tp, cfg)
    close(got, want)
    close(gst["conv"], wst["conv"])
    close(gst["ssm"], wst["ssm"], 1e-4)


def test_mamba_block_decode_matches_jax():
    jcfg, cfg = reduced(jax_config, "hymba-1.5b"), reduced(get_config,
                                                          "hymba-1.5b")
    jp, tp = both(params(S.mamba_param_spec(cfg), seed=1))
    shapes = S.mamba_state_shape(cfg, 2)
    state = {"conv": randn(shapes["conv"], 8), "ssm": randn(shapes["ssm"], 9)}
    x = randn((2, 1, cfg.d_model), 10)
    want, wst = JS.mamba_block(jnp.asarray(x), jp, jcfg, CTX,
                               state={k: jnp.asarray(a)
                                      for k, a in state.items()})
    got, gst = S.mamba_block(torch.from_numpy(x), tp, cfg,
                             state={k: torch.from_numpy(a)
                                    for k, a in state.items()})
    close(got, want)
    close(gst["conv"], wst["conv"])
    close(gst["ssm"], wst["ssm"])
    assert shapes == JS.mamba_state_shape(jcfg, 2)


@pytest.mark.parametrize("carried", [False, True])
def test_rwkv_time_mix_matches_jax(carried):
    """The parallel form, and with ``carried`` the branch that folds a
    previous segment's state into a multi-token call (``ssm.py:323-330``)."""
    jcfg, cfg = reduced(jax_config, "rwkv6-7b"), reduced(get_config,
                                                        "rwkv6-7b")
    jp, tp = both(params(S.rwkv_param_spec(cfg), seed=2))
    x = randn((2, 16, cfg.d_model), 11)
    shift = randn((2, cfg.d_model), 12)
    wkv = 0.5 * randn(S.rwkv_state_shape(cfg, 2)["wkv"], 13) if carried \
        else None
    want, (wsh, wwkv) = JS.rwkv_time_mix(
        jnp.asarray(x), jp, jcfg, CTX, shift_state=jnp.asarray(shift),
        wkv_state=None if wkv is None else jnp.asarray(wkv))
    got, (gsh, gwkv) = S.rwkv_time_mix(
        torch.from_numpy(x), tp, cfg, shift_state=torch.from_numpy(shift),
        wkv_state=None if wkv is None else torch.from_numpy(wkv))
    close(got, want, 1e-4)
    close(gsh, wsh)
    close(gwkv, wwkv, 1e-4)


def test_rwkv_time_mix_decode_matches_jax():
    jcfg, cfg = reduced(jax_config, "rwkv6-7b"), reduced(get_config,
                                                        "rwkv6-7b")
    jp, tp = both(params(S.rwkv_param_spec(cfg), seed=3))
    x = randn((2, 1, cfg.d_model), 14)
    shift = randn((2, cfg.d_model), 15)
    wkv = randn(S.rwkv_state_shape(cfg, 2)["wkv"], 16)
    want, (wsh, wwkv) = JS.rwkv_time_mix(
        jnp.asarray(x), jp, jcfg, CTX, shift_state=jnp.asarray(shift),
        wkv_state=jnp.asarray(wkv))
    got, (gsh, gwkv) = S.rwkv_time_mix(
        torch.from_numpy(x), tp, cfg, shift_state=torch.from_numpy(shift),
        wkv_state=torch.from_numpy(wkv))
    close(got, want)
    close(gsh, wsh)
    close(gwkv, wwkv)
    assert S.rwkv_state_shape(cfg, 3) == JS.rwkv_state_shape(jcfg, 3)


def test_rwkv_channel_mix_matches_jax():
    jcfg, cfg = reduced(jax_config, "rwkv6-7b"), reduced(get_config,
                                                        "rwkv6-7b")
    jp, tp = both(params(S.rwkv_param_spec(cfg), seed=4))
    x = randn((2, 16, cfg.d_model), 17)
    shift = randn((2, cfg.d_model), 18)
    want, wsh = JS.rwkv_channel_mix(jnp.asarray(x), jp, jcfg, CTX,
                                    shift_state=jnp.asarray(shift))
    got, gsh = S.rwkv_channel_mix(torch.from_numpy(x), tp, cfg,
                                  shift_state=torch.from_numpy(shift))
    close(got, want)
    close(gsh, wsh)


def test_layer_scaled_groupnorm_uses_the_population_variance():
    """jnp.var divides by n; torch.var's default (n − 1) would differ by
    sqrt(n/(n-1)) ≈ 3% at groups of 16."""
    x = randn((2, 5, 64), 19, 2.0) + 1.0
    scale, bias = randn((64,), 20), randn((64,), 21)
    want = JS.layer_scaled_groupnorm(jnp.asarray(x), jnp.asarray(scale),
                                     jnp.asarray(bias), 4, 1e-5)
    got = S.layer_scaled_groupnorm(torch.from_numpy(x),
                                   torch.from_numpy(scale),
                                   torch.from_numpy(bias), 4, 1e-5)
    close(got, want)


def test_causal_conv_and_token_shift_match_jax():
    x, w, b = randn((2, 9, 8), 22), randn((4, 8), 23), randn((8,), 24)
    close(S._causal_conv(*map(torch.from_numpy, (x, w, b))),
          JS._causal_conv(*map(jnp.asarray, (x, w, b))))
    last = randn((2, 8), 25)
    gp, gl = S._token_shift(torch.from_numpy(x), torch.from_numpy(last))
    wp, wl = JS._token_shift(jnp.asarray(x), jnp.asarray(last))
    close(gp, wp)
    close(gl, wl)


def test_param_specs_and_dims_match_jax():
    for arch, spec_fn in (("hymba-1.5b", "mamba_param_spec"),
                          ("rwkv6-7b", "rwkv_param_spec")):
        jspec = getattr(JS, spec_fn)(jax_config(arch))
        spec = getattr(S, spec_fn)(get_config(arch))
        assert spec == {n: shp for n, (shp, _) in jspec.items()}
    assert S.mamba_dims(get_config("hymba-1.5b")) == \
        JS.mamba_dims(jax_config("hymba-1.5b")) == (3200, 50, 64)


def test_a_stateless_site_impl_gets_a_zero_state():
    """An impl returning the output alone (the JAX kernels' form) gets the
    JAX twin's state of zeros; K6/K7's (out, state) is passed through."""
    r = torch.ones(1, 4, 2, 16)
    u = torch.zeros(2, 16)
    with ops.use_impl("rwkv_wkv", lambda r, k, v, lw, u, chunk: r):
        o, st = S._wkv_chunked(r, r, r, -r, u, 8)
    assert o is r and st.shape == (1, 2, 16, 16) and not st.any()
    marker = (torch.zeros(1), torch.ones(1))
    with ops.use_impl("ssm_chunk", lambda *a, chunk: marker):
        assert S._ssd_chunked(r, r[..., 0], u[:, 0], r[:, :, 0],
                              r[:, :, 0], 8) is marker
