"""The port's ``make_prefill_step`` and ``make_serve_step`` against the JAX
package's, at reduced sizes in float32 on converted parameters: a dense
(glm4-9b), a recurrent (rwkv6-7b), a hybrid (hymba-1.5b) and the
encoder–decoder (whisper-medium) config.

The prefill step's last logits and every cache entry, and three greedy
serve steps from a prefilled cache (their tokens equal, every step's cache
entries close), are held against the reference's on the same numpy draw.
Tolerance 1e-4 absolute and relative, as in ``test_torch_lm.py``: both
sides run the same f32 arithmetic in another order.
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
from repro.train import make_prefill_step as jax_prefill_step
from repro.train import make_serve_step as jax_serve_step
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax
from repro_torch.train import make_prefill_step, make_serve_step

ARCHS = ("glm4-9b", "rwkv6-7b", "hymba-1.5b", "whisper-medium")
B, S, MAX_LEN = 2, 16, 24
TOL = 1e-4


def reduced(get, arch):
    return dataclasses.replace(get(arch).reduced(), param_dtype="float32")


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(jax model, jax params, port model, numpy inputs) of one config."""
    jm = jax_model(reduced(jax_config, arch))
    jp = jm.init_params(jax.random.PRNGKey(0))
    cfg = reduced(get_config, arch)
    tm = get_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(3)
    inputs = [rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)]
    if cfg.family == "encdec":
        inputs.append(rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32))
    return jm, jp, tm, inputs


def close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def close_caches(got, want):
    assert set(got) == set(want)
    for name, c in got.items():
        assert tuple(c.shape) == want[name].shape, name
        close(c, want[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_jax(arch):
    jm, jp, tm, inputs = pair(arch)
    want_logits, want_cache = jax_prefill_step(jm)(
        jp, *map(jnp.asarray, inputs))
    got_logits, got_cache = make_prefill_step(tm)(
        torch.from_numpy(inputs[0]).long(),
        *map(torch.from_numpy, inputs[1:]))
    close(got_logits, want_logits)
    close_caches(got_cache, want_cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_jax(arch):
    """Three greedy serve steps from a cache prefilled to ``MAX_LEN``, the
    first fed the prefill's argmax and each later one the token the step
    before chose."""
    jm, jp, tm, inputs = pair(arch)
    jlogits, jc = jm.prefill(jp, *map(jnp.asarray, inputs), max_len=MAX_LEN)
    _, tc = tm.prefill(torch.from_numpy(inputs[0]).long(),
                       *map(torch.from_numpy, inputs[1:]), max_len=MAX_LEN)
    jstep, tstep = jax.jit(jax_serve_step(jm)), make_serve_step(tm)
    first = np.argmax(np.asarray(jlogits)[:, -1], axis=-1)[:, None]
    jtok = jnp.asarray(first, jnp.int32)
    ttok = torch.from_numpy(first).long()
    for pos in range(S, S + 3):
        jtok, jc = jstep(jp, jc, jtok, jnp.asarray(pos, jnp.int32))
        ttok, tc = tstep(tc, ttok, pos)
        assert ttok.dtype == torch.int32 and tuple(ttok.shape) == (B, 1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        close_caches(tc, jc)
        ttok = ttok.long()
