"""The port's LM (repro_torch.models.lm) against the JAX package's LM on
reduced glm4-9b in float32, starting from JAX ``init_params`` converted by
``params_from_jax``.

Tolerance 1e-4 (absolute and relative): both sides run the same f32
arithmetic in another order, and the differences seen are ~1e-6.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import get_model as jax_model
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import init_rule
from repro_torch.models.lm import LM

TOL = 1e-4


def reduced(get):
    return dataclasses.replace(get("glm4-9b").reduced(), param_dtype="float32")


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model) with the same weights."""
    jm = jax_model(reduced(jax_config))
    jp = jm.init_params(jax.random.PRNGKey(0))
    cfg = reduced(get_config)
    tm = get_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


@pytest.fixture(autouse=True)
def _clean_registry():
    ops.clear_all()
    yield
    ops.clear_all()


def tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def test_forward_hidden_states(pair):
    jm, jp, tm = pair
    toks = tokens(2, 32)
    want, _, _ = jm.forward(jp, jnp.asarray(toks))
    got, kv = tm.forward(torch.from_numpy(toks).long())
    assert kv is None
    close(got, want)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_prefill_logits_and_cache(pair, with_lengths):
    jm, jp, tm = pair
    toks = tokens(3, 24, seed=1)
    lens = np.array([24, 5, 17], np.int32)
    jl = jnp.asarray(lens) if with_lengths else None
    tl = torch.from_numpy(lens) if with_lengths else None
    want_logits, want_cache = jm.prefill(jp, jnp.asarray(toks), max_len=40,
                                         lengths=jl)
    got_logits, got_cache = tm.prefill(torch.from_numpy(toks).long(),
                                       max_len=40, lengths=tl)
    close(got_logits, want_logits)
    assert set(got_cache) == set(want_cache) == {"k", "v"}
    for name in ("k", "v"):
        assert tuple(got_cache[name].shape) == want_cache[name].shape
        close(got_cache[name], want_cache[name])


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_step(pair, per_slot):
    """Two decode steps from a prefilled cache, with one shared position or
    a [B] vector of per-slot positions (ragged decode)."""
    jm, jp, tm = pair
    toks = tokens(2, 16, seed=2)
    _, jc = jm.prefill(jp, jnp.asarray(toks), max_len=24)
    _, tc = tm.prefill(torch.from_numpy(toks).long(), max_len=24)
    for step, nxt in enumerate(([[3], [7]], [[11], [2]])):
        pos = [16 + step, 9 + step] if per_slot else 16 + step
        nxt = np.asarray(nxt, np.int32)
        want, jc = jm.decode_step(jp, jc, jnp.asarray(nxt),
                                  jnp.asarray(pos, jnp.int32))
        t_pos = torch.tensor(pos) if per_slot else pos
        got, tc2 = tm.decode_step(tc, torch.from_numpy(nxt).long(), t_pos)
        assert tc2 is tc                      # the cache is updated in place
        close(got, want)
        for name in ("k", "v"):
            close(tc[name], jc[name])


@pytest.mark.parametrize("variant", [
    {"parallel_block": True},
    {"qk_norm": True},
    {"tie_embeddings": True, "vocab_size": 500},    # padded-vocab mask
    {"act": "gelu", "mlp_bias": True, "qkv_bias": False},
])
def test_dense_family_switches_match_jax(variant):
    """The dense-family options glm4 leaves off, each against JAX."""
    jcfg = dataclasses.replace(reduced(jax_config), **variant)
    cfg = dataclasses.replace(reduced(get_config), **variant)
    jm = jax_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(2))
    jp = jax.tree.map(lambda a: a + 0.05, jp)     # non-trivial norms/biases
    tm = get_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    toks = tokens(2, 16, seed=5) % cfg.vocab_size
    want, _ = jm.prefill(jp, jnp.asarray(toks))
    got, _ = tm.prefill(torch.from_numpy(toks).long())
    close(got, want)


def test_registry_swap_keeps_outputs(pair):
    """Mirror of tests/test_kernels.py::test_kernel_registry_integration:
    installing the flash kernel at the ``attention`` site changes the
    model's attention path but not its outputs."""
    _, _, tm = pair
    toks = torch.from_numpy(tokens(2, 32, seed=3)).long()
    base, _ = tm.forward(toks)
    calls = []

    def impl(q, k, v, causal=True, softcap=0.0):
        calls.append(q.shape[1])
        return flash_attention(q, k, v, causal=causal, softcap=softcap,
                               device="cpu")

    epoch = ops.registry_epoch()
    with ops.use_impl("attention", impl):
        swapped, _ = tm.forward(toks)
    assert calls == [32] * tm.cfg.n_layers
    assert ops.registry_epoch() == epoch + 2      # install + rollback
    np.testing.assert_allclose(base.numpy(), swapped.numpy(), rtol=5e-3,
                               atol=5e-3)


def classify(a: np.ndarray):
    if np.all(a == 1):
        return "ones"
    if np.all(a == 0):
        return "zeros"
    return "normal"


def test_init_params_follows_the_jax_rule():
    """Same rule per parameter name as JAX ``init_params`` (ones, zeros, or
    normal with std 1/sqrt(fan_in)), not the same bits.  A sample std of n
    draws has relative spread ~1/sqrt(2n); 5 of those are allowed."""
    cfg = reduced(get_config)
    tm = get_model(cfg, device="cpu")
    tm.init_params(torch.Generator().manual_seed(0))
    jp = jax_model(reduced(jax_config)).init_params(jax.random.PRNGKey(0))
    jflat = {f"layers.{i}.{k}": np.asarray(v[i])
             for k, v in jp["layers"].items() for i in range(cfg.n_layers)}
    jflat.update({f"top.{k}": np.asarray(v) for k, v in jp.items()
                  if k != "layers"})
    sd = tm.state_dict()
    assert set(sd) == set(jflat)
    assert init_rule("final_ln", (64,)) == ("normal", 1 / 8)   # the quirk
    for name, t in sd.items():
        kind, std = init_rule(name.rsplit(".", 1)[-1], tuple(t.shape))
        a, j = t.numpy(), jflat[name]
        assert classify(a) == classify(j) == kind, name
        if kind == "normal":
            slack = 5 / math.sqrt(2 * a.size)
            assert abs(a.std() / std - 1) < slack, (name, a.std(), std)
            assert abs(j.std() / std - 1) < slack, (name, j.std(), std)


def test_bf16_conversion_is_bit_exact():
    cfg = get_config("glm4-9b").reduced()            # bfloat16 params
    jp = jax_model(jax_config("glm4-9b").reduced()).init_params(
        jax.random.PRNGKey(1))
    sd = params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    tm = get_model(cfg, device="cpu")
    tm.load_state_dict(sd)
    got = tm.layers[1].wq.view(torch.int16).numpy()
    want = np.asarray(jp["layers"]["wq"][1]).view(np.int16)
    np.testing.assert_array_equal(got, want)
    assert tm.top.embed.dtype == torch.bfloat16


@pytest.mark.parametrize("family", ["encdec"])
def test_other_families_name_their_roadmap_item(family):
    """``LM`` refuses the encoder–decoder family and names the factory
    that builds its model; without an encoder that model refuses too."""
    cfg = dataclasses.replace(get_config("glm4-9b").reduced(), family=family)
    with pytest.raises(ValueError, match="get_model builds"):
        LM(cfg, device="cpu")
    with pytest.raises(ValueError, match="with an encoder"):
        get_model(cfg, device="cpu")


def test_flash_impl_partial_is_a_site_impl(pair):
    """The form chip_smoke.py installs: the wrapper itself at the site."""
    jm, jp, tm = pair
    toks = tokens(1, 20, seed=4)
    want, _ = jm.prefill(jp, jnp.asarray(toks))
    with ops.use_impl("attention", functools.partial(flash_attention,
                                                     device="cpu")):
        got, _ = tm.prefill(torch.from_numpy(toks).long())
    close(got, want)
