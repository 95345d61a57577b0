"""The port's LM on the recurrent families against the JAX package's LM:
reduced rwkv6-7b (ssm) and hymba-1.5b (hybrid) in float32, starting from
JAX ``init_params`` (shifted by 0.05, so zero-initialised parameters such
as RWKV's bonus ``u`` take part) converted by ``params_from_jax``.

Tolerance 1e-4 (absolute and relative) on logits, caches and states: both
sides run the same f32 arithmetic in another order (differences seen
~1e-6 on logits, ~1e-5 on the recurrent states).
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
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rwkv_wkv import wkv
from repro_torch.kernels.ssd_scan import ssd
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import init_rule
from repro_torch.models.lm import layer_spec, top_spec

TOL = 1e-4
ARCHS = ("rwkv6-7b", "hymba-1.5b")
STATE_KEYS = {"rwkv6-7b": {"wkv", "shift_tm", "shift_cm"},
              "hymba-1.5b": {"k", "v", "conv", "ssm"}}


def reduced(get, arch):
    return dataclasses.replace(get(arch).reduced(), param_dtype="float32")


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(jax model, jax params, port model) with the same weights."""
    jm = jax_model(reduced(jax_config, arch))
    jp = jax.tree.map(lambda a: a + 0.05,
                      jm.init_params(jax.random.PRNGKey(0)))
    cfg = reduced(get_config, arch)
    tm = get_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


@pytest.fixture(autouse=True)
def _clean_registry():
    ops.clear_all()
    yield
    ops.clear_all()


def kernel_sites(arch):
    """The site impls chip_smoke.py installs, bound to the CPU: the K6/K7
    wrappers (their plain versions here) and, for hymba, K2."""
    if arch == "rwkv6-7b":
        return {"rwkv_wkv": functools.partial(wkv, device="cpu")}
    return {"ssm_chunk": functools.partial(ssd, device="cpu"),
            "attention": functools.partial(flash_attention, device="cpu")}


def tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                                np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_states(arch):
    jm, jp, tm = pair(arch)
    toks = tokens(2, 16)
    want, _, _ = jm.forward(jp, jnp.asarray(toks))
    got, caches = tm.forward(torch.from_numpy(toks).long())
    assert caches is None
    close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [16, 5])         # a chunk multiple, one chunk
def test_prefill_logits_and_cache(arch, S):
    jm, jp, tm = pair(arch)
    toks = tokens(3, S, seed=1)
    want_logits, want_cache = jm.prefill(jp, jnp.asarray(toks), max_len=24)
    got_logits, got_cache = tm.prefill(torch.from_numpy(toks).long(),
                                       max_len=24)
    close(got_logits, want_logits)
    assert set(got_cache) == set(want_cache) == STATE_KEYS[arch]
    for name in want_cache:
        assert tuple(got_cache[name].shape) == want_cache[name].shape
        assert str(got_cache[name].dtype).replace("torch.", "") == \
            str(want_cache[name].dtype)
        close(got_cache[name], want_cache[name])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_steps(arch, per_slot):
    """Three decode steps from a prefilled cache, with one shared position
    or a [B] vector of per-slot positions (ragged decode); the cache,
    recurrent state included, is updated in place."""
    jm, jp, tm = pair(arch)
    toks = tokens(2, 8, seed=2)
    _, jc = jm.prefill(jp, jnp.asarray(toks), max_len=16)
    _, tc = tm.prefill(torch.from_numpy(toks).long(), max_len=16)
    for step, nxt in enumerate(([[3], [7]], [[11], [2]], [[5], [5]])):
        pos = [8 + step, 4 + step] if per_slot else 8 + step
        nxt = np.asarray(nxt, np.int32)
        want, jc = jm.decode_step(jp, jc, jnp.asarray(nxt),
                                  jnp.asarray(pos, jnp.int32))
        t_pos = torch.tensor(pos) if per_slot else pos
        got, tc2 = tm.decode_step(tc, torch.from_numpy(nxt).long(), t_pos)
        assert tc2 is tc
        close(got, want)
        for name in jc:
            close(tc[name], jc[name])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [16, 13])
def test_prefill_through_the_kernel_sites(arch, S):
    """The form chip_smoke.py installs: K6 (rwkv) or K7 and K2 (hymba) at
    their sites, the plain versions standing in on the CPU.  Logits equal
    the chunked path's; the final state is the chunked path's, not the
    zeros a stateless impl gets.  S = 13 does not divide the chunk (8):
    the chunked path refuses it, the kernels take it, and JAX's sequential
    decode from the same prompt is the reference."""
    jm, jp, tm = pair(arch)
    toks = tokens(2, S, seed=3)
    for site, fn in kernel_sites(arch).items():
        ops.install(site, fn)
    got_logits, got_cache = tm.prefill(torch.from_numpy(toks).long(),
                                       max_len=S + 2)
    ops.clear_all()
    state = "wkv" if arch == "rwkv6-7b" else "ssm"
    assert got_cache[state].abs().max() > 0.1
    if S % tm.cfg.ssm.chunk == 0:
        want_logits, want_cache = jm.prefill(jp, jnp.asarray(toks),
                                             max_len=S + 2)
    else:
        # JAX: prefill the first 8 tokens, decode the other 5 one by one
        c = tm.cfg.ssm.chunk
        _, want_cache = jm.prefill(jp, jnp.asarray(toks[:, :c]),
                                   max_len=S + 2)
        for t in range(c, S):
            want_logits, want_cache = jm.decode_step(
                jp, want_cache, jnp.asarray(toks[:, t:t + 1]),
                jnp.asarray(t, jnp.int32))
    close(got_logits, want_logits)
    for name in want_cache:
        close(got_cache[name], want_cache[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_match_the_jax_tree(arch):
    """At full size, without allocating: the same names and shapes as the
    JAX parameter tree (hymba ties its embeddings: no lm_head on either
    side), hence the same count.  The config's ``param_counts`` leaves
    terms out (RWKV's decay LoRA, mixes and group norm; the mamba conv and
    dt projection; the branch norms)."""
    cfg = get_config(arch)
    abstract = jax_model(jax_config(arch)).abstract_params()
    spec = {**{f"layers.{n}": s for n, s in layer_spec(cfg).items()},
            **{f"top.{n}": s for n, s in top_spec(cfg).items()}}
    jspec = {**{f"layers.{n}": tuple(a.shape[1:])
                for n, a in abstract["layers"].items()},
             **{f"top.{n}": tuple(a.shape)
                for n, a in abstract.items() if n != "layers"}}
    assert spec == jspec
    assert ("top.lm_head" in spec) == (arch == "rwkv6-7b")
    n = sum(int(np.prod(s)) * (cfg.n_layers if k.startswith("layers.")
                               else 1) for k, s in spec.items())
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(abstract))
    assert (n, cfg.param_counts()[0]) == {
        "rwkv6-7b": (7_534_678_016, 7_516_454_912),
        "hymba-1.5b": (1_594_374_400, 1_588_736_000)}[arch]


def classify(a: np.ndarray):
    if np.all(a == 1):
        return "ones"
    if np.all(a == 0):
        return "zeros"
    return "normal"


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_follows_the_jax_rule(arch):
    """Same rule per parameter name as JAX ``init_params`` (ones, zeros,
    or normal with std 1/sqrt(fan_in)), not the same bits; 5 sample-std
    spreads allowed, as for glm4-9b."""
    cfg = reduced(get_config, arch)
    tm = get_model(cfg, device="cpu")
    tm.init_params(torch.Generator().manual_seed(0))
    jp = jax_model(reduced(jax_config, arch)).init_params(
        jax.random.PRNGKey(0))
    jflat = {f"layers.{i}.{k}": np.asarray(v[i])
             for k, v in jp["layers"].items() for i in range(cfg.n_layers)}
    jflat.update({f"top.{k}": np.asarray(v) for k, v in jp.items()
                  if k != "layers"})
    sd = tm.state_dict()
    assert set(sd) == set(jflat)
    for name, t in sd.items():
        kind, std = init_rule(name.rsplit(".", 1)[-1], tuple(t.shape))
        a, j = t.numpy(), jflat[name]
        assert classify(a) == classify(j) == kind, name
        if kind == "normal":
            slack = 5 / np.sqrt(2 * a.size)
            assert abs(a.std() / std - 1) < slack, (name, a.std(), std)


def test_bf16_hymba_conversion_is_bit_exact():
    cfg = get_config("hymba-1.5b").reduced()            # bfloat16 params
    jp = jax_model(jax_config("hymba-1.5b").reduced()).init_params(
        jax.random.PRNGKey(1))
    tm = get_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    got = tm.layers[1].mamba_w_in.view(torch.int16).numpy()
    want = np.asarray(jp["layers"]["mamba_w_in"][1]).view(np.int16)
    np.testing.assert_array_equal(got, want)
    assert not hasattr(tm.top, "lm_head")
