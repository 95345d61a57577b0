"""The rest of the decoder-only zoo against the JAX package: the port's
config registry, and the port's ``LM`` on the six configs added with the
MoE family and the other dense-path configs, in float32 at their reduced
sizes, on converted parameters.

* every config (and its ``reduced()``) equals its JAX twin field for
  field; the registry holds the reference's ten;
* forward hidden states, prefill logits and cache (with and without
  per-row lengths), and decode at a shared and at per-slot positions, for
  qwen2-moe-a2.7b and dbrx-132b (their own capacity and none dropped) and
  codeqwen1.5-7b (qkv bias), stablelm-3b (head_dim 80 reduced to 16,
  partial rotary 0.25), command-r-35b (parallel block, tied embeddings)
  and chameleon-34b (vlm, qk-norm): the dense-path switches held in their
  real combinations;
* the port's ``BatchedServer`` serves the JAX ``BatchedServer``'s tokens on
  reduced qwen2-moe-a2.7b and chameleon-34b, and its ``FixedBatchServer``
  the JAX one's on qwen2-moe-a2.7b;
* a moe prompt padded to its bucket drops fewer tokens than alone, on both
  sides (the JAX serving docstring calls packed prefill exact; for moe it
  is not, and the port mirrors the reference).

Tolerance 1e-4 absolute and relative, as tests/test_torch_lm.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import get_config as jax_config
from repro.configs import list_archs as jax_list_archs
from repro.models import get_model as jax_model
from repro.serve import BatchedServer as JBatchedServer
from repro.serve import FixedBatchServer as JFixedBatchServer
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import ops
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm import layer_spec
from repro_torch.serve import BatchedServer, FixedBatchServer

TOL = 1e-4
NEW = ("qwen2-moe-a2.7b", "dbrx-132b", "codeqwen1.5-7b", "stablelm-3b",
       "command-r-35b", "chameleon-34b")
# (arch, capacity): the moe configs at their own capacity factor and at
# E / top_k, where no token drops
MODELS = [(a, None) for a in NEW] + [(a, "no_drop") for a in NEW[:2]]


def reduced(get, arch, capacity=None):
    cfg = dataclasses.replace(get(arch).reduced(), param_dtype="float32")
    if capacity == "no_drop":
        m = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))
    return cfg


@functools.lru_cache(maxsize=None)
def pair(arch, capacity=None):
    """(jax model, jax params, port model) with the same weights; norms and
    biases moved off their ones and zeros."""
    jm = jax_model(reduced(jax_config, arch, capacity))
    jp = jax.tree.map(lambda a: a + 0.05,
                      jm.init_params(jax.random.PRNGKey(0)))
    cfg = reduced(get_config, arch, capacity)
    tm = get_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


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


def test_registry_is_the_reference_less_whisper():
    """Since whisper-medium's port the registry is the reference's whole:
    its ten configs in its order."""
    assert list_archs() == jax_list_archs()
    assert len(list_archs()) == 10


@pytest.mark.parametrize("arch", list(JAX_REGISTRY))
def test_config_equals_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_config(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(jax_config(arch).reduced())
    assert get_config(arch).param_counts() == jax_config(arch).param_counts()


@pytest.mark.parametrize("arch", [a for a in JAX_REGISTRY
                                  if a != "whisper-medium"])
def test_layer_spec_matches_jax_at_full_size(arch):
    """The full config's layer layout (no allocation on either side), and
    the reduced model builds."""
    want = {k: shape for k, (shape, _) in
            jax_model(jax_config(arch)).layer_spec().items()}
    assert layer_spec(get_config(arch)) == want
    tm = get_model(get_config(arch).reduced(), device="cpu")
    assert len(tm.layers) == 2


@pytest.mark.parametrize("arch,capacity", MODELS)
def test_forward_hidden_states(arch, capacity):
    jm, jp, tm = pair(arch, capacity)
    toks = tokens(2, 32)
    want, _, _ = jm.forward(jp, jnp.asarray(toks))
    got, _ = tm.forward(torch.from_numpy(toks).long())
    close(got, want)


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("arch,capacity", MODELS)
def test_prefill_logits_and_cache(arch, capacity, with_lengths):
    jm, jp, tm = pair(arch, capacity)
    toks = tokens(3, 24, seed=1)
    lens = np.array([24, 5, 17], np.int32)
    want_logits, want_cache = jm.prefill(
        jp, jnp.asarray(toks), max_len=40,
        lengths=jnp.asarray(lens) if with_lengths else None)
    got_logits, got_cache = tm.prefill(
        torch.from_numpy(toks).long(), max_len=40,
        lengths=torch.from_numpy(lens) if with_lengths else None)
    close(got_logits, want_logits)
    assert set(got_cache) == set(want_cache) == {"k", "v"}
    for name in ("k", "v"):
        assert tuple(got_cache[name].shape) == want_cache[name].shape
        close(got_cache[name], want_cache[name])


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("arch,capacity", MODELS)
def test_decode_steps(arch, capacity, per_slot):
    """Three decode steps from a prefilled cache, at one shared position or
    at per-slot positions (ragged decode)."""
    jm, jp, tm = pair(arch, capacity)
    toks = tokens(2, 16, seed=2)
    _, jc = jm.prefill(jp, jnp.asarray(toks), max_len=24)
    _, tc = tm.prefill(torch.from_numpy(toks).long(), max_len=24)
    for step, nxt in enumerate(([[3], [7]], [[11], [2]], [[5], [9]])):
        pos = [16 + step, 9 + step] if per_slot else 16 + step
        nxt = np.asarray(nxt, np.int32)
        want, jc = jm.decode_step(jp, jc, jnp.asarray(nxt),
                                  jnp.asarray(pos, jnp.int32))
        got, tc = tm.decode_step(tc, torch.from_numpy(nxt).long(),
                                 torch.tensor(pos) if per_slot else pos)
        close(got, want)
        for name in ("k", "v"):
            close(tc[name], jc[name])


def ragged_prompts(seed=3):
    """6 prompts over three buckets (8, 16, 32) of max_len 32."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32)
            for n in (3, 20, 9, 14, 3, 30)]


def serve_both(arch, **model_kw):
    """Tokens of the JAX and the port's BatchedServer on the same prompts
    (3 slots, max_len 32, 5 new tokens each)."""
    jcfg, cfg = reduced(jax_config, arch), reduced(get_config, arch)
    jm = jax_model(jcfg, **model_kw)
    jp = jax.tree.map(lambda a: a + 0.05,
                      jm.init_params(jax.random.PRNGKey(0)))
    tm = get_model(cfg, device="cpu", **model_kw)
    tm.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    prompts = ragged_prompts()
    out = []
    for srv in (JBatchedServer(jm, jp, slots=3, max_len=32, aot=False),
                BatchedServer(tm, slots=3, max_len=32, device="cpu")):
        reqs = [srv.submit(p, max_new=5) for p in prompts]
        srv.run()
        assert all(r.done for r in reqs)
        out.append([r.tokens for r in reqs])
    return out


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "chameleon-34b"])
def test_batched_server_matches_jax_batched_server(arch):
    want, got = serve_both(arch)
    assert got == want


def test_fixed_batch_server_matches_jax_on_moe():
    """The table-9 baseline on qwen2-moe-a2.7b: one prefill a request at
    its own length (no padding), one shared decode position."""
    jm, jp, tm = pair("qwen2-moe-a2.7b")
    prompts = [tokens(1, 8, seed=30 + i)[0] for i in range(4)]
    out = []
    for srv in (JFixedBatchServer(jm, jp, slots=2, max_len=32, prompt_len=8),
                FixedBatchServer(tm, slots=2, max_len=32, prompt_len=8,
                                 device="cpu")):
        reqs = [srv.submit(p, max_new=5) for p in prompts]
        srv.run()
        assert all(r.done for r in reqs)
        out.append([r.tokens for r in reqs])
    assert out[1] == out[0]


def test_moe_padding_to_the_bucket_changes_capacity():
    """A prompt of 9 tokens drops tokens at its own length (capacity 8 a
    layer's expert) and none padded to its bucket of 16 (capacity 12), so
    its packed prefill differs from its prefill alone, in JAX and in the
    port alike; each side's two logits agree with the other side's."""
    jm, jp, tm = pair("qwen2-moe-a2.7b")
    cfg = tm.cfg
    seen = []
    real = L.moe_block

    def counting(x, p, cfg_):
        _, _, eidx = L.moe_route(x, p, cfg_.moe)
        C = L._moe_capacity(x.shape[1], cfg_.moe)
        onehot = torch.nn.functional.one_hot(
            eidx.reshape(x.shape[0], -1), cfg_.moe.n_experts)
        pos = ((onehot.cumsum(1) - onehot) * onehot).sum(-1)
        seen.append(int((pos[:, :9 * cfg_.moe.top_k] >= C).sum()))
        return real(x, p, cfg_)

    prompt = None
    for seed in range(64):            # the first prompt showing the fact
        cand = tokens(1, 9, seed=100 + seed)
        padded = np.pad(cand, ((0, 0), (0, 7)))
        seen.clear()
        L.moe_block = counting
        try:
            alone, _ = tm.prefill(torch.from_numpy(cand).long())
            alone_drops = sum(seen)
            seen.clear()
            packed, _ = tm.prefill(torch.from_numpy(padded).long(),
                                   lengths=torch.tensor([9]))
            packed_drops = sum(seen)
        finally:
            L.moe_block = real
        if alone_drops > 0 and packed_drops == 0:
            prompt = cand
            break
    assert prompt is not None, "no 9-token prompt drops alone and not padded"
    j_alone, _ = jm.prefill(jp, jnp.asarray(prompt))
    j_packed, _ = jm.prefill(jp, jnp.asarray(padded),
                             lengths=jnp.asarray([9], jnp.int32))
    close(alone, j_alone)
    close(packed, j_packed)
    gap = np.abs(np.asarray(j_alone) - np.asarray(j_packed)).max()
    assert gap > 1e-3, gap
    assert (alone - packed).abs().max().item() > 1e-3
    assert L._moe_capacity(9, cfg.moe) == 8
    assert L._moe_capacity(16, cfg.moe) == 12
