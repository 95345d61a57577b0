"""The port's MoE block (``repro_torch.models.layers``: ``moe_param_spec``,
``_moe_capacity``, ``moe_route``, ``moe_block``, ``moe_aux_loss``) against
the JAX package's on reduced qwen2-moe-a2.7b (a shared expert) and
dbrx-132b (none), in float32, on the same numpy inputs and weights.

Both paths of ``moe_block`` are held: decode (S == 1, every expert run and
combined by the gates) and the parallel call (per-expert capacity),
without drops (capacity_factor E / top_k, as tests/test_arch_smoke.py
sets it), at the configs' own 1.25, and at 0.25, where the test proves
that tokens drop.  Tolerance 1e-4 absolute and relative, as
tests/test_torch_lm.py.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import get_model as jax_model
from repro.models import layers as JL
from repro.sharding.ctx import ShardCtx
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import init_rule

TOL = 1e-4
ARCHS = ("qwen2-moe-a2.7b", "dbrx-132b")
# capacity factors: the configs' own, none dropped, many dropped
CAPACITY = {"default": None, "no_drop": "no_drop", "drops": 0.25}


def cfg_pair(arch, capacity=None):
    """(JAX config, port config): reduced ``arch`` in float32 at
    ``capacity`` (None: the config's; "no_drop": E / top_k)."""
    out = []
    for get in (jax_config, get_config):
        cfg = dataclasses.replace(get(arch).reduced(), param_dtype="float32")
        if capacity is not None:
            m = cfg.moe
            cf = m.n_experts / m.top_k if capacity == "no_drop" else capacity
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(m, capacity_factor=float(cf)))
        out.append(cfg)
    return out


def block_params(jcfg, seed=0):
    """One layer's MoE weights, numpy, drawn by the JAX init rule."""
    spec = JL.moe_param_spec(jcfg)
    p = JL.init_from_spec(jax.random.PRNGKey(seed), spec, jnp.float32)
    return {k: np.array(v) for k, v in p.items()}


def inputs(B, S, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def run_both(jcfg, cfg, x, p):
    want = JL.moe_block(jnp.asarray(x), {k: jnp.asarray(v)
                                         for k, v in p.items()},
                        jcfg, ShardCtx.null())
    got = L.moe_block(torch.from_numpy(x),
                      {k: torch.from_numpy(v) for k, v in p.items()}, cfg)
    return got, want


def dropped(x, p, cfg):
    """Tokens over their expert's capacity in a parallel call of ``x``,
    counted from the JAX router (lax.top_k) with numpy."""
    m = cfg.moe
    B, S, _ = x.shape
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x), jnp.asarray(
        p["router"]))
    _, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    ef = np.asarray(eidx).reshape(B, S * m.top_k)
    C = L._moe_capacity(S, m)
    n = 0
    for row in ef:
        counts = {}
        for e in row:
            n += counts.get(e, 0) >= C
            counts[e] = counts.get(e, 0) + 1
    return n


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [False, True])
def test_param_spec_matches_jax(arch, full):
    """Names and shapes, full size and reduced (the JAX spec's logical axes
    are the sharding's and have no twin)."""
    jcfg, cfg = cfg_pair(arch)
    if full:
        jcfg, cfg = jax_config(arch), get_config(arch)
    want = {k: shape for k, (shape, _) in JL.moe_param_spec(jcfg).items()}
    assert L.moe_param_spec(cfg) == want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [1, 7, 16, 64, 256])
@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25, 2.0])
def test_capacity_matches_jax(arch, S, cf):
    m = dataclasses.replace(get_config(arch).moe, capacity_factor=cf)
    jm = dataclasses.replace(jax_config(arch).moe, capacity_factor=cf)
    assert L._moe_capacity(S, m) == JL._moe_capacity(S, jm)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity", CAPACITY)
@pytest.mark.parametrize("S", [1, 16])
def test_moe_block_matches_jax(arch, capacity, S):
    jcfg, cfg = cfg_pair(arch, CAPACITY[capacity])
    p = block_params(jcfg)
    x = inputs(3, S, cfg.d_model)
    got, want = run_both(jcfg, cfg, x, p)
    assert got.shape == want.shape
    close(got, want)
    if S > 1:
        n = dropped(x, p, cfg)
        if capacity == "no_drop":
            assert n == 0
        elif capacity == "drops":
            assert n > 0, "capacity 0.25 must drop tokens"


def test_dropped_tokens_add_zeros_to_the_last_slot():
    """Many tokens to one expert: every one past capacity lands in slot
    C - 1 with zero values.  Adding them keeps the token that holds the
    slot; assigning them would overwrite it with zeros."""
    jcfg, cfg = cfg_pair("dbrx-132b", 0.25)
    p = block_params(jcfg)
    p["router"] = np.zeros_like(p["router"])
    p["router"][:, 0] = 1.0                 # every token prefers expert 0
    x = np.abs(inputs(2, 32, cfg.d_model, seed=3))
    assert dropped(x, p, cfg) > 0
    got, want = run_both(jcfg, cfg, x, p)
    close(got, want)


def test_route_breaks_ties_as_lax_top_k():
    """A zero router ties every expert: lax.top_k takes the lowest indices
    in order, and so must the port."""
    jcfg, cfg = cfg_pair("qwen2-moe-a2.7b")
    p = block_params(jcfg)
    p["router"] = np.zeros_like(p["router"])
    x = inputs(2, 5, cfg.d_model)
    probs, gate, eidx = L.moe_route(torch.from_numpy(x),
                                    {"router": torch.from_numpy(
                                        p["router"])}, cfg.moe)
    jg, je = jax.lax.top_k(jax.nn.softmax(jnp.zeros((2, 5, 4))), 2)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(je))
    close(gate, np.asarray(jg) / np.asarray(jg).sum(-1, keepdims=True))
    for S in (1, 5):
        got, want = run_both(jcfg, cfg, x[:, :S], p)
        close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_matches_jax(arch):
    jcfg, cfg = cfg_pair(arch)
    p = block_params(jcfg)
    x = inputs(2, 16, cfg.d_model)
    want = JL.moe_aux_loss(jnp.asarray(x), {"router": jnp.asarray(
        p["router"])}, jcfg)
    got = L.moe_aux_loss(torch.from_numpy(x),
                         {"router": torch.from_numpy(p["router"])}, cfg)
    close(got, want)


def test_shared_gate_draws_by_the_jax_rule():
    """``ws_gate`` [d, 1] is drawn normal with std 1/sqrt(d), as the JAX
    ``init_from_spec`` draws it (fan-in is the second-to-last axis), and so
    are the stacked experts (fan-in d for we1/we3, d_ff_expert for we2)."""
    cfg = get_config("qwen2-moe-a2.7b")
    d, fe = cfg.d_model, cfg.moe.d_ff_expert
    assert init_rule("ws_gate", (d, 1)) == ("normal", 1 / math.sqrt(d))
    assert init_rule("we1", (60, d, fe)) == ("normal", 1 / math.sqrt(d))
    assert init_rule("we2", (60, fe, d)) == ("normal", 1 / math.sqrt(fe))
    assert init_rule("router", (d, 60)) == ("normal", 1 / math.sqrt(d))
    tm = get_model(cfg_pair("qwen2-moe-a2.7b")[1], device="cpu")
    tm.init_params(torch.Generator().manual_seed(0))
    gate = tm.layers[0].ws_gate
    assert gate.shape == (64, 1)
    assert abs(gate.std().item() * 8 - 1) < 5 / math.sqrt(2 * 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_expert_arrays_convert_bit_exact(arch):
    """The stacked [L, E, ...] expert arrays carry across unchanged."""
    cfg = get_config(arch).reduced()                 # bfloat16 params
    jp = jax_model(jax_config(arch).reduced()).init_params(
        jax.random.PRNGKey(1))
    tm = get_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    names = [n for n in L.moe_param_spec(cfg)]
    assert {"router", "we1", "we2", "we3"} <= set(names)
    for i in range(cfg.n_layers):
        for name in names:
            got = getattr(tm.layers[i], name)
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(),
                np.asarray(jp["layers"][name][i]).view(np.int16))
