"""The port's serving engine (repro_torch.serve.decode) against JAX
``generate()`` on reduced glm4-9b in float32, on converted parameters.

Greedy tokens must be equal, token for token.  JAX ``generate()`` is the
reference rather than JAX ``BatchedServer``, whose per-bucket AOT compiles
dominate tests/test_serve_continuous.py's time; prompts of equal length
share one JAX call.
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
from repro.serve import generate as jax_generate
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import BatchedServer, generate

MAX_NEW = 5


def reduced(get):
    return dataclasses.replace(get("glm4-9b").reduced(), param_dtype="float32")


def ragged_prompts(seed=1):
    """8 prompts over 4 lengths: 3 prefill buckets (8, 16, 32) of max_len 64."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32)
            for n in (3, 20, 9, 14, 3, 9, 20, 14)]


@pytest.fixture(scope="module")
def setup():
    """(port model, JAX greedy tokens per prompt)."""
    jm = jax_model(reduced(jax_config))
    jp = jm.init_params(jax.random.PRNGKey(0))
    cfg = reduced(get_config)
    tm = get_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    prompts = ragged_prompts()
    refs = {}
    for n in sorted({len(p) for p in prompts}):
        group = [p for p in prompts if len(p) == n]
        out = jax_generate(jm, jp, jnp.asarray(np.stack(group)),
                           max_new=MAX_NEW)
        for p, row in zip(group, out):
            refs[p.tobytes()] = [int(t) for t in row]
    return tm, prompts, refs


@pytest.fixture(autouse=True)
def _clean_registry():
    ops.clear_all()
    ops.telemetry.reset()
    yield
    ops.clear_all()
    ops.telemetry.reset()


def check(reqs, prompts, refs):
    for r, p in zip(reqs, prompts):
        assert r.done, f"request {r.rid} never finished"
        assert r.tokens == refs[p.tobytes()], (
            f"request {r.rid} (len {len(p)}) diverged: served {r.tokens}, "
            f"JAX generate {refs[p.tobytes()]}")


def test_batched_server_matches_jax_generate(setup):
    tm, prompts, refs = setup
    tel = ops.Telemetry()
    srv = BatchedServer(tm, slots=3, max_len=64, telemetry=tel, device="cpu")
    reqs = [srv.submit(p, max_new=MAX_NEW) for p in prompts]
    fin = srv.run()
    check(reqs, prompts, refs)
    assert sorted(r.rid for r in fin) == list(range(len(prompts)))
    assert {r.bucket for r in reqs} == {8, 16, 32}
    assert set(tel.site_buckets("attention")) == {8, 16, 32}
    assert tel.tokens("attention", kind="decode") == len(prompts) * (MAX_NEW - 1)
    assert srv.swap_epochs == 0


def test_generate_matches_jax_generate(setup):
    tm, prompts, refs = setup
    group = [p for p in prompts if len(p) == 9]
    got = generate(tm, np.stack(group), max_new=MAX_NEW, device="cpu")
    assert got.shape == (2, MAX_NEW) and got.dtype == np.int32
    for p, row in zip(group, got):
        assert [int(t) for t in row] == refs[p.tobytes()]


def test_mid_traffic_install_bumps_swap_epoch_keeps_outputs(setup):
    tm, prompts, refs = setup
    srv = BatchedServer(tm, slots=2, max_len=64, device="cpu")
    reqs = [srv.submit(p, max_new=MAX_NEW) for p in prompts]
    srv.step()
    srv.step()                     # requests in flight, partially decoded
    assert any(r.tokens and not r.done for r in reqs)
    calls = []

    def impl(q, k, v, causal=True, softcap=0.0):
        calls.append(q.shape)
        return flash_attention(q, k, v, causal=causal, softcap=softcap,
                               device="cpu")

    ops.install("attention", impl)
    srv.run()
    assert srv.swap_epochs == 1
    assert calls, "later prefills went through the installed impl"
    check(reqs, prompts, refs)


def test_eos_and_slot_churn_match_port_generate(setup):
    """EOS mid-batch: each served request equals the port's own generate()
    with the same eos_id (pad-with-eos after the first EOS)."""
    tm, prompts, refs = setup
    eos = refs[prompts[0].tobytes()][1]   # request 0 (budget 5) decodes it
    srv = BatchedServer(tm, slots=2, max_len=64, eos_id=eos, device="cpu")
    budgets = [5, 2, 4, 1, 3, 5, 4, 2]
    reqs = [srv.submit(p, max_new=m) for p, m in zip(prompts, budgets)]
    srv.run()
    fired = False
    for r, p, m in zip(reqs, prompts, budgets):
        want = [int(t) for t in generate(tm, p[None], max_new=m, eos_id=eos,
                                         device="cpu")[0]]
        assert r.done
        n = len(r.tokens)
        assert r.tokens == want[:n] and all(t == eos for t in want[n:])
        fired |= n < m
    assert fired, "EOS ended at least one request early"


def test_prompt_longer_than_max_len_is_refused(setup):
    tm, _, _ = setup
    srv = BatchedServer(tm, slots=1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        srv.submit(np.zeros(17, np.int32))


def test_server_installs_the_flash_wrapper_itself(setup):
    """The site impl chip_smoke.py installs (the wrapper, device bound)."""
    tm, prompts, refs = setup
    srv = BatchedServer(tm, slots=4, max_len=64, device="cpu")
    with ops.use_impl("attention", functools.partial(flash_attention,
                                                     device="cpu")):
        reqs = [srv.submit(p, max_new=MAX_NEW) for p in prompts[:4]]
        srv.run()
    check(reqs, prompts[:4], refs)
