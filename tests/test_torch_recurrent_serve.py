"""The port's serving engine on the recurrent families against JAX
``generate()``: reduced rwkv6-7b and hymba-1.5b in float32 on converted
parameters, with exact-length packing.

Greedy tokens must be equal, token for token (as
``tests/test_serve_continuous.py:155-180`` holds the JAX server).  Prompt
lengths are at most one chunk (8) or a multiple of it: the plain chunked
paths of both packages refuse any other length.
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
from repro_torch.kernels.rwkv_wkv import wkv
from repro_torch.kernels.ssd_scan import ssd
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import BatchedServer, generate

MAX_NEW = 4
LENGTHS = (3, 3, 16, 8, 8, 5, 24, 16)


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(port model, JAX greedy tokens per prompt, prompts)."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(),
                               param_dtype="float32")
    jm = jax_model(jcfg)
    jp = jax.tree.map(lambda a: a + 0.05,
                      jm.init_params(jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    tm = get_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in LENGTHS]
    refs = {}
    for n in sorted(set(LENGTHS)):
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


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_batched_server_packs_exact_lengths_and_matches_jax(arch):
    tm, prompts, refs = setup(arch)
    srv = BatchedServer(tm, slots=3, max_len=40, device="cpu")
    assert not srv.padded_packing and srv.buckets == ()
    prefills = []
    real = tm.prefill

    def spy(toks, *a, **kw):
        prefills.append(tuple(toks.shape))
        return real(toks, *a, **kw)

    tm.prefill = spy
    try:
        reqs = [srv.submit(p, max_new=MAX_NEW) for p in prompts]
        srv.run()
    finally:
        del tm.prefill
    check(reqs, prompts, refs)
    assert [r.bucket for r in reqs] == list(LENGTHS)
    # every packed prefill holds rows of one true length, no pad tail; the
    # first wave packs the two prompts of length 3 into one call
    assert {s for _, s in prefills} <= set(LENGTHS)
    assert prefills[0] == (2, 3)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_server_through_the_kernel_sites_matches_jax(arch):
    """The site impls chip_smoke.py installs (K6, or K7 and K2), their
    plain versions on the CPU: prefill continues from their final state."""
    tm, prompts, refs = setup(arch)
    sites = ({"rwkv_wkv": functools.partial(wkv, device="cpu")}
             if arch == "rwkv6-7b" else
             {"ssm_chunk": functools.partial(ssd, device="cpu"),
              "attention": functools.partial(flash_attention, device="cpu")})
    for site, fn in sites.items():
        ops.install(site, fn)
    srv = BatchedServer(tm, slots=4, max_len=40, device="cpu")
    reqs = [srv.submit(p, max_new=MAX_NEW) for p in prompts]
    srv.run()
    check(reqs, prompts, refs)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_generate_matches_jax_generate(arch):
    tm, prompts, refs = setup(arch)
    group = [p for p in prompts if len(p) == 16]
    got = generate(tm, np.stack(group), max_new=MAX_NEW, device="cpu")
    for p, row in zip(group, got):
        assert [int(t) for t in row] == refs[p.tobytes()]


def test_exact_length_packing_refuses_a_prompt_past_max_len():
    tm, _, _ = setup("rwkv6-7b")
    srv = BatchedServer(tm, slots=1, max_len=16, device="cpu")
    assert srv.bucket_of(13) == 13
    with pytest.raises(ValueError, match="exceeds max_len=16"):
        srv.submit(np.zeros(17, np.int32))


def test_recurrent_cache_rows_are_spliced_into_their_slots():
    """A prefill of two rows lands in slots 2 and 0 of a 3-slot pool: each
    recurrent-state entry of the pool equals that row's own prefill."""
    tm, prompts, _ = setup("hymba-1.5b")
    srv = BatchedServer(tm, slots=3, max_len=40, device="cpu")
    toks = np.stack([prompts[0], prompts[1]])             # both length 3
    srv._prefill(toks, np.array([3, 3]), np.array([2, 0]))
    for row, slot in ((0, 2), (1, 0)):
        _, one = tm.prefill(torch.from_numpy(toks[row:row + 1]).long(),
                            max_len=40)
        for name in ("conv", "ssm", "k", "v"):
            torch.testing.assert_close(srv.cache[name][:, slot],
                                       one[name][:, 0], rtol=1e-5, atol=1e-5)
