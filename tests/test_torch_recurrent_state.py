"""A case build installed at a recurrent site hands prefill its final state.

The ``rwkv_wkv`` and ``mamba_ssd`` builds (``cuda``, ``chunked`` and the
naive sequential one) return the site's output alone when called as the
functional-equivalence check calls them, and ``(output, final state)`` when
the model asks with ``return_state=True``, as it does at its
``rwkv_wkv`` / ``ssm_chunk`` sites during prefill.  Served with each build
installed, reduced rwkv6-7b and hymba-1.5b (float32) decode the tokens the
uninstalled server decodes, request for request; an impl that returns no
state raises at prefill and names its site, instead of handing decode a
state of zeros.  (The JAX package's builds return the output only:
``repro/models/ssm.py`` fills in zeros there; ROADMAP.md queue 3.)
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import get_case
from repro_torch.core.datagen import generate as datagen
from repro_torch.core.fe import as_tensors
from repro_torch.kernels import ops
from repro_torch.models import get_model
from repro_torch.serve import BatchedServer

SITES = {"rwkv6-7b": ("rwkv_wkv", "rwkv_wkv"),
         "hymba-1.5b": ("mamba_ssd", "ssm_chunk")}
# (impl, variant): the naive sequential build, the chunked one (at the
# reduced configs' chunk and at a wider one) and the kernel's (its plain
# version on CPU tensors)
BUILDS = [("torch", {"chunked": False}),
          ("torch", {"chunked": True, "chunk": 8}),
          ("torch", {"chunked": True, "chunk": 32}),
          ("cuda", {"chunked": True, "chunk": 16})]
LENGTHS = (8, 16, 8)
MAX_NEW = 6


@pytest.fixture(autouse=True)
def _clean_registry():
    ops.clear_all()
    ops.telemetry.reset()
    yield
    ops.clear_all()
    ops.telemetry.reset()


def model_of(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    model = get_model(cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    return model


def serve(model):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in LENGTHS]
    srv = BatchedServer(model, slots=2, max_len=32, device="cpu")
    reqs = [srv.submit(p, max_new=MAX_NEW) for p in prompts]
    srv.run()
    assert all(r.done for r in reqs)
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("impl,variant", BUILDS,
                         ids=[f"{i}-{v}" for i, v in BUILDS])
@pytest.mark.parametrize("arch", sorted(SITES))
def test_installed_build_serves_the_control_tokens(arch, impl, variant):
    model = model_of(arch)
    control = serve(model)
    # the control decodes more than one token a request: a decode from a
    # state of zeros would show
    assert all(len(set(t)) > 1 for t in control)
    name, site = SITES[arch]
    case = get_case(name)
    ops.install(site, case.build(dict(case.baseline_variant, **variant),
                                 impl=impl))
    assert serve(model) == control


@pytest.mark.parametrize("impl,variant", BUILDS,
                         ids=[f"{i}-{v}" for i, v in BUILDS])
@pytest.mark.parametrize("name", ["rwkv_wkv", "mamba_ssd"])
def test_build_returns_the_state_only_when_asked(name, impl, variant):
    """The FE path's call gets the output alone; ``return_state=True`` adds
    the final state of the case's plain reference."""
    case = get_case(name)
    fn = case.build(dict(case.baseline_variant, **variant), impl=impl)
    x = as_tensors(datagen(case.input_specs(32), 0), "cpu")
    out = fn(*x)
    assert isinstance(out, torch.Tensor)
    got, state = fn(*x, return_state=True)
    torch.testing.assert_close(got, out)
    ref = case.build(case.baseline_variant)(*x, return_state=True)[1]
    torch.testing.assert_close(state, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", sorted(SITES))
def test_a_stateless_impl_raises_at_prefill_naming_its_site(arch):
    model = model_of(arch)
    name, site = SITES[arch]
    real = get_case(name).build(get_case(name).baseline_variant)

    def stateless(*args, **kw):
        kw.pop("return_state", None)
        return real(*args, **kw)

    ops.install(site, stateless)
    with pytest.raises(RuntimeError, match=f"'{site}'.*no state"):
        serve(model)
    # a forward that keeps no cache needs no state: the output serves
    with torch.no_grad():
        hidden, _ = model.forward(torch.zeros((1, 8), dtype=torch.long))
    assert torch.isfinite(hidden).all()
