"""Hotspot extraction on the port (``core/extraction.py``) against the
JAX package's jaxpr walker: ``tests/test_core_mep.py``'s extraction test
mirrored, the product FLOPs of ``loss`` by (family, splice point) equal to
the reference's, and a train step's backward products counted and marked.

The recurrent einsums with three operands are contracted in another order
than XLA's (torch's ``einsum`` pairs them by opt_einsum where it is
installed, else left to right), so rwkv6-7b's and hymba-1.5b's
``rwkv_wkv / ssm_chunk`` FLOPs differ from the reference's; the test
states the difference it finds and requires the site and every other
family equal.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import extraction as jx
from repro.models import get_model as jax_model
from repro_torch.configs import get_config
from repro_torch.core import extraction
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax
from repro_torch.train import (AdamWConfig, init_state, make_train_step,
                               model_params)

B, S = 2, 32


def models(arch):
    jcfg = dataclasses.replace(jax_config(arch).reduced(),
                               param_dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    jm = jax_model(jcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    model = get_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray,
                                                            params)))
    rng = np.random.default_rng(1)
    host = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    host["targets"] = host["tokens"]
    if cfg.family == "encdec":
        host["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return (jm, params, {k: jnp.asarray(v) for k, v in host.items()},
            model, {k: torch.from_numpy(v) for k, v in host.items()})


def by_family(spots, products):
    out = collections.Counter()
    for s in spots:
        if s.primitive in products:
            out[(s.family, s.suggested_site)] += s.flops
    return dict(out)


def test_hotspot_extraction_finds_attention_and_matmuls():
    """Paper §3.1, as the reference's test: the layer products and the
    attention products ranked, the splice point of the attention hotspot
    suggested, each layer's product counted once a layer."""
    cfg = dataclasses.replace(get_config("glm4-9b").reduced(),
                              param_dtype="float32")
    model = get_model(cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        spots = extraction.profile_hotspots(
            model.loss, {"tokens": toks, "targets": toks}, top=10)
    assert spots[0].primitive in extraction.PRODUCTS
    assert any(s.family == "attention" and s.suggested_site == "attention"
               for s in spots)
    # the Python layer loop: layer products were counted n_layers times
    assert max(s.count for s in spots) >= cfg.n_layers
    assert all(s.count % cfg.n_layers == 0 for s in spots
               if "layers.py" in s.source or s.family == "attention")
    rep = extraction.report(spots)
    assert "splice point" in rep


@pytest.mark.parametrize("arch", ["glm4-9b", "stablelm-3b",
                                  "qwen2-moe-a2.7b", "whisper-medium"])
def test_loss_product_flops_by_family_equal_the_reference(arch):
    jm, params, jb, model, pb = models(arch)
    want = by_family(jx.profile_hotspots(jm.loss, params, jb, top=10_000),
                     {"dot_general"})
    with torch.no_grad():
        spots = extraction.profile_all(model.loss, pb)
    got = by_family(spots, extraction.PRODUCTS)
    assert got == want
    assert not any(s.backward for s in spots)
    if arch == "qwen2-moe-a2.7b":
        assert ("matmul", "moe_gemm") in got


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_recurrent_site_found(arch):
    jm, params, jb, model, pb = models(arch)
    want = by_family(jx.profile_hotspots(jm.loss, params, jb, top=10_000),
                     {"dot_general"})
    with torch.no_grad():
        got = by_family(extraction.profile_all(model.loss, pb),
                        extraction.PRODUCTS)
    site = ("scan", "rwkv_wkv / ssm_chunk")
    assert got[site] > 0 and want[site] > 0
    assert {k: v for k, v in got.items() if k != site} == \
        {k: v for k, v in want.items() if k != site}
    print(f"{arch}: {site[1]} FLOPs {got[site]:.0f} here, {want[site]:.0f} "
          f"in the reference ({got[site] / want[site] - 1:+.1%}, three-operand "
          "einsum order)")
    assert abs(got[site] / want[site] - 1) < 0.1


def test_train_step_backward_products_are_counted_and_marked():
    """A train step's products: the forward's, and in the backward pass
    two of each forward product's size (its operands' gradients) plus the
    layer products remat recomputes, named as in the forward (the recompute
    stops at the last product whose output the backward needs, so a
    layer's last product runs twice, the others three times); the
    backward of the attention products keeps the attention family."""
    cfg = dataclasses.replace(get_config("glm4-9b").reduced(),
                              param_dtype="float32")
    model = get_model(cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "targets": toks}
    params = model_params(model)
    step = make_train_step(model, AdamWConfig())
    spots = extraction.profile_all(step, params, init_state(params), batch)
    with torch.no_grad():
        fwd = extraction.profile_all(model.loss, batch)
    flops = collections.defaultdict(lambda: [0.0, 0.0])
    for s in spots:
        flops[s.source][s.backward] += s.flops
    want = collections.Counter()
    for s in fwd:
        want[s.source] += s.flops
    assert {src: f for src, (f, _) in flops.items()} == dict(want)
    for src, (forward, backward) in flops.items():
        runs = backward / forward
        assert runs == 2 if "logits_fn" in src else runs in (2, 3), src
    assert sorted(r for src, (f, b) in flops.items()
                  if "layers.py:" in src for r in [b / f]).count(2) == 1
    assert any(s.backward and s.family == "attention"
               and s.suggested_site == "attention" for s in spots)
    assert "(backward)" in extraction.report(spots)
    assert not any(p.requires_grad for p in params.values())
