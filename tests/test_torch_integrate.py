"""Reintegration (``repro_torch.core.integrate``): the ``attention_prefill``
winner spliced into reduced glm4-9b (float32) at the ``attention`` site,
against the JAX package's forward on the same weights
(``params_from_jax``) and tokens.

Tolerance 1e-5 (absolute and relative) on the hidden states: both sides
run the same f32 arithmetic in another order (differences seen ~1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.kernelcase import get_case as jget_case
from repro.models import get_model as jax_model
from repro_torch.configs import get_config
from repro_torch.core import (H100ModelPlatform, HeuristicProposer,
                              MEPConstraints, OptConfig, TorchCPUPlatform,
                              get_case, integrate, optimize)
from repro_torch.core.fe import as_tensors, to_numpy
from repro_torch.core import datagen
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This file times torch builds on the CPU: keep them on one core, off
    the cores that parallel test workers time on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduced(get):
    return dataclasses.replace(get("glm4-9b").reduced(), param_dtype="float32")


@pytest.fixture(scope="module")
def pair():
    jm = jax_model(reduced(jax_config))
    jp = jm.init_params(jax.random.PRNGKey(0))
    cfg = reduced(get_config)
    tm = get_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    return jm, jp, tm, toks.astype(np.int32)


@pytest.fixture(autouse=True)
def _clean_registry():
    ops.clear_all()
    yield
    ops.clear_all()


def make_step(model):
    return lambda: (lambda toks: model.forward(toks)[0])


def test_attention_prefill_matches_jax_case():
    case, jcase = get_case("attention_prefill"), jget_case("attention_prefill")
    assert (case.app_site, case.variant_space, case.baseline_variant,
            case.scales) == (jcase.app_site, jcase.variant_space,
                             jcase.baseline_variant, jcase.scales)
    arrs = datagen.generate(case.input_specs(256), 3)
    want = np.asarray(jcase.ref(*[jnp.asarray(a) for a in arrs]))
    x = as_tensors(arrs, "cpu")
    for v in (case.baseline_variant,
              {"chunked": True, "block_q": 128, "block_k": 64,
               "compute_dtype": "f32"}):
        jgot = np.asarray(jcase.build(v, impl="jnp")(
            *[jnp.asarray(a) for a in arrs]))
        for impl in ("torch", "cuda"):
            got = to_numpy(case.build(v, impl=impl)(*x))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("platform", ["torch-cpu", "h100-model"])
def test_integrated_speedup_on_reduced_glm4(pair, platform):
    """Optimize on the platform, reintegrate the winner's build for that
    platform (torch on torch-cpu; the K2 wrapper, through its plain
    version on CPU tensors, on h100-model), and hold the model with the
    winner installed against the JAX forward."""
    jm, jp, tm, toks = pair
    p = TorchCPUPlatform() if platform == "torch-cpu" \
        else H100ModelPlatform(device="cpu")
    case = get_case("attention_prefill")
    res = optimize(case, p, HeuristicProposer(0, None, p.name),
                   cfg=OptConfig(d_rounds=2, n_candidates=2, r=3, k=0),
                   constraints=MEPConstraints(t_max_s=1.0, r=3, k=0))
    assert res.best_time_s <= res.baseline_time_s
    targs = (torch.from_numpy(toks).long(),)
    ir = integrate.integrated_speedup(case, res.best_variant, make_step(tm),
                                      targs, platform=p, r=3, k=1)
    assert ir.fe_ok and ir.max_abs_err < TOL
    assert ir.site == "attention" and ir.integrated_speedup > 0
    assert ops.get_impl("attention") is None        # uninstalled after

    want, _, _ = jm.forward(jp, jnp.asarray(toks))
    before = flash_attention.launches
    integrate.install(case, res.best_variant, impl=p.impl)
    try:
        with torch.no_grad():
            got = tm.forward(*targs)[0]
    finally:
        integrate.uninstall(case)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert flash_attention.launches == before         # CPU: plain version


def test_install_requires_app_site():
    gemm = get_case("gemm")
    with pytest.raises(ValueError, match="no app_site"):
        integrate.install(gemm, gemm.baseline_variant)
