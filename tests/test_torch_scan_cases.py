"""The ``rwkv_wkv`` and ``mamba_ssd`` hotspot cases (paper Table 4) in the
port against the JAX package's, and their reintegration into reduced
rwkv6-7b and hymba-1.5b.

* case metadata (specs, variant space, baseline, cost models, app site)
  equals the JAX case's; every build's output equals the JAX oracle's on
  the same ``datagen`` inputs (1e-4: f32, the recurrences summed in
  another order);
* both packages' ``Evaluator`` give equal FE verdicts and repair records
  on a fixed variant list, with the kernel check on (the Pallas kernels in
  interpret mode against K6/K7's plain versions);
* a winner found on ``h100-model`` is reintegrated at the model's site
  (``rwkv_wkv`` / ``ssm_chunk``) with ``fe_ok``, and the model with it
  installed equals the JAX forward (1e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.aer import AER as JAER
from repro.core.kernelcase import cases as jax_cases
from repro.core.kernelcase import get_case as jget_case
from repro.core.mep import build_mep as jbuild_mep
from repro.core.optimizer import Evaluator as JEvaluator
from repro.core.optimizer import OptConfig as JOptConfig
from repro.core.profiler import TPUModelPlatform
from repro.core.proposer import DirectProposer as JDirectProposer
from repro.models import get_model as jax_model
from repro_torch.configs import get_config
from repro_torch.core import (AER, DirectProposer, Evaluator,
                              H100ModelPlatform, HeuristicProposer,
                              MEPConstraints, OptConfig, build_mep, datagen,
                              get_case, integrate, optimize)
from repro_torch.core.fe import as_tensors, to_numpy
from repro_torch.core.kernelcase import cases
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv_wkv import wkv
from repro_torch.kernels.ssd_scan import ssd
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax

CASES = {"rwkv_wkv": ("rwkv6-7b", wkv), "mamba_ssd": ("hymba-1.5b", ssd)}
FAST = MEPConstraints(t_max_s=2.0, r=5, k=1)
VARIANTS = {
    "rwkv_wkv": [{"chunked": False, "chunk": 64}, {"chunked": True,
                                                   "chunk": 16},
                 {"chunked": True, "chunk": 128}, {"chunked": False,
                                                   "chunk": 32}],
    "mamba_ssd": [{"chunked": False, "chunk": 128}, {"chunked": True,
                                                     "chunk": 32},
                  {"chunked": True, "chunk": 256}, {"chunked": False,
                                                    "chunk": 64}],
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This file times torch builds on the CPU: keep them on one core, off
    the cores that parallel test workers time on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_registry():
    ops.clear_all()
    yield
    ops.clear_all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_scan_case_matches_jax_case(name):
    case, jcase = get_case(name), jget_case(name)
    assert (case.family, case.app_site, case.variant_space,
            case.baseline_variant, case.scales) == \
        (jcase.family, jcase.app_site, jcase.variant_space,
         jcase.baseline_variant, jcase.scales)
    s = case.scales[0]
    assert [(a.shape, a.dtype, a.kind, a.minval, a.maxval)
            for a in case.input_specs(s)] == \
        [(a.shape, a.dtype, a.kind, a.minval, a.maxval)
         for a in jcase.input_specs(s)]
    assert case.flops(s) == jcase.flops(s)
    for v in VARIANTS[name]:
        assert case.generic_traffic(v, s) == jcase.generic_traffic(v, s)
        assert case.variant_latency(v, s) == jcase.variant_latency(v, s)
    arrs = datagen.generate(case.input_specs(s), 3)
    want = np.asarray(jcase.ref(*[jnp.asarray(a) for a in arrs]))
    x = as_tensors(arrs, "cpu")
    launches = CASES[name][1].launches
    for v in VARIANTS[name]:
        for impl in ("torch", "cuda"):
            got = to_numpy(case.build(v, impl=impl)(*x))
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert CASES[name][1].launches == launches     # CPU: plain versions


@pytest.mark.parametrize("name", sorted(CASES))
def test_scan_case_fe_verdicts_equal_jax(name):
    """Both evaluators FE-check the plain build (jnp / torch) and the
    kernel build (Pallas in interpret mode / K6, K7's plain versions) at
    fe_scale 64 on ``datagen`` inputs, then time on their analytic
    platform: the same verdicts and no repairs on either side."""
    cfg_kw = dict(d_rounds=1, n_candidates=1, r=3, k=0, fe_scale=64,
                  fe_input_sets=1)
    jcase, case = jget_case(name), get_case(name)
    scale = case.scales[0]
    jmep = jbuild_mep(jcase, TPUModelPlatform(), constraints=FAST,
                      scale=scale)
    mep = build_mep(case, H100ModelPlatform(device="cpu"), constraints=FAST,
                    scale=scale)
    jev = JEvaluator(jmep, jcase, "tpu-v5e-model", JAER(jcase, scale),
                     JDirectProposer(), JOptConfig(check_pallas=True,
                                                   **cfg_kw))
    ev = Evaluator(mep, case, "h100-model", AER(case, scale),
                   DirectProposer(), OptConfig(check_kernel=True, **cfg_kw))
    for v in VARIANTS[name]:
        j, t = jev.evaluate(dict(v)), ev.evaluate(dict(v))
        assert (t.status, t.variant, t.repairs) == \
            (j.status, j.variant, j.repairs) == ("ok", v, 0), v
    assert ev.aer.records == [] and jev.aer.records == []


@pytest.mark.parametrize("name", sorted(CASES))
def test_integrated_speedup_into_the_reduced_model(name):
    """Optimize on h100-model, reintegrate the winner's ``cuda`` build (the
    K6/K7 wrapper, through its plain version on CPU tensors) into the
    reduced application, and hold its forward against the JAX forward."""
    arch, kernel = CASES[name]
    jcfg = dataclasses.replace(jax_config(arch).reduced(),
                               param_dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    jm = jax_model(jcfg)
    jp = jax.tree.map(lambda a: a + 0.05,
                      jm.init_params(jax.random.PRNGKey(0)))
    tm = get_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (2, 32)).astype(np.int32)
    p = H100ModelPlatform(device="cpu")
    case = get_case(name)
    res = optimize(case, p, HeuristicProposer(0, None, p.name),
                   cfg=OptConfig(d_rounds=2, n_candidates=2, r=3, k=0,
                                 fe_scale=64),
                   constraints=MEPConstraints(t_max_s=1.0, r=3, k=0))
    assert res.best_time_s <= res.baseline_time_s
    targs = (torch.from_numpy(toks).long(),)
    ir = integrate.integrated_speedup(
        case, res.best_variant, lambda: (lambda t: tm.forward(t)[0]), targs,
        platform=p, r=2, k=0)
    assert ir.fe_ok and ir.max_abs_err < 1e-4
    assert ir.site == case.app_site and ops.get_impl(case.app_site) is None

    want, _, _ = jm.forward(jp, jnp.asarray(toks))
    before = kernel.launches
    integrate.install(case, res.best_variant, impl=p.impl)
    try:
        with torch.no_grad():
            got = tm.forward(*targs)[0]
    finally:
        integrate.uninstall(case)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert kernel.launches == before


def test_only_the_moe_case_is_still_unported():
    """The moe case is ported now: the hpc suite holds exactly the JAX
    package's hotspots, and an unknown name is a KeyError."""
    assert get_case("moe_grouped_gemm").app_site == "moe_gemm"
    assert [c.name for c in cases("hpc")] == \
        sorted(c.name for c in jax_cases("hpc")) == [
            "attention_prefill", "mamba_ssd", "moe_grouped_gemm", "rwkv_wkv"]
    with pytest.raises(KeyError, match="no_such_case"):
        get_case("no_such_case")
