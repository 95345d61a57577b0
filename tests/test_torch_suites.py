"""The rest of the paper's suites in the port against the JAX package, on
the CPU: the eight PolyBench cases beyond the matmul family, the eight APP
SDK cases and ``moe_grouped_gemm``.

* each case's metadata (variant space, baseline, scales, input specs,
  flops, traffic, latency) equals the JAX case's;
* each case's ``torch`` and ``cuda`` builds (the latter through K1/K3/K4/
  K5's plain versions here) against the JAX ``jnp`` and ``pallas`` builds
  (Pallas in interpret mode) and the ``ref`` oracle, at a small scale, over
  the baseline, the restructured variants and both dtypes where the space
  has them; every build also passes FE against the port's oracle at the
  Evaluator's rtol scale;
* the port's and the JAX package's ``Evaluator`` give equal FE verdicts and
  AER repairs on a fixed variant list per case, with the kernel check on.

Inputs come from ``datagen.generate`` with a seed and go to both packages.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aer import AER as JAER
from repro.core.kernelcase import cases as jax_cases
from repro.core.kernelcase import get_case as jax_case
from repro.core.mep import MEPConstraints as JMEPConstraints
from repro.core.mep import build_mep as jbuild_mep
from repro.core.optimizer import Evaluator as JEvaluator
from repro.core.optimizer import OptConfig as JOptConfig
from repro.core.profiler import TPUModelPlatform
from repro.core.proposer import DirectProposer as JDirectProposer
from repro_torch.core import (AER, DirectProposer, Evaluator,
                              H100ModelPlatform, MEPConstraints, OptConfig,
                              build_mep, cases, datagen, get_case)
from repro_torch.core.fe import as_tensors, leaves, outputs_match, to_numpy

F32, BF16 = "f32", "bf16"

# case → (test scale, {variant name: variant (None: the baseline)})
CASES = {
    "atax": (64, {"one_pass": {"one_pass": True, "compute_dtype": F32,
                               "block": 256},
                  "bf16": {"one_pass": False, "compute_dtype": BF16,
                           "block": 512},
                  "one_pass-bf16": {"one_pass": True, "compute_dtype": BF16,
                                    "block": 128}}),
    "bicg": (64, {"one_pass": {"one_pass": True, "compute_dtype": F32,
                               "block": 256},
                  "one_pass-bf16": {"one_pass": True, "compute_dtype": BF16,
                                    "block": 128}}),
    "gesummv": (64, {"one_pass": {"one_pass": True, "compute_dtype": F32,
                                  "block": 256},
                     "bf16": {"one_pass": False, "compute_dtype": BF16,
                              "block": 128}}),
    "gemver": (64, {"one_pass": {"one_pass": True, "rank1_trick": False,
                                 "compute_dtype": F32, "block": 128},
                    "rank1": {"one_pass": False, "rank1_trick": True,
                              "compute_dtype": F32, "block": 256},
                    "rank1-bf16": {"one_pass": True, "rank1_trick": True,
                                   "compute_dtype": BF16, "block": 512}}),
    "corr": (64, {"fused": {"fuse_epilogue": True, "moment_trick": False,
                            "compute_dtype": F32, "block_m": 64,
                            "block_n": 64, "block_k": 64},
                  "moment": {"fuse_epilogue": False, "moment_trick": True,
                             "compute_dtype": F32, "block_m": 128,
                             "block_n": 128, "block_k": 128},
                  "fused-bf16": {"fuse_epilogue": True,
                                 "moment_trick": False,
                                 "compute_dtype": BF16, "block_m": 32,
                                 "block_n": 32, "block_k": 32}}),
    "covar": (64, {"fused": {"fuse_epilogue": True, "moment_trick": False,
                             "compute_dtype": F32, "block_m": 64,
                             "block_n": 64, "block_k": 64},
                   "moment": {"fuse_epilogue": False, "moment_trick": True,
                              "compute_dtype": F32, "block_m": 128,
                              "block_n": 128, "block_k": 128},
                   "moment-bf16": {"fuse_epilogue": False,
                                   "moment_trick": True,
                                   "compute_dtype": BF16, "block_m": 32,
                                   "block_n": 32, "block_k": 32}}),
    "gramschm": (32, {"blocked8": {"block_cols": 8, "reorth": True},
                      "blocked16": {"block_cols": 16, "reorth": True}}),
    "adi": (32, {"precompute": {"precompute_coeffs": True,
                                "compute_dtype": F32}}),
    "binomialoption": (64, {"fused": {"unroll": 4, "fuse_probs": True},
                            "unrolled": {"unroll": 8, "fuse_probs": False}}),
    "bitonicsort": (256, {"vectorized": {"vectorized_exchange": True,
                                         "use_native_sort": False},
                          "native": {"vectorized_exchange": False,
                                     "use_native_sort": True}}),
    "dwthaar1d": (256, {"one_pass": {"one_pass": True}}),
    "fastwalshtransform": (256, {
        "reshape": {"reshape_butterfly": True, "one_pass": False},
        "one_pass": {"reshape_butterfly": False, "one_pass": True},
        "both": {"reshape_butterfly": True, "one_pass": True}}),
    "matrixmultiplication": (64, {
        "f32-128x64x256": {"block_m": 128, "block_n": 64, "block_k": 256,
                           "compute_dtype": F32},
        "bf16-64x128x64": {"block_m": 64, "block_n": 128, "block_k": 64,
                           "compute_dtype": BF16}}),
    "reduction": (65536, {"one_pass": {"one_pass": True, "block": 4096},
                          "block16384": {"one_pass": False,
                                         "block": 16384}}),
    "simpleconvolution": (32, {"shifts": {"method": "shifts"},
                               "separable": {"method": "separable"}}),
    "vectoradd": (4096, {"one_pass": {"one_pass": True, "block": 8192},
                         "block16384": {"one_pass": False,
                                        "block": 16384}}),
    "moe_grouped_gemm": (64, {
        "batched": {"batched": True, "compute_dtype": F32, "block_m": 64,
                    "block_n": 128, "block_k": 128},
        "batched-bf16": {"batched": True, "compute_dtype": BF16,
                         "block_m": 64, "block_n": 128, "block_k": 128},
        "per_expert-bf16": {"batched": False, "compute_dtype": BF16,
                            "block_m": 32, "block_n": 256, "block_k": 64}}),
}
PARAMS = [(name, vname) for name, (_, vs) in CASES.items()
          for vname in ["baseline", *vs]]

# Errors relative to the output's largest magnitude.  f32: the same
# arithmetic summed in another order (seen <= 3e-6; the tree's pow and the
# orthogonalization's norms included); a sort is exact.  bf16 builds round
# operands and products at the same points on both sides, but a sum can
# round either way: 2e-2, the FE bf16 tolerance.
F32_TOL = 1e-5
BF16_TOL = 2e-2


def _variant(case, vname):
    v = CASES[case.name][1].get(vname)
    return dict(case.baseline_variant) if v is None else v


def _scaled_err(got, want):
    worst = 0.0
    for g, w in zip(leaves(got), leaves(want)):
        g, w = to_numpy(g), np.asarray(w, np.float64)
        assert g.shape == w.shape
        worst = max(worst, float(np.abs(g - w).max()
                                 / max(np.abs(w).max(), 1e-30)))
    return worst


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_metadata_equals_jax(name):
    case, jcase = get_case(name), jax_case(name)
    assert (case.suite, case.family, case.app_site) == \
        (jcase.suite, jcase.family, jcase.app_site)
    assert case.variant_space == jcase.variant_space
    assert case.baseline_variant == jcase.baseline_variant
    assert tuple(case.scales) == tuple(jcase.scales)
    for s in case.scales:
        assert [dataclasses.astuple(a) for a in case.input_specs(s)] == \
            [dataclasses.astuple(a) for a in jcase.input_specs(s)]
        assert case.flops(s) == jcase.flops(s)
        for v in [dict(case.baseline_variant),
                  *CASES[name][1].values()]:
            assert case.generic_traffic(v, s) == jcase.generic_traffic(v, s)
            assert case.variant_latency(v, s) == jcase.variant_latency(v, s)


@pytest.mark.parametrize("name,vname", PARAMS)
def test_case_builds_match_jax_builds_and_ref(name, vname):
    """The port's torch build against the JAX jnp build, its cuda build
    against the JAX pallas build (Pallas in interpret mode where the JAX
    build calls a kernel), both against the oracles, at F32_TOL or
    BF16_TOL; each also passes FE against ``case.ref`` as the Evaluator
    checks it."""
    case, jcase = get_case(name), jax_case(name)
    scale = CASES[name][0]
    variant = _variant(case, vname)
    bf16 = variant.get("compute_dtype") == BF16
    tol = BF16_TOL if bf16 else F32_TOL
    arrs = datagen.generate(case.input_specs(scale), 7)
    jx = [jnp.asarray(a) for a in arrs]
    x = as_tensors(arrs, "cpu")
    ref = case.ref(*x)
    jref = jcase.ref(*jx)
    assert _scaled_err(ref, jref) <= F32_TOL
    for impl, jimpl in (("torch", "jnp"), ("cuda", "pallas")):
        got = case.build(variant, impl=impl)(*x)
        want = jcase.build(variant, impl=jimpl)(*jx)
        for g in leaves(got):
            assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        err = _scaled_err(got, want)
        assert err <= tol, (impl, err)
        if name == "bitonicsort":
            assert err == 0.0
        assert outputs_match(got, ref, 200.0 if bf16 else 1.0).ok, impl


def test_every_jax_case_is_registered_suite_by_suite():
    for suite in ("polybench", "appsdk", "hpc"):
        assert [c.name for c in cases(suite)] == \
            sorted(c.name for c in jax_cases(suite))
    assert len(cases()) == len(jax_cases()) == 25


# --------------------------------------------- Evaluator / AER parity ----
FE_VARIANTS = {
    name: [None, *vs.values()] for name, (_, vs) in CASES.items()}
# Under jit XLA folds the f32 convert after a bf16 product into the dot, so
# the JAX builds of corr and covar keep their bf16 Gram matrix unrounded
# and pass the kernel check's 4x f32 tolerance; eager PyTorch rounds it to
# bf16 (as eager JAX, K1 and the Pallas kernel do), which fails it, and the
# port repairs those variants to f32 (ROADMAP queue 3).
BF16_GRAM_ROUNDED = {"corr", "covar"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_evaluator_fe_verdicts_and_repairs_equal_jax(name):
    """Both evaluators FE-check the plain build (jnp / torch) and, with the
    kernel check on, the kernel build (the pallas branch, Pallas in
    interpret mode / the cuda branch through the plain versions) at the
    case's smallest scale, then time on their analytic platform: the same
    statuses, repaired variants and AER records."""
    jcase, case = jax_case(name), get_case(name)
    scale = min(case.scales)
    cfg_kw = dict(d_rounds=1, n_candidates=1, r=3, k=0, fe_input_sets=1)
    jmep = jbuild_mep(jcase, TPUModelPlatform(),
                      constraints=JMEPConstraints(t_max_s=2.0, r=5, k=1),
                      scale=scale)
    mep = build_mep(case, H100ModelPlatform(device="cpu"),
                    constraints=MEPConstraints(t_max_s=2.0, r=5, k=1),
                    scale=scale)
    jev = JEvaluator(jmep, jcase, "tpu-v5e-model", JAER(jcase, scale),
                     JDirectProposer(), JOptConfig(check_pallas=True,
                                                   **cfg_kw))
    ev = Evaluator(mep, case, "h100-model", AER(case, scale),
                   DirectProposer(), OptConfig(check_kernel=True, **cfg_kw))
    rounded = []
    for v in FE_VARIANTS[name]:
        v = dict(case.baseline_variant) if v is None else v
        j, t = jev.evaluate(dict(v)), ev.evaluate(dict(v))
        if name in BF16_GRAM_ROUNDED and v["compute_dtype"] == BF16:
            assert (j.status, j.variant, j.repairs) == ("ok", v, 0)
            assert (t.status, t.variant, t.repairs) == \
                ("ok", dict(v, compute_dtype=F32), 1)
            rounded.append(v)
            continue
        assert (t.status, t.variant, t.repairs) == \
            (j.status, j.variant, j.repairs), v
    records = [(r.stage, r.rule, r.before, r.after) for r in ev.aer.records]
    assert [r for r in records if r[2] not in rounded] == \
        [(r.stage, r.rule, r.before, r.after) for r in jev.aer.records]
    assert [r[1] for r in records if r[2] in rounded] == \
        ["fe_restore_precision"] * len(rounded)
