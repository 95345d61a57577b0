"""The port's MEP pipeline (``repro_torch.core``) against the JAX package's.

* ``outputs_match`` gives the JAX verdicts on numpy and torch, f32 and bf16;
* the same fixed variant list through both packages' ``Evaluator`` gives
  equal FE verdicts and AER repair records;
* journals written by the JAX ``EvalCache``, ``ResultsDB`` and
  ``PatternStore`` replay through the port's readers;
* ``emit_script`` renders a PyTorch script that runs on the CPU;
* ``optimize`` on ``gemm`` with ``h100-model`` is deterministic and never
  worse than the baseline; the shared-memory repair and the port's
  refusals.

Everything runs on the CPU (``device="cpu"``); the analytic ``h100-model``
platform needs no card.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fe as jfe
from repro.core.aer import AER as JAER
from repro.core.evalcache import EvalCache as JEvalCache
from repro.core.evalcache import EvalRecord as JEvalRecord
from repro.core.evalcache import ResultsDB as JResultsDB
from repro.core.evalcache import canonical_spec as jcanonical_spec
from repro.core.kernelcase import get_case as jget_case
from repro.core.mep import build_mep as jbuild_mep
from repro.core.optimizer import Evaluator as JEvaluator
from repro.core.optimizer import OptConfig as JOptConfig
from repro.core.patterns import PatternStore as JPatternStore
from repro.core.profiler import TPUModelPlatform
from repro.core.proposer import DirectProposer as JDirectProposer
from repro_torch.core import (AER, Campaign, CaseJob, DirectProposer,
                              EvalCache, Evaluator, H100ModelPlatform,
                              H100Platform, HeuristicProposer,
                              MEPConstraints, OptConfig, PatternStore,
                              ResultsDB, TorchCPUPlatform, build_mep,
                              canonical_spec, emit_script, get_case,
                              optimize, platform_from_name)
from repro_torch.core import fe
from repro_torch.core.diagnosis import diagnose_feedback
from repro_torch.core.profiler import (SMEM_BYTES, variant_mxu_utilization,
                                       variant_smem_bytes)
from repro_torch.kernels.matmul import matmul

FAST = MEPConstraints(t_max_s=2.0, r=5, k=1)
FAST_CFG = OptConfig(d_rounds=3, n_candidates=3, r=5, k=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This file times torch builds on the CPU: keep them on one core, off
    the cores that parallel test workers time on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_platform():
    return H100ModelPlatform(device="cpu")


# --------------------------------------------------------------- FE ------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("noise", [0.0, 1e-5, 1e-3, 5e-2, 1.0])
def test_outputs_match_gives_the_jax_verdict(dtype, noise):
    """The same arrays as numpy/jax and as torch: equal verdicts, and the
    error figures agree to f32 rounding."""
    rng = np.random.default_rng(0)
    want = rng.standard_normal((32, 16)).astype(np.float32)
    got = (want + noise * rng.standard_normal(want.shape)).astype(np.float32)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jw, jg = jnp.asarray(want, jdt), jnp.asarray(got, jdt)
    tw, tg = torch.from_numpy(want).to(tdt), torch.from_numpy(got).to(tdt)
    j = jfe.outputs_match((jg, jg), (jw, jw))
    t = fe.outputs_match((tg, tg), [tw, tw])
    n = fe.outputs_match(np.asarray(jg), np.asarray(jw))
    assert j.ok == t.ok == n.ok
    assert t.max_abs_err == pytest.approx(j.max_abs_err, rel=1e-6, abs=1e-9)
    assert fe._tol_for(tw) == jfe._tol_for(jw)


def test_outputs_match_flags_arity_shape_and_nonfinite():
    x = torch.ones(4)
    assert not fe.outputs_match((x, x), (x,)).ok
    assert not fe.outputs_match(torch.ones(3), x).ok
    assert not fe.outputs_match(x * float("nan"), x).ok


# ----------------------------------------------- Evaluator / AER parity --
VARIANT_LIST = [
    {"block_m": 32, "block_n": 32, "block_k": 32, "compute_dtype": "f32",
     "fuse_epilogue": False},
    {"block_m": 128, "block_n": 128, "block_k": 128,
     "compute_dtype": "bf16", "fuse_epilogue": True},
    {"block_m": 64, "block_n": 256, "block_k": 32, "compute_dtype": "f32",
     "fuse_epilogue": False},
    {"block_m": 256, "block_n": 64, "block_k": 128,
     "compute_dtype": "bf16", "fuse_epilogue": False},
]


@pytest.mark.parametrize("check_kernel", [False, True])
@pytest.mark.parametrize("name", ["gemm", "syrk"])
def test_evaluator_fe_verdicts_and_repairs_equal_jax(name, check_kernel):
    """Both evaluators FE-check the plain build (jnp / torch) and, with
    the kernel check on, the kernel build (Pallas in interpret mode / K1's
    plain version) at fe_scale 64, then time on their analytic platform.
    The kernel check holds bf16 to 4x the f32 tolerance on both sides, so
    bf16 variants fail it and are repaired to f32 (fe_restore_precision)
    in both packages."""
    cfg_kw = dict(d_rounds=1, n_candidates=1, r=3, k=0, fe_scale=64,
                  fe_input_sets=1)
    jcase, case = jget_case(name), get_case(name)
    jmep = jbuild_mep(jcase, TPUModelPlatform(), constraints=FAST, scale=256)
    mep = build_mep(case, model_platform(), constraints=FAST, scale=256)
    jev = JEvaluator(jmep, jcase, "tpu-v5e-model", JAER(jcase, 256),
                     JDirectProposer(),
                     JOptConfig(check_pallas=check_kernel, **cfg_kw))
    ev = Evaluator(mep, case, "h100-model", AER(case, 256),
                   DirectProposer(), OptConfig(check_kernel=check_kernel,
                                               **cfg_kw))
    for v in VARIANT_LIST:
        j, t = jev.evaluate(dict(v)), ev.evaluate(dict(v))
        assert (t.status, t.variant, t.repairs) == \
            (j.status, j.variant, j.repairs), v
    assert [(r.stage, r.rule, r.before, r.after)
            for r in ev.aer.records] == \
        [(r.stage, r.rule, r.before, r.after) for r in jev.aer.records]
    if check_kernel:
        assert [r.rule for r in ev.aer.records] == \
            ["fe_restore_precision"] * 2


def test_shared_memory_overflow_is_repaired_by_halving_blocks():
    """An f32 256^3 tile needs 262,144 bytes of shared memory, above the
    232,448 an H100 block may use: K1's wrapper refuses it (on the CPU as
    on the card) and AER halves the largest block until it fits."""
    case = get_case("gemm")
    mep = build_mep(case, model_platform(), constraints=FAST, scale=512)
    ev = Evaluator(mep, case, "h100-model", AER(case, 512), DirectProposer(),
                   OptConfig(check_kernel=True, fe_scale=512,
                             fe_input_sets=1, r=3, k=0))
    big = {"block_m": 256, "block_n": 256, "block_k": 256,
           "compute_dtype": "f32", "fuse_epilogue": True}
    assert variant_smem_bytes(big, 512) == 262_144 > SMEM_BYTES
    cl = ev.evaluate(big)
    assert cl.status == "ok" and cl.repairs == 3
    assert {r.rule for r in ev.aer.records} == {"smem_halve_largest_block"}
    assert "shared memory" in ev.aer.records[0].error
    assert variant_smem_bytes(cl.variant, 512) <= SMEM_BYTES


def test_hopper_feedback_keys_keep_their_names():
    case, p = get_case("gemm"), model_platform()
    v = dict(case.baseline_variant)
    fb = p.profile_feedback(case, v, 384)
    assert fb["mxu_utilization"] == variant_mxu_utilization(v) == 0.5
    assert fb["vmem_bytes"] == variant_smem_bytes(v, 384) == 8192
    d = diagnose_feedback(fb)
    assert d.vmem_fraction == pytest.approx(8192 / 232_448)
    assert variant_smem_bytes({"chunked": True, "block_k": 256}) == 0


# ----------------------------------------------------------- journals ----
def test_jax_journals_replay_through_the_port_readers(tmp_path):
    path = str(tmp_path / "evalcache.jsonl")
    jc = JEvalCache(path)
    spec = jcanonical_spec("gemm", {"block_m": 64}, 256, "cpu", r=5, k=1)
    jrec, hit = jc.get_or_compute(spec, lambda: JEvalRecord(
        status="ok", time_s=1.5e-4, reps=7, r_cap=30,
        final_variant={"block_m": 64}), measured=True)
    jc.get_or_compute(jcanonical_spec("gemm", {}, 256, "cpu", kind="x"),
                      lambda: JEvalRecord(status="fe_fail"))
    jc.compact()              # the JAX writer ends with a compaction marker
    port = EvalCache(path)
    assert len(port) == 2
    assert canonical_spec("gemm", {"block_m": 64}, 256, "cpu", r=5,
                          k=1) == spec
    rec = port.lookup(spec)
    assert rec is not None and rec.to_dict() == jrec.to_dict()
    assert port.lookup(jcanonical_spec("gemm", {}, 256, "cpu",
                                       kind="x")).time_s == float("inf")

    db_path = str(tmp_path / "campaign.jsonl")
    JResultsDB(db_path).append("round", case="gemm", best_time_s=float(
        "inf"), candidates=[{"variant": {"block_m": 32}}])
    JResultsDB(db_path).append("case_result", case="gemm", speedup=2.5)
    recs = list(ResultsDB(db_path).records())
    assert [r["kind"] for r in recs] == ["round", "case_result"]
    assert recs[0]["best_time_s"] is None and recs[1]["speedup"] == 2.5

    pat_path = str(tmp_path / "patterns.jsonl")
    jstore = JPatternStore(pat_path)
    jcase = jget_case("gemm")
    jstore.record(jcase, "cpu", dict(jcase.baseline_variant),
                  dict(jcase.baseline_variant, block_m=128), 3.0,
                  bottleneck="compute")
    jstore.record(jget_case("syrk"), "cpu", dict(jcase.baseline_variant),
                  dict(jcase.baseline_variant, compute_dtype="bf16"), 1.5)
    p = jstore.patterns[0]
    jstore.record_hint_outcome(jcase, "cpu", p, won=False)
    store = PatternStore(pat_path)
    assert len(store) == 2 and store.quarantined == 0
    assert store.acceptance(p.delta, "matmul") == (1, 0)
    case = get_case("gemm")
    assert store.suggest(case, "cpu", bottleneck="compute") == \
        jstore.suggest(jcase, "cpu", bottleneck="compute")


# ---------------------------------------------------------- the MEP ------
def test_emit_script_runs(tmp_path):
    case = get_case("gemm")
    mep = build_mep(case, TorchCPUPlatform(), constraints=FAST, scale=256)
    script = emit_script(mep, {"block_m": 64, "block_n": 64, "block_k": 64,
                               "compute_dtype": "f32",
                               "fuse_epilogue": True})
    assert "import jax" not in script and "repro_torch" in script
    path = tmp_path / "mep_gemm.py"
    path.write_text(script)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, str(path)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FE=True" in out.stdout


def test_optimize_on_the_h100_model_is_deterministic_and_never_worse():
    case = get_case("gemm")
    runs = []
    for _ in range(2):
        p = model_platform()
        res = optimize(case, p, HeuristicProposer(0, None, p.name),
                       cfg=FAST_CFG, constraints=FAST)
        runs.append(res)
    a, b = runs
    assert a.best_variant == b.best_variant
    assert a.best_time_s == b.best_time_s
    assert [[c.variant for c in r.candidates] for r in a.rounds] == \
        [[c.variant for c in r.candidates] for r in b.rounds]
    assert a.best_time_s <= a.baseline_time_s and a.speedup >= 1.0
    assert a.mep_log[0].startswith("scale 1024: accepted")


def test_campaign_on_torch_cpu_journals_every_case(tmp_path):
    """A measured campaign over two cases on the CPU, with a shared cache
    and journal: every candidate is FE-checked through the torch build and
    timed; the rerun is served from the cache."""
    cache = EvalCache(str(tmp_path / "cache.jsonl"))
    db = ResultsDB(str(tmp_path / "campaign.jsonl"))
    store = PatternStore(str(tmp_path / "patterns.jsonl"))
    p = TorchCPUPlatform()
    cfg = OptConfig(d_rounds=1, n_candidates=2, r=3, k=0)
    cons = MEPConstraints(t_max_s=2.0, r=3, k=0)
    jobs = [CaseJob(get_case(n), HeuristicProposer(0, store, p.name),
                    cfg=cfg, constraints=cons) for n in ("gemm", "syrk")]
    camp = Campaign(p, patterns=store, cache=cache, db=db, max_workers=2)
    first = camp.run(jobs)
    assert [r.case_name for r in first] == ["gemm", "syrk"]
    assert all(r.best_time_s <= r.baseline_time_s for r in first)
    kinds = [r["kind"] for r in db.records()]
    assert kinds[0] == "campaign_start" and kinds[-1] == "campaign_end"
    assert kinds.count("case_result") == 2
    again = camp.run(jobs)
    assert all(r.cache_hits > 0 for r in again)


def test_population_search_is_not_ported_yet():
    p = model_platform()
    job = CaseJob(get_case("gemm"), HeuristicProposer(0, None, p.name),
                  cfg=OptConfig(population=object()), constraints=FAST)
    with pytest.raises(RuntimeError, match="failed") as e:
        Campaign(p).run([job])
    assert isinstance(e.value.__cause__, NotImplementedError)
    assert "ROADMAP queue 1 item 9" in str(e.value.__cause__)


def test_h100_platforms_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        H100Platform()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        platform_from_name("h100-model")
    with pytest.raises(ValueError, match="on the card"):
        H100Platform(device="cpu")
    assert platform_from_name("torch-cpu").device == "cpu"
    assert H100Platform.check_kernel and H100Platform.impl == "cuda"


def test_campaign_on_a_measured_cuda_platform_runs_one_job_at_a_time():
    class FakeCard(TorchCPUPlatform):
        name, device = "fake-card", "cuda"
    assert Campaign(FakeCard(), max_workers=4).max_workers == 1
    assert Campaign(TorchCPUPlatform(), max_workers=4).max_workers == 4
    assert Campaign(model_platform(), max_workers=4).max_workers == 4


def test_fe_check_runs_the_kernel_build_through_its_plain_version():
    case = get_case("gemm")
    before = matmul.launches
    r = fe.check(case, dict(case.baseline_variant), 64, impl="cuda",
                 device="cpu")
    assert r.ok and matmul.launches == before
