"""The port's worker fabric (``repro_torch.core.workers``) on the CPU.

Mirrors ``tests/test_workers.py`` on the analytic ``h100-model``
(constructed with ``device="cpu"``; its workers rebuild it from the spec
string ``h100-model@cpu``): wire round-trips, subprocess-executor
equivalence, fault paths (crash / timeout / replacement), cross-process
cache dedup, the local cluster's persistence.  Then what the port adds:

* the spec wire against the JAX package's: ``job_to_spec`` of the same
  case and job gives the same keys and values in both packages, but for
  the case digest, the platform name and the kernel-check flag's name;
* the device lease on a recording platform: two host aliases on one card
  resolve to one lease, which two processes under different aliases take
  in turn; FE and every timed slice run under it, and its holds are
  journaled without overlap;
* a guard on what a worker imports: spawned with a ``sitecustomize`` that
  makes ``import jax`` and ``import repro`` fail, it still answers a ping
  and a job;
* the launch log a worker writes outside the wire (``REPRO_LAUNCH_LOG``).

Workers are fresh interpreters (``import torch``: ~4 s here), each on one
CPU thread.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import threading

import pytest

from repro.core import CPUPlatform as JCPUPlatform
from repro.core import EvalCache as JEvalCache
from repro.core import HeuristicProposer as JHeuristicProposer
from repro.core import MEPConstraints as JMEPConstraints
from repro.core import OptConfig as JOptConfig
from repro.core import TPUModelPlatform
from repro.core import WorkerContext as JWorkerContext
from repro.core import CaseJob as JCaseJob
from repro.core import get_case as jget_case
from repro.core.workers import job_to_spec as jjob_to_spec
from repro_torch.core import (Campaign, CaseJob, DeviceLease, EvalCache,
                              EvalRecord, H100ModelPlatform,
                              HeuristicProposer, InProcessExecutor,
                              LocalClusterExecutor, MEPConstraints,
                              OptConfig, OptResult, Platform, ResultsDB,
                              SubprocessExecutor, TorchCPUPlatform,
                              WorkerContext, WorkerFault, canonical_spec,
                              get_case, optimize, platform_from_name)
from repro_torch.core import fe as fe_mod
from repro_torch.core import measure as measure_mod
from repro_torch.core.evalcache import this_host
from repro_torch.core.kernelcase import KernelCase
from repro_torch.core.profiler import TimingResult, platform_to_name
from repro_torch.core.proposer import Proposer
from repro_torch.core.workers import (LAUNCH_LOG_ENV, job_from_spec,
                                      job_to_spec, run_case_job)

FAST = MEPConstraints(t_max_s=2.0, r=5, k=1)
FAST_CFG = OptConfig(d_rounds=2, n_candidates=2, r=5, k=1)
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_workers():
    """Workers inherit the environment: one CPU thread each, off the
    cores that parallel test workers use."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    yield
    mp.undo()


def model_platform():
    return H100ModelPlatform(device="cpu")


def _ctx(platform=None, **kw):
    return WorkerContext(platform=platform or model_platform(), **kw)


def _job(case="gemm", seed=0, label=""):
    return CaseJob(get_case(case), HeuristicProposer(seed,
                                                     platform="h100-model"),
                   cfg=FAST_CFG, constraints=FAST, seed=seed, label=label)


@pytest.fixture(scope="module")
def cluster():
    """One persistent two-worker fabric for the tests that only run
    jobs on it."""
    ex = LocalClusterExecutor(2)
    ex.warm()
    yield ex
    ex.close()


# ------------------------------------------------------------- wire form --
def test_platform_registry_roundtrip():
    assert platform_from_name("h100-model@cpu").name == "h100-model"
    assert platform_from_name("h100-model@cpu").device == "cpu"
    assert platform_from_name("torch-cpu").name == "torch-cpu"
    assert platform_to_name(model_platform()) == "h100-model@cpu"
    assert platform_to_name(TorchCPUPlatform()) == "torch-cpu"
    with pytest.raises(KeyError, match="unknown platform"):
        platform_from_name("dcu-z100")


def test_kernelcase_wire_roundtrip_checks_digest():
    case = get_case("gemm")
    d = case.to_dict()
    assert KernelCase.from_dict(d) is case
    d["digest"] = "deadbeefdead"
    with pytest.raises(ValueError, match="digest mismatch"):
        KernelCase.from_dict(d)


def test_job_spec_roundtrip(tmp_path):
    cache = EvalCache(str(tmp_path / "ec.jsonl"), namespace="nsA",
                      ttl_s=123.0)
    db = ResultsDB(str(tmp_path / "db.jsonl"))
    ctx = _ctx(cache=cache, db=db)
    job = _job(seed=7, label="gemm#x")
    spec = json.loads(json.dumps(job_to_spec(job, ctx, "c0")))
    back, scale = job_from_spec(spec)
    assert back.case is job.case
    assert back.proposer.seed == 7 and back.proposer.name == "heuristic"
    assert back.cfg == job.cfg and back.constraints == job.constraints
    assert back.seed == 7 and back.label == "gemm#x" and scale is None
    assert spec["cache"] == {"path": cache.path, "ns": "nsA",
                             "ttl_s": 123.0}
    assert spec["db"] == db.path and spec["platform"] == "h100-model@cpu"


def test_job_spec_equals_the_jax_packages(tmp_path):
    """The same case and job through either package's ``job_to_spec``:
    the same keys and values, but for the case digest (different kernel
    code), the platform's name and ``check_kernel`` where JAX has
    ``check_pallas``; a spec of either reads back in the port."""
    cache_path = str(tmp_path / "ec.jsonl")
    kw = dict(d_rounds=3, n_candidates=2, r=7, k=1)
    job = CaseJob(get_case("syrk"), HeuristicProposer(5, platform="x"),
                  cfg=OptConfig(**kw), constraints=MEPConstraints(r=7, k=1),
                  seed=5, label="syrk#1")
    jjob = JCaseJob(jget_case("syrk"), JHeuristicProposer(5, platform="x"),
                    cfg=JOptConfig(**kw),
                    constraints=JMEPConstraints(r=7, k=1), seed=5,
                    label="syrk#1")
    for measured in (False, True):
        plat = TorchCPUPlatform() if measured else model_platform()
        jplat = JCPUPlatform() if measured else TPUModelPlatform()
        spec = job_to_spec(job, _ctx(plat, cache=EvalCache(cache_path)),
                           "c7")
        jspec = jjob_to_spec(jjob, JWorkerContext(
            platform=jplat, cache=JEvalCache(cache_path)), "c7")
        assert set(spec) == set(jspec)
        for d in (spec, jspec):
            d["job"]["case"].pop("digest")
            d.pop("platform")
        assert spec["job"]["cfg"].pop("check_kernel") is False
        assert jspec["job"]["cfg"].pop("check_pallas") is False
        assert spec == jspec
        assert (spec["lease"] is not None) == measured
    back, _ = job_from_spec(dict(jspec, platform="h100-model@cpu",
                                 job=dict(jspec["job"], case={
                                     "name": "syrk"})))
    assert back.cfg == job.cfg and back.constraints == job.constraints


def test_optresult_wire_roundtrip():
    res = optimize(get_case("gemm"), model_platform(),
                   HeuristicProposer(0, platform="h100-model"),
                   cfg=FAST_CFG, constraints=FAST)
    d = json.loads(json.dumps(res.to_dict(full=True), default=str))
    back = OptResult.from_dict(d)
    assert back.best_variant == res.best_variant
    assert back.best_time_s == res.best_time_s
    assert back.stop_reason == res.stop_reason
    assert len(back.rounds) == len(res.rounds)
    assert [c.variant for c in back.rounds[0].candidates] \
        == [c.variant for c in res.rounds[0].candidates]
    assert back.rounds[0].diagnosis == res.rounds[0].diagnosis


class _CustomProposer(Proposer):
    name = "custom"

    def propose(self, case, state, n):
        return []


def test_non_wire_safe_job_fails_before_spawn():
    job = CaseJob(get_case("gemm"), _CustomProposer(), cfg=FAST_CFG,
                  constraints=FAST)
    with pytest.raises(TypeError, match="not wire-safe"):
        SubprocessExecutor(2).run([job], _ctx(), campaign_id="c0")


def test_in_memory_cache_rejected_for_subprocess():
    with pytest.raises(ValueError, match="file-backed"):
        SubprocessExecutor(2).run([_job()], _ctx(cache=EvalCache()),
                                  campaign_id="c0")


# ----------------------------------------------------------- equivalence --
def test_subprocess_matches_inprocess(tmp_path):
    plat = model_platform()
    ref = Campaign(plat, cache=EvalCache(str(tmp_path / "a.jsonl")),
                   executor=InProcessExecutor(2)).run(
        [_job("gemm"), _job("syrk")])
    sub = Campaign(plat, cache=EvalCache(str(tmp_path / "b.jsonl")),
                   executor=SubprocessExecutor(2)).run(
        [_job("gemm"), _job("syrk")])
    for r, s in zip(ref, sub):
        assert s.best_variant == r.best_variant
        assert s.best_time_s == pytest.approx(r.best_time_s, rel=1e-12)
        assert s.stop_reason == r.stop_reason
        assert len(s.rounds) == len(r.rounds)
        assert s.platform == r.platform == "h100-model"


def test_subprocess_stop_event_pre_set(tmp_path, cluster):
    stop = threading.Event()
    stop.set()
    camp = Campaign(model_platform(),
                    cache=EvalCache(str(tmp_path / "ec.jsonl")),
                    executor=cluster)
    res = camp.run([_job()], stop=stop)[0]
    assert res.stop_reason == "stop requested"
    assert res.rounds == []


# ----------------------------------------------------------- fault paths --
def test_worker_crash_mid_eval_replaced_and_retried(tmp_path):
    """First attempt crashes the worker process; the executor journals
    the fault, replaces the worker, and the retry on the fresh process
    succeeds."""
    db = ResultsDB(str(tmp_path / "db.jsonl"))
    job = _job()
    job.inject = {"crash_once_flag": str(tmp_path / "crashed.flag")}
    ex = SubprocessExecutor(1, retries=1)
    out = ex.run([job], _ctx(cache=EvalCache(str(tmp_path / "ec.jsonl")),
                             db=db), campaign_id="c0")
    assert isinstance(out[0], OptResult) and out[0].speedup >= 1.0
    assert os.path.exists(str(tmp_path / "crashed.flag"))
    faults = list(db.records("worker_fault"))
    assert len(faults) == 1
    assert faults[0]["fault"] == "crash" and faults[0]["job"] == "gemm"
    assert [j for j, _ in ex.dispatch_log] == ["gemm", "gemm"]


def test_worker_crash_exhausts_retries_raises_workerfault(tmp_path):
    db = ResultsDB(str(tmp_path / "db.jsonl"))
    job = _job()
    job.inject = {"crash": True, "exit_code": 43}
    camp = Campaign(model_platform(), db=db,
                    cache=EvalCache(str(tmp_path / "ec.jsonl")),
                    executor=SubprocessExecutor(1, retries=1))
    with pytest.raises(RuntimeError, match="campaign job 'gemm' failed"):
        camp.run([job])
    assert [f["fault"] for f in db.records("worker_fault")] \
        == ["crash", "crash"]
    end = next(db.records("campaign_end"))
    assert "WorkerFault" in end["errors"][0]["error"]


def test_worker_timeout_is_a_workerfault(tmp_path):
    job = _job()
    job.inject = {"sleep_s": 60}
    ex = SubprocessExecutor(1, timeout_s=3.0, retries=0)
    ex.warm(timeout_s=120)          # the timeout covers the job alone
    out = ex.run([job], _ctx(cache=EvalCache(str(tmp_path / "ec.jsonl"))),
                 campaign_id="c0")
    assert isinstance(out[0], WorkerFault)
    assert out[0].kind == "timeout" and out[0].attempts == 1


def test_a_card_platform_without_a_gpu_is_the_jobs_error(tmp_path, cluster):
    """A worker asked for ``h100`` on a machine without a GPU raises; the
    error comes back as the job's outcome, never a CPU result."""
    class Card(Platform):
        name, device = "h100", "cuda"
    out = cluster.run([_job()], _ctx(Card(), cache=EvalCache(
        str(tmp_path / "ec.jsonl"))), campaign_id="c0")
    assert isinstance(out[0], RuntimeError)
    assert "no CUDA device" in str(out[0])


# ------------------------------------------- cross-process cache dedup ---
def test_two_workers_racing_same_key_compute_once(tmp_path, cluster):
    """Two workers evaluating identical jobs (same case, same seed,
    different labels) race on every cache key; the per-key lock file keeps
    in-flight dedup intact across processes: each key is computed (and
    appended) exactly once."""
    cache_path = str(tmp_path / "ec.jsonl")
    camp = Campaign(model_platform(), cache=EvalCache(cache_path),
                    executor=cluster)
    r1, r2 = camp.run([_job(label="gemm#a"), _job(label="gemm#b")])
    assert r1.best_variant == r2.best_variant
    with open(cache_path) as f:
        keys = [json.loads(line)["key"] for line in f if line.strip()]
    assert len(keys) == len(set(keys)), "a cache key was computed twice"
    assert len(keys) >= 3
    assert os.path.isdir(cache_path + ".locks")


def test_measured_cache_namespace_rejection(tmp_path):
    path = str(tmp_path / "ec.jsonl")
    spec = canonical_spec("gemm", {"block_m": 64}, 256, "torch-cpu", r=5,
                          k=1)
    a = EvalCache(path, namespace="hostA:x86")
    a.get_or_compute(spec, lambda: EvalRecord(status="ok", time_s=1.0),
                     measured=True)
    assert EvalCache(path, namespace="hostA:x86").lookup(spec).time_s == 1.0
    b = EvalCache(path, namespace="hostB:arm")
    assert b.lookup(spec) is None
    assert b.stats()["stale"] == 1
    rec, hit = b.get_or_compute(
        spec, lambda: EvalRecord(status="ok", time_s=2.0), measured=True)
    assert not hit and rec.time_s == 2.0


def test_measured_platform_fans_out_with_lease():
    """Measured platforms fan out like analytic ones; every measured spec
    carries a timing-lease path for the workers to share."""
    ex = SubprocessExecutor(3)
    assert ex._slots_for(_ctx(TorchCPUPlatform()), 8) == [0, 1, 2]
    assert ex._slots_for(_ctx(model_platform()), 8) == [0, 1, 2]
    spec = job_to_spec(_job(), _ctx(TorchCPUPlatform()), "c-lease")
    assert spec["lease"] and "c-lease" in spec["lease"]
    spec = job_to_spec(_job(), _ctx(model_platform()), "c2")
    assert spec["lease"] is None


# ------------------------------------------------- local cluster ---------
def test_local_cluster_fans_out_measured_and_analytic():
    ex = LocalClusterExecutor(4)
    assert ex._slots_for(_ctx(model_platform()), 8) == [0, 1, 2, 3]
    assert ex._slots_for(_ctx(TorchCPUPlatform()), 8) == [0, 1, 2, 3]
    ex.close()


def test_local_cluster_persists_workers_across_runs(tmp_path, cluster):
    ctx = _ctx(cache=EvalCache(str(tmp_path / "ec.jsonl")))
    procs1 = dict(cluster._procs)
    out1 = cluster.run([_job("gemm")], ctx, campaign_id="c1")
    out2 = cluster.run([_job("syrk")], ctx, campaign_id="c2")
    assert isinstance(out1[0], OptResult)
    assert isinstance(out2[0], OptResult)
    for slot, w in procs1.items():
        assert cluster._procs[slot] is w and w.alive()


def test_campaign_closes_an_executor_it_made(tmp_path):
    """An executor the campaign makes from a kind string is its own: its
    workers (each a CUDA context on the card) end with the run."""
    camp = Campaign(model_platform(), executor="local-cluster",
                    max_workers=1,
                    cache=EvalCache(str(tmp_path / "ec.jsonl")))
    assert camp.owns_executor
    procs = {}
    run = camp.executor.run

    def spy(*a, **k):
        out = run(*a, **k)
        procs.update(camp.executor._procs)
        return out
    camp.executor.run = spy
    assert isinstance(camp.run([_job()])[0], OptResult)
    assert procs and not any(w.alive() for w in procs.values())


# --------------------------------------------------------- device lease --
class _Props:
    uuid = "GPU-5e1f0c2a-card"


def test_two_aliases_on_one_card_resolve_to_one_lease(monkeypatch):
    """The device lease keys on the physical card, not the host alias;
    the timing lease the reference keys on the host differs by alias."""
    import torch
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: _Props())

    class Card(Platform):
        name, device = "card", "cuda:0"
    paths, timing = set(), set()
    for alias in ("fleetA", "fleetB"):
        monkeypatch.setenv("REPRO_HOST_ALIAS", alias)
        paths.add(measure_mod.platform_lease(Card()).path)
        timing.add(measure_mod.default_lease_path("/c.jsonl", scope="s"))
    assert len(paths) == 1 and "GPU-5e1f0c2a-card" in paths.pop()
    assert len(timing) == 2
    assert measure_mod.platform_lease(model_platform()) is None
    assert measure_mod.platform_lease(TorchCPUPlatform()) is None


def _child(body: str) -> str:
    """A child script that loads the port's pure-Python modules under stub
    packages: it starts in well under a second (no ``import torch``), so
    the children of one test overlap."""
    return textwrap.dedent(f"""
        import sys, types
        for name in ("repro_torch", "repro_torch.core",
                     "repro_torch.kernels"):
            m = types.ModuleType(name)
            m.__path__ = [{os.path.abspath(SRC)!r} + "/"
                          + name.replace(".", "/")]
            sys.modules[name] = m
    """) + textwrap.dedent(body)


_HOLDER = _child("""
    import os, sys, time
    from repro_torch.core.measure import DeviceLease
    lease = DeviceLease("card", path=sys.argv[1])
    for _ in range(int(sys.argv[3])):
        with lease.hold("time"):
            for tok in ("enter", "exit"):
                fd = os.open(sys.argv[2], os.O_WRONLY | os.O_APPEND
                             | os.O_CREAT)
                os.write(fd, f"{tok} {os.environ['REPRO_HOST_ALIAS']}\\n"
                         .encode())
                os.close(fd)
                time.sleep(0.002)
""")


def test_the_card_lease_serialises_processes_under_two_aliases(tmp_path):
    lease, log = str(tmp_path / "card.lock"), str(tmp_path / "tokens.log")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _HOLDER, lease, log, "30"],
        env=dict(os.environ, REPRO_HOST_ALIAS=alias, PYTHONPATH=SRC))
        for alias in ("fleetA", "fleetB")]
    for p in procs:
        assert p.wait(timeout=120) == 0
    with open(log) as f:
        tokens = [line.split() for line in f if line.strip()]
    assert len(tokens) == 2 * 2 * 30
    holder = None
    for kind, tag in tokens:
        if kind == "enter":
            assert holder is None, f"{tag} entered while {holder} held it"
            holder = tag
        else:
            assert holder == tag
            holder = None
    assert {tag for _, tag in tokens} == {"fleetA", "fleetB"}


class _Recording(Platform):
    """Times analytically but claims a card: records whether the lease was
    held at each timed slice."""
    name = "recording"
    device = "cpu"
    impl = "torch"

    def __init__(self, lease):
        self.lease, self.timed = lease, []

    def device_lease(self):
        return self.lease

    def time_variant(self, case, variant, scale, inputs, *, r, k,
                     budget=None, incumbent_s=None):
        self.timed.append(self.lease.held())
        t = 1e-3 / (1 + variant.get("block_m", 128) / 128)
        return TimingResult(t, [t], 1, 0, r_cap=r, deterministic=True)


def test_fe_and_timed_slices_run_under_the_lease_and_are_journaled(
        tmp_path, monkeypatch):
    lease = DeviceLease("rec", path=str(tmp_path / "rec.lock"))
    plat = _Recording(lease)
    fe_held = []
    check = fe_mod.check

    def spy(*a, **kw):
        fe_held.append(lease.held())
        return check(*a, **kw)
    monkeypatch.setattr(fe_mod, "check", spy)
    db = ResultsDB(str(tmp_path / "db.jsonl"))
    res = run_case_job(_job("gemm"), plat, campaign_id="c9", db=db)
    assert res.rounds and plat.timed and fe_held
    assert all(plat.timed) and all(fe_held)
    holds = list(db.records("device_lease"))
    assert len(holds) == lease.holds >= len(plat.timed)
    assert {h["what"] for h in holds} >= {"probe", "time", "fe"}
    assert all(h["campaign"] == "c9" and h["job"] == "gemm"
               and h["pid"] == os.getpid() and h["host"] == this_host()
               and h["t_req"] <= h["t0"] <= h["t1"] for h in holds)
    spans = sorted((h["t0"], h["t1"]) for h in holds)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert not lease.held()


# ------------------------------------------------------- import guard ----
_GUARD = textwrap.dedent("""
    import importlib.abc, sys

    class _Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                raise ImportError(f"the port's worker imported {name}")
            return None

    sys.meta_path.insert(0, _Block())
""")


def test_the_worker_runs_without_jax_or_the_jax_package(tmp_path,
                                                        monkeypatch):
    guard = tmp_path / "guard"
    guard.mkdir()
    (guard / "sitecustomize.py").write_text(_GUARD)
    monkeypatch.setenv("PYTHONPATH", str(guard))
    ex = SubprocessExecutor(1, timeout_s=120)
    try:
        ex.warm(timeout_s=120)
        out = ex.run([_job("gemm")], _ctx(cache=EvalCache(
            str(tmp_path / "ec.jsonl"))), campaign_id="guard")
    finally:
        ex.close()
    assert isinstance(out[0], OptResult), out[0]
    assert out[0].rounds
    probe = subprocess.run(
        [sys.executable, "-c", "import repro.core"], capture_output=True,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join([str(guard), SRC])))
    assert probe.returncode != 0 and b"imported repro" in probe.stderr


# --------------------------------------------------------- launch log ----
def test_the_launch_log_names_each_jobs_kernel_calls(tmp_path, monkeypatch):
    """With ``REPRO_LAUNCH_LOG`` set, a worker appends one line a job: its
    launches (none here: on CPU tensors K1's wrapper runs its plain
    version) and the distinct calls the suites made of each kernel."""
    log = str(tmp_path / "launches.jsonl")
    monkeypatch.setenv(LAUNCH_LOG_ENV, log)
    cfg = OptConfig(d_rounds=1, n_candidates=2, r=5, k=1, check_kernel=True)
    jobs = [CaseJob(get_case(n), HeuristicProposer(0, platform="h100-model"),
                    cfg=cfg, constraints=FAST) for n in ("gemm", "2mm")]
    ex = SubprocessExecutor(1)
    out = ex.run(jobs, _ctx(cache=EvalCache(str(tmp_path / "ec.jsonl"))),
                 campaign_id="log")
    assert all(isinstance(o, OptResult) for o in out)
    with open(log) as f:
        lines = [json.loads(x) for x in f if x.strip()]
    assert [ln["case"] for ln in lines] == ["gemm", "2mm"]
    assert len({ln["pid"] for ln in lines}) == 1
    for ln in lines:
        assert ln["launches"]["matmul"] == {"total": 0, "mma": 0, "simt": 0}
        calls = ln["calls"]["matmul"]
        assert calls and all(len(c["args"]) >= 2 for c in calls)
        a = calls[0]["args"][0]
        assert set(a) == {"shape", "stride", "dtype"}
        assert {"block_m", "block_n", "block_k"} <= set(calls[0]["kw"])


# ------------------------------------------------------- kernel builds ---
_FAKE_NVCC = textwrap.dedent("""
    import shutil, sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    time.sleep(0.5)                 # both processes inside nvcc at once
    shutil.copyfile(sys.argv[-1].replace(".cu", ".so.src"), out)
    print("ptxas info: fake", file=sys.stderr)
""")

_BUILD_ONE = _child("""
    import ctypes, pathlib, sys
    from repro_torch.kernels import build
    build.CSRC = pathlib.Path(sys.argv[1])
    build.BUILD_DIR = pathlib.Path(sys.argv[2])
    build._nvcc = lambda: sys.argv[3]
    (lib,) = build.build("fake")
    assert isinstance(lib, ctypes.CDLL)
    print(build.build_info["fake"]["seconds"] > 0)
""")


def test_two_processes_building_one_kernel_both_load_it(tmp_path):
    """Two worker processes that find a kernel unbuilt at the same moment
    both compile it (each to its own temporary name), and both load a
    whole library: the one left at the final name is one of theirs."""
    import torch
    # any shared library stands in for a built kernel: torch's own
    real = next(pathlib.Path(torch.__file__).parent.glob("lib/libc10.so"))
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// a kernel\n")
    (csrc / "fake.so.src").write_bytes(open(real, "rb").read())
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!" + sys.executable + "\n" + _FAKE_NVCC)
    nvcc.chmod(0o755)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_ONE, str(csrc), str(out), str(nvcc)],
        stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=SRC)) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].split() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs == [["True"], ["True"]]      # both compiled
    assert [f.name for f in out.iterdir() if f.suffix == ".so"] \
        and not list(out.glob("*.tmp"))
