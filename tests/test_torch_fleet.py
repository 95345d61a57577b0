"""The port's networked campaign fleet on the CPU: ``RemoteExecutor`` over
the spec wire, per-host namespace/lease resolution, journal replication,
and the fabric's framing, warm-up and routing details.

Mirrors ``tests/test_fleet.py`` on the analytic ``h100-model``
(``device="cpu"``).  The fleet legs use the ``spawn`` transport —
loopback ``python -m repro_torch.core.remote_worker`` servers with
distinct ``REPRO_HOST_ALIAS`` identities — so the exact socket and
per-host code paths of a multi-machine fleet run without SSH.  Then the
replication wire against the JAX package's: a journal the JAX package
compacted, marker and all, ships through the port's ``JournalLink`` and
replays to the state the JAX ``Replicator`` gives.
"""
import dataclasses
import json
import os
import sys
import threading
import time

import pytest

from repro_torch.core import (CaseJob, Campaign, EvalCache, EvalRecord,
                              FleetHost, H100ModelPlatform,
                              HeuristicProposer, InProcessExecutor,
                              JournalLink,
                              MEPConstraints, OptConfig, OptResult,
                              PatternStore, RemoteExecutor, Replicator,
                              ResultsDB, SubprocessExecutor,
                              TorchCPUPlatform, WorkerContext, WorkerFault,
                              canonical_spec, get_case, make_executor)
from repro_torch.core.evalcache import this_host
from repro_torch.core.workers import (_AffinityRouter, _LineChannel,
                                      job_to_spec, lease_for_spec)
import repro_torch.core.workers as workers_mod


@pytest.fixture(autouse=True, scope="module")
def _one_thread_workers():
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    yield
    mp.undo()


def model_platform():
    return H100ModelPlatform(device="cpu")


FAST = MEPConstraints(t_max_s=2.0, r=5, k=1)
FAST_CFG = OptConfig(d_rounds=2, n_candidates=2, r=5, k=1)


def _ctx(platform=None, **kw):
    return WorkerContext(platform=platform or model_platform(), **kw)


def _job(case="gemm", seed=0, label=""):
    return CaseJob(get_case(case), HeuristicProposer(seed,
                                                     platform="h100-model"),
                   cfg=FAST_CFG, constraints=FAST, seed=seed, label=label)


# ------------------------------------------------- dataclass defaults ----
def test_casejob_defaults_are_not_aliased():
    """Per-job config mutation must never leak into other defaulted jobs
    (the old ``cfg: OptConfig = OptConfig()`` class-level instance)."""
    a = CaseJob(get_case("gemm"), HeuristicProposer(0))
    b = CaseJob(get_case("atax"), HeuristicProposer(0))
    assert a.cfg is not b.cfg
    assert a.constraints is not b.constraints


def test_no_shared_mutable_dataclass_defaults_in_core():
    """Audit: no dataclass in core/ may default a field to a shared
    *mutable* instance.  Frozen-dataclass defaults are fine (immutable,
    sharing is safe); anything else must use default_factory."""
    from repro_torch.core import (campaign, chaos, diagnosis, evalcache,
                                  kernelcase, measure, mep, optimizer,
                                  patterns, population, proposer, replicate,
                                  workers)
    offenders = []
    for mod in (campaign, chaos, diagnosis, evalcache, kernelcase, measure,
                mep, optimizer, patterns, population, proposer, replicate,
                workers):
        for obj in vars(mod).values():
            if not (isinstance(obj, type) and dataclasses.is_dataclass(obj)
                    and obj.__module__ == mod.__name__):
                continue
            for f in dataclasses.fields(obj):
                d = f.default
                if d is dataclasses.MISSING:
                    continue
                if isinstance(d, (list, dict, set, bytearray)):
                    offenders.append(f"{obj.__name__}.{f.name}")
                elif dataclasses.is_dataclass(d) \
                        and not type(d).__dataclass_params__.frozen:
                    offenders.append(f"{obj.__name__}.{f.name}")
    assert not offenders, f"shared mutable defaults: {offenders}"


# ----------------------------------------------------- warm() fallout ----
_DIES_MID_PING = [sys.executable, "-u", "-c",
                  "import sys; sys.stdin.readline(); sys.exit(9)"]


def test_warm_replaces_worker_that_dies_mid_ping(monkeypatch):
    """A worker dying during the warm() ping goes through the same
    replace-and-retry path submit uses — no raw EOFError, no dead slot
    left in the fabric."""
    real = workers_mod._worker_cmd()
    spawns = {"n": 0}

    def cmd():
        spawns["n"] += 1
        return _DIES_MID_PING if spawns["n"] == 1 else real

    monkeypatch.setattr(workers_mod, "_worker_cmd", cmd)
    ex = SubprocessExecutor(1, retries=1)
    try:
        ex.warm(timeout_s=120)          # first ping EOFs → replace → pong
        assert spawns["n"] == 2
        assert ex._procs[0].alive()     # the replacement holds the slot
    finally:
        ex.close()


def test_warm_exhausted_retries_surface_workerfault(monkeypatch):
    monkeypatch.setattr(workers_mod, "_worker_cmd",
                        lambda: list(_DIES_MID_PING))
    ex = SubprocessExecutor(1, retries=1)
    try:
        with pytest.raises(WorkerFault) as ei:
            ex.warm(timeout_s=60)
        assert ei.value.kind == "crash"
        assert ei.value.attempts == 2
    finally:
        ex.close()


# ---------------------------------------------------- binary framing -----
class _PipeChannel(_LineChannel):
    def __init__(self, fd):
        self._read_fd = fd
        self._buf = b""

    def _fd(self):
        return self._read_fd

    def alive(self):
        return True


def test_line_channel_survives_utf8_split_across_chunks():
    """The channel buffers raw bytes and decodes only complete lines, so
    a multi-byte UTF-8 sequence torn across read chunks (which the old
    per-chunk ``decode(errors="replace")`` corrupted) survives."""
    payload = json.dumps({"unit": "µs", "note": "naïve—reduction"},
                         ensure_ascii=False).encode()
    mid = payload.find("µ".encode()) + 1        # inside the 2-byte seq
    r, w = os.pipe()
    try:
        ch = _PipeChannel(r)
        os.write(w, payload[:mid])

        def finish():
            time.sleep(0.15)
            os.write(w, payload[mid:] + b"\n")

        t = threading.Thread(target=finish)
        t.start()
        got = ch.recv(10.0)
        t.join()
        assert got == {"unit": "µs", "note": "naïve—reduction"}
    finally:
        os.close(r)
        os.close(w)


def test_worker_pipes_are_binary():
    """The Popen must not wrap stdout in a TextIOWrapper: recv() reads
    the raw fd, and a text wrapper could strand bytes in its buffer."""
    ex = SubprocessExecutor(1)
    try:
        w = ex._ensure_worker(0, None)
        assert "b" in w.proc.stdout.mode
        assert "b" in w.proc.stdin.mode
        w.send({"ping": True})
        assert w.recv(120).get("pong")
    finally:
        ex.close()


# ------------------------------------------------- spec wire, per host ---
def test_default_namespaces_ship_as_none_pinned_ship_verbatim(tmp_path):
    derived = EvalCache(str(tmp_path / "c.jsonl"))
    spec = job_to_spec(_job(), _ctx(cache=derived), "c0")
    assert spec["cache"]["ns"] is None      # worker re-derives locally
    pinned = EvalCache(str(tmp_path / "c2.jsonl"), namespace="nsA")
    spec = job_to_spec(_job(), _ctx(cache=pinned), "c0")
    assert spec["cache"]["ns"] == "nsA"     # caller-pinned: verbatim
    assert PatternStore(str(tmp_path / "p.jsonl")).to_spec()["ns"] is None
    assert PatternStore(str(tmp_path / "p2.jsonl"),
                        namespace="nsB").to_spec()["ns"] == "nsB"


def test_lease_rederived_per_host_from_spec_scope(tmp_path, monkeypatch):
    cache = EvalCache(str(tmp_path / "c.jsonl"))
    spec = job_to_spec(_job(), _ctx(TorchCPUPlatform(), cache=cache), "cX")
    assert spec["host"] == this_host()
    assert spec["lease_scope"] == {"cache": cache.path, "scope": "cX"}
    # same host → the shipped lease is used as-is
    assert lease_for_spec(spec) == spec["lease"]
    # a worker on another host re-derives against ITS hostname
    monkeypatch.setenv("REPRO_HOST_ALIAS", "fleetB")
    local = lease_for_spec(dict(spec, host="scheduler-host"))
    assert local == cache.path + ".timelease@fleetB"
    assert local != spec["lease"]


def test_pinned_lease_crosses_hosts_verbatim(tmp_path, monkeypatch):
    """A caller-pinned lease path (no derivation scope) is an explicit
    instruction — e.g. a shared-NFS arbiter — and is never rewritten."""
    ctx = _ctx(TorchCPUPlatform(), lease_path="/shared/nfs.lease")
    spec = job_to_spec(_job(), ctx, "cY")
    assert spec["lease"] == "/shared/nfs.lease"
    assert spec["lease_scope"] is None
    monkeypatch.setenv("REPRO_HOST_ALIAS", "fleetB")
    assert lease_for_spec(dict(spec, host="elsewhere")) \
        == "/shared/nfs.lease"


def test_measured_records_reject_cross_host_analytic_replay(tmp_path,
                                                            monkeypatch):
    """The acceptance-criterion namespace rule: a measured record taken
    under host A's namespace must not replay on host B; analytic records
    (pure functions of the spec) replay everywhere."""
    path = str(tmp_path / "cache.jsonl")
    m_spec = canonical_spec("gemm", {"tile_m": 128}, 1, "torch-cpu")
    a_spec = canonical_spec("gemm", {"tile_m": 128}, 1, "h100-model")

    monkeypatch.setenv("REPRO_HOST_ALIAS", "hostA")
    ca = EvalCache(path)
    rec, hit = ca.get_or_compute(m_spec, lambda: EvalRecord(time_s=1.0),
                                 measured=True)
    assert not hit and "hostA" in rec.ns
    ca.get_or_compute(a_spec, lambda: EvalRecord(time_s=2.0),
                      measured=False)

    monkeypatch.setenv("REPRO_HOST_ALIAS", "hostB")
    cb = EvalCache(path)                      # same file, host B identity
    assert cb.lookup(m_spec) is None          # measured: rejected
    assert cb.stats()["stale"] == 1

    def never():
        raise AssertionError("analytic record should have replayed")

    rec, hit = cb.get_or_compute(a_spec, never, measured=False)
    assert hit and rec.time_s == 2.0          # analytic: replays
    # host B's own timing is stamped host B and serves host B
    rec, hit = cb.get_or_compute(m_spec, lambda: EvalRecord(time_s=3.0),
                                 measured=True)
    assert not hit and "hostB" in rec.ns
    assert cb.lookup(m_spec).time_s == 3.0


# ------------------------------------------------------ slot routing -----
def test_affinity_router_prefers_claim_then_unclaimed_then_steals():
    r = _AffinityRouter()
    j_gemm1, j_gemm2, j_atax = (_job("gemm"), _job("gemm", label="g2"),
                                _job("atax"))
    r.put((0, j_gemm1, {}, 0))
    r.put((1, j_gemm2, {}, 0))
    r.put((2, j_atax, {}, 0))
    got = r.get("hostA")
    assert got[1].case.name == "gemm"         # hostA claims gemm
    assert r.claim_of("gemm") == "hostA"
    got = r.get("hostB")
    assert got[1].case.name == "atax"         # prefers the unclaimed case
    got = r.get("hostB")
    assert got[1].case.name == "gemm"         # nothing else: steal...
    assert r.claim_of("gemm") == "hostA"      # ...without reassigning
    r.put((3, _job("atax", label="a2"), {}, 0))
    assert r.get("hostA")[1].case.name == "atax"   # steal works both ways
    assert r.claim_of("atax") == "hostB"
    r.close()
    assert r.get("hostA") is None


def test_affinity_router_fifo_for_hostless_consumers():
    r = _AffinityRouter()
    for i, c in enumerate(("gemm", "atax", "bicg")):
        r.put((i, _job(c), {}, 0))
    assert [r.get(None)[0] for _ in range(3)] == [0, 1, 2]


# ------------------------------------------------- config validation -----
def test_remote_executor_rejects_bad_fleet_configs():
    with pytest.raises(ValueError, match="at least one"):
        RemoteExecutor([])
    with pytest.raises(ValueError, match="duplicate"):
        RemoteExecutor(["a", "a"])
    with pytest.raises(ValueError, match="unknown transport"):
        RemoteExecutor([{"name": "x", "transport": "carrier-pigeon"}])
    with pytest.raises(ValueError, match="address"):
        RemoteExecutor([{"name": "x", "transport": "socket"}])
    with pytest.raises(ValueError, match="ssh="):
        RemoteExecutor([{"name": "x", "transport": "ssh"}])


def test_make_executor_remote_reads_fleet_env(monkeypatch):
    monkeypatch.delenv("REPRO_FLEET_HOSTS", raising=False)
    with pytest.raises(ValueError, match="REPRO_FLEET_HOSTS"):
        make_executor("remote")
    monkeypatch.setenv("REPRO_FLEET_HOSTS",
                       json.dumps(["h1", {"name": "h2", "slots": 2}]))
    ex = make_executor("remote")
    try:
        assert isinstance(ex, RemoteExecutor)
        assert ex.workers == 3
        assert set(ex.hosts) == {"h1", "h2"}
        assert ex.hosts["h1"].transport == "spawn"
        # round-robin interleave: short job lists spread across hosts
        assert [s[0] for s in ex._slots_for(_ctx(), 2)] == ["h1", "h2"]
    finally:
        ex.close()


# -------------------------------------------------- journal shipping -----
def _lines(path):
    with open(path, "rb") as f:
        return [ln for ln in f.read().split(b"\n") if ln.strip()]


def test_journal_link_ships_both_ways_without_echo(tmp_path):
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    link = JournalLink(a, b)
    with open(a, "w") as f:
        f.write('{"k": "a1"}\n{"k": "a2"}\n')
    with open(b, "w") as f:
        f.write('{"k": "b1"}\n')
    assert link.pump() == 3
    assert len(_lines(a)) == 3 and len(_lines(b)) == 3
    # echo suppression: repeated pumps ship nothing, files stay stable
    for _ in range(3):
        assert link.pump() == 0
    assert len(_lines(a)) == 3 and len(_lines(b)) == 3
    # an incomplete trailing line (write in flight) is not shipped
    with open(a, "a") as f:
        f.write('{"k": "torn')
    assert link.pump() == 0
    with open(a, "a") as f:
        f.write('-now-whole"}\n')
    assert link.pump() == 1
    assert b'{"k": "torn-now-whole"}' in _lines(b)


def test_tail_resets_on_truncated_or_rotated_source(tmp_path):
    """Regression: a source journal truncated/rotated below the tail's
    offset (no compaction marker) must reset to a safe offset with a
    warning — never read from the stale offset (which shipped garbage
    or raised) and never duplicate lines already shipped."""
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    link = JournalLink(a, b)
    with open(a, "w") as f:
        f.write('{"k": "a1"}\n{"k": "a2"}\n{"k": "a3"}\n')
    assert link.pump() == 3
    # rotate: the file shrinks below the tail offset, no marker inside
    with open(a, "w") as f:
        f.write('{"k": "a4"}\n')
    with pytest.warns(RuntimeWarning, match="rotation/truncation"):
        assert link.pump() == 1            # only the new line crosses
    got = _lines(b)
    assert got.count(b'{"k": "a4"}') == 1
    assert got.count(b'{"k": "a1"}') == 1  # no re-ship of old lines
    assert link.pump() == 0                # stable afterwards


def test_journal_link_no_duplicates_under_interleaved_writes(tmp_path):
    """Echo-suppression soak: both endpoints appending between pumps —
    after convergence each side holds exactly one copy of every line."""
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    link = JournalLink(a, b)
    expected = set()
    for i in range(6):
        la = json.dumps({"side": "a", "n": i}).encode()
        lb = json.dumps({"side": "b", "n": i}).encode()
        expected.update((la, lb))
        with open(a, "ab") as f:
            f.write(la + b"\n")
        if i % 2 == 0:
            link.pump()                    # interleave: ship mid-stream
        with open(b, "ab") as f:
            f.write(lb + b"\n")
        link.pump()
    for _ in range(3):
        link.pump()                        # converge
    for path in (a, b):
        got = _lines(path)
        assert set(got) == expected
        assert len(got) == len(expected), \
            f"duplicate lines in {path} after convergence"


def test_remote_executor_close_is_idempotent_and_exception_safe(tmp_path):
    """Leak-fix regression: close() twice is fine, and a run() that
    raises still tears down the spawned servers (no orphan
    remote_worker.py processes holding the port)."""
    ex = RemoteExecutor([{"name": "leakA"}])
    port = ex._server_port(ex.hosts["leakA"])     # spawn the server
    assert port > 0
    srv = ex._servers["leakA"]
    assert srv.alive()
    ex.close()
    assert not srv.alive() and ex._servers == {}
    ex.close()                                    # idempotent

    class Boom(RuntimeError):
        pass

    ex = RemoteExecutor([{"name": "leakB"}])
    ex._server_port(ex.hosts["leakB"])
    srv = ex._servers["leakB"]

    def explode(*a, **k):
        raise Boom("mid-campaign scheduler error")

    ex._slots_for = explode
    with pytest.raises(Boom):
        ex.run(_fleet_jobs()[:1], _ctx(), campaign_id="boom")
    ex.close()
    assert not srv.alive()


def test_replicator_background_convergence(tmp_path):
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    rep = Replicator(interval_s=0.05).start()
    try:
        rep.add(a, b)
        rep.add(a, b)                          # idempotent
        with open(a, "w") as f:
            f.write('{"n": 1}\n')
        deadline = time.time() + 10
        while time.time() < deadline and not os.path.exists(b):
            time.sleep(0.02)
        assert _lines(b) == [b'{"n": 1}']
    finally:
        rep.stop()
    assert rep.shipped == 1


# ------------------------------------------------------ fleet, e2e -------
FLEET_CASES = ("atax", "bicg", "gemm", "gesummv")


def _fleet_jobs():
    return [CaseJob(get_case(n), HeuristicProposer(0, platform="h100-model"), cfg=FAST_CFG,
                    constraints=FAST) for n in FLEET_CASES]


def _winners(results):
    return [(r.case_name, r.best_variant, round(r.best_time_s, 12))
            for r in results]


@pytest.fixture(scope="module")
def single_host_reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet_ref")
    camp = Campaign(model_platform(),
                    cache=EvalCache(str(tmp / "cache.jsonl")),
                    db=ResultsDB(str(tmp / "db.jsonl")),
                    executor=InProcessExecutor(2))
    results = camp.run(_fleet_jobs())
    assert all(isinstance(r, OptResult) for r in results)
    return _winners(results)


@pytest.mark.slow
def test_loopback_fleet_matches_single_host(tmp_path,
                                            single_host_reference):
    """The acceptance criterion: a 2-"host" loopback-socket campaign on
    the analytic legs produces winner records identical to the
    single-host SubprocessExecutor run, with per-host-namespaced cache
    records and journaled host provenance."""
    db = ResultsDB(str(tmp_path / "db.jsonl"))
    cache = EvalCache(str(tmp_path / "cache.jsonl"))
    ex = RemoteExecutor([{"name": "fleetA"}, {"name": "fleetB"}])
    camp = Campaign(model_platform(), cache=cache, db=db, executor=ex)
    try:
        ex.warm()                      # socket ping on every slot
        results = camp.run(_fleet_jobs())
    finally:
        ex.close()
    assert _winners(results) == single_host_reference
    # journaled host provenance: both simulated hosts did real work
    hosts = {r.get("host") for r in db.records("case_result")}
    assert hosts == {"fleetA", "fleetB"}
    assert {r.get("host") for r in db.records("round")} <= hosts
    # per-host namespaces: each worker re-derived the default namespace
    # under its own alias, so the shared cache file carries both
    cache_ns = {json.loads(ln)["ns"] for ln in _lines(cache.path)}
    assert any("fleetA" in ns for ns in cache_ns)
    assert any("fleetB" in ns for ns in cache_ns)


@pytest.mark.slow
def test_fleet_replication_without_shared_filesystem(tmp_path,
                                                     single_host_reference):
    """Hosts with journal path remaps get their appends tail-shipped to
    the scheduler's journals (and vice versa) by the replication loop —
    winners still identical, and the scheduler's cache ends up holding
    both hosts' records."""
    hosts = [FleetHost(name="repA",
                       cache_path=str(tmp_path / "hostA-cache.jsonl"),
                       db_path=str(tmp_path / "hostA-db.jsonl")),
             FleetHost(name="repB",
                       cache_path=str(tmp_path / "hostB-cache.jsonl"),
                       db_path=str(tmp_path / "hostB-db.jsonl"))]
    cache = EvalCache(str(tmp_path / "cache.jsonl"))
    db = ResultsDB(str(tmp_path / "db.jsonl"))
    ex = RemoteExecutor(hosts)
    camp = Campaign(model_platform(), cache=cache, db=db, executor=ex)
    try:
        results = camp.run(_fleet_jobs())
    finally:
        ex.close()
    assert _winners(results) == single_host_reference
    # every host journal's records were shipped home to the scheduler
    assert {r.get("host") for r in db.records("case_result")} \
        == {"repA", "repB"}
    assert len(cache) > 0
    sched_keys = {json.loads(ln)["key"] for ln in _lines(cache.path)}
    for h in hosts:
        host_keys = {json.loads(ln)["key"] for ln in _lines(h.cache_path)}
        assert host_keys <= sched_keys


# ------------------------------------------- against the JAX package -----
def test_journal_compacted_by_jax_replicates_through_the_port(tmp_path):
    """A PatternStore journal the JAX package wrote and compacted (its
    epoch marker last) ships through the port's ``JournalLink`` — the
    snapshot once, later appends after it, no marker across — and the
    replica replays to the merged state the JAX ``Replicator`` gives."""
    import warnings

    from repro.core import PatternStore as JPatternStore
    from repro.core import Replicator as JReplicator
    from repro.core import get_case as jget_case
    from repro.core.evalcache import marker_epoch as jmarker_epoch

    def view(store):
        return sorted((p.source_kernel, json.dumps(p.delta, sort_keys=True),
                       round(p.gain, 12)) for p in store.patterns)

    src = str(tmp_path / "pat.jsonl")
    port_dst, jax_dst = str(tmp_path / "port.jsonl"), \
        str(tmp_path / "jax.jsonl")
    js = JPatternStore(src)
    base = {"block_m": 64, "block_n": 64}
    for i in range(6):
        js.record(jget_case("gemm"), "h100", base,
                  dict(base, block_m=128 + 8 * i), 1.5 + i)
    link, jrep = JournalLink(src, port_dst), JReplicator()
    jrep.add(src, jax_dst)
    assert link.pump() == 6 and jrep.pump() == 6
    js.compact()                       # the JAX writer: snapshot + marker
    with open(src, "rb") as f:
        assert jmarker_epoch(f.read().splitlines()[-1]) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert link.pump() == 0        # resync past the marker
        jrep.pump()
    js.record(jget_case("syrk"), "h100", base, dict(base, block_n=128), 9.0)
    assert link.pump() == 1
    jrep.pump()
    jrep.stop()
    with open(port_dst, "rb") as f:
        got = [ln for ln in f.read().split(b"\n") if ln.strip()]
    assert len(got) == len(set(got)) == 7
    assert not any(b'"ev"' in ln for ln in got)
    assert view(PatternStore(port_dst)) == view(JPatternStore(jax_dst)) \
        == view(PatternStore(src))
    assert len(PatternStore(port_dst)) == 7
