"""The port's LLM proposer (``repro_torch.core.proposer``: ``LLMProposer``,
``LLMBatcher``, ``chat_completion``) against the JAX package's, offline.

No machine of this project has an endpoint, so every reply comes from a
scripted transport, as in ``tests/test_workers.py``'s coalescing tests,
which are mirrored here on the analytic ``h100-model`` (``device="cpu"``).
Then, (iii): one scripted transport gives both packages' proposers the
same parsed candidates, and the same ``ProposalError`` on the same garbage
replies; the prompts differ only where the port names the H100.  Without
an endpoint or a transport, ``chat_completion`` raises ``OfflineError`` in
both, and an ``llm`` campaign fails rather than turn heuristic.
"""
import json
import os
import sys
import threading
import time

import pytest
import torch

from repro.core import LLMBatcher as JLLMBatcher
from repro.core import LLMProposer as JLLMProposer
from repro.core import get_case as jget_case
from repro.core.diagnosis import classify as jclassify
from repro.core.proposer import OfflineError as JOfflineError
from repro.core.proposer import ProposalError as JProposalError
from repro.core.proposer import RoundState as JRoundState
from repro_torch.core import (Campaign, CaseJob, EvalCache,
                              H100ModelPlatform, LLMBatcher, LLMProposer,
                              MEPConstraints, OfflineError, OptConfig,
                              PopulationConfig, ProposalError,
                              chat_completion, get_case, make_proposer,
                              proposer_from_spec)
from repro_torch.core.diagnosis import classify
from repro_torch.core.proposer import PERSONAE, RoundState

FAST = MEPConstraints(t_max_s=2.0, r=5, k=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def offline(monkeypatch):
    for var in ("REPRO_LLM_ENDPOINT", "REPRO_LLM_MODEL",
                "REPRO_LLM_API_KEY"):
        monkeypatch.delenv(var, raising=False)


# --------------------------------------------------- LLM coalescing ------
def test_llm_batcher_one_endpoint_call_per_batch():
    calls = []

    def transport(prompt):
        calls.append(prompt)
        ids = [ln.split()[-1] for ln in prompt.splitlines()
               if ln.startswith("### ")]
        if not ids:                      # single-item batch: raw prompt
            return json.dumps([{"block_m": 64}])
        return json.dumps({i: [{"block_m": 64}] for i in ids})

    batcher = LLMBatcher(transport, max_batch=8, linger_s=5.0)
    for _ in range(3):
        batcher.register()
    out = [None] * 3
    threads = [threading.Thread(
        target=lambda i=i: out.__setitem__(
            i, batcher.submit(f"optimize kernel {i}")))
        for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(calls) == 1, "coalesced batch must make ONE endpoint call"
    assert batcher.calls == 1 and batcher.coalesced == 3
    for text in out:
        assert json.loads(text) == [{"block_m": 64}]
    # a single registered participant dispatches immediately (no linger)
    for _ in range(3):
        batcher.unregister()
    batcher.register()
    t0 = time.time()
    assert json.loads(batcher.submit("solo"))
    assert time.time() - t0 < 2.0
    assert len(calls) == 2


def test_batcher_routes_every_answer_under_thread_stress():
    """More submitting threads than cores, a short switch interval, and
    participants leaving mid-run: every prompt gets its own answer (the
    transport echoes each section's prompt back), and the batcher's
    counters add up to the prompts submitted."""
    n_threads, n_rounds = 2 * len(os.sched_getaffinity(0)) + 1, 3

    def transport(prompt):
        sections, cur = {}, None
        for ln in prompt.splitlines():
            if ln.startswith("### "):
                cur = ln.split()[-1]
                sections[cur] = []
            elif cur is not None and ln:
                sections[cur].append(ln)
        if not sections:
            return json.dumps(prompt)
        return json.dumps({sid: "\n".join(lines)
                           for sid, lines in sections.items()})

    batcher = LLMBatcher(transport, max_batch=8, linger_s=0.05)
    wrong, done = [], []
    interval = sys.getswitchinterval()
    for _ in range(n_threads):        # every participant, before any submits
        batcher.register()

    def worker(i):
        try:
            for r in range(n_rounds):
                prompt = f"thread {i} round {r}"
                if json.loads(batcher.submit(prompt)) != prompt:
                    wrong.append(prompt)
            done.append(i)
        finally:
            batcher.unregister()

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not wrong and sorted(done) == list(range(n_threads))
    assert batcher.coalesced == n_threads * n_rounds
    assert batcher.calls < batcher.coalesced


def test_campaign_coalesces_llm_round_prompts():
    """An in-process campaign over concurrent LLM-proposer cases makes one
    endpoint call per round wave, not one per case."""
    calls = []

    def transport(prompt):
        calls.append(prompt)
        ids = [ln.split()[-1] for ln in prompt.splitlines()
               if ln.startswith("### ")]
        if not ids:
            return json.dumps([{"block_m": 256}])
        return json.dumps({i: [{"block_m": 256}] for i in ids})

    cases = ["gemm", "syrk", "syr2k"]
    proposers = [LLMProposer() for _ in cases]
    jobs = [CaseJob(get_case(name), p, cfg=OptConfig(
        d_rounds=1, n_candidates=2, r=5, k=1), constraints=FAST)
        for name, p in zip(cases, proposers)]
    camp = Campaign(H100ModelPlatform(device="cpu"), cache=EvalCache(),
                    max_workers=len(jobs))
    ex = camp.executor
    holder = {}
    orig = ex._attach_batcher

    def attach(jobs_):
        b = orig(jobs_)
        assert b is not None
        b._transport = transport
        holder["b"] = b
        return b

    ex._attach_batcher = attach
    results = camp.run(jobs)
    assert all(r.rounds for r in results)
    b = holder["b"]
    assert b.coalesced >= len(cases)
    assert b.calls < b.coalesced, \
        f"{b.calls} endpoint calls for {b.coalesced} prompts — no coalescing"
    assert all(p.batcher is b for p in proposers)


def test_population_jobs_size_the_batcher_to_their_waves():
    """Population jobs contribute one prompt a persona a wave: the shared
    batcher's ``max_batch`` is the sum of the jobs' wave widths."""
    pcfg = PopulationConfig(personae=("tiling", "memory", "sync"))
    jobs = [CaseJob(get_case(n), LLMProposer(), cfg=OptConfig(
        population=pcfg if n == "gemm" else None), constraints=FAST)
        for n in ("gemm", "syrk")]
    camp = Campaign(H100ModelPlatform(device="cpu"), max_workers=2)
    b = camp.executor._attach_batcher(jobs)
    assert b.max_batch == 3 + 1 and b._active == 2
    assert all(j.proposer.batcher is b for j in jobs)
    # one worker, or a single LLM job: nothing to coalesce across cases
    assert Campaign(H100ModelPlatform(device="cpu"), max_workers=1) \
        .executor._attach_batcher([CaseJob(get_case("gemm"),
                                           LLMProposer())]) is None


# ---------------------------------------------- offline, by construction --
def test_chat_completion_without_an_endpoint_raises_offline(offline):
    with pytest.raises(OfflineError, match="REPRO_LLM_ENDPOINT"):
        chat_completion("hi", endpoint=None, model="o3")
    with pytest.raises(OfflineError):
        LLMBatcher(max_batch=1).submit("hi")
    with pytest.raises(JOfflineError):
        JLLMBatcher(max_batch=1).submit("hi")


def test_make_proposer_builds_the_llm_proposer(offline):
    p = make_proposer("llm", platform="h100")
    assert isinstance(p, LLMProposer) and p.name == "llm"
    assert p.repair_key == "llm" and p.endpoint is None
    back = proposer_from_spec(dict(p.with_persona("sync").to_spec()))
    assert isinstance(back, LLMProposer)
    assert (back.platform, back.persona) == ("h100", "sync")
    with pytest.raises(ValueError):
        make_proposer("oracle")


def test_an_llm_campaign_without_an_endpoint_fails(offline):
    """No endpoint and no transport: the greedy loop's first proposal
    raises ``OfflineError`` and the campaign fails; it never turns
    heuristic."""
    job = CaseJob(get_case("gemm"), LLMProposer(), cfg=OptConfig(
        d_rounds=1, n_candidates=2, r=5, k=1), constraints=FAST)
    with pytest.raises(RuntimeError, match="failed") as e:
        Campaign(H100ModelPlatform(device="cpu"), max_workers=1).run([job])
    assert isinstance(e.value.__cause__, OfflineError)


def test_an_offline_population_wave_records_every_persona_error(offline):
    """In a population wave each persona's ``OfflineError`` is isolated
    and recorded, as the reference records it; nothing is evaluated and
    the search stops on an empty wave, with the baseline as its result."""
    job = CaseJob(get_case("gemm"), LLMProposer(), cfg=OptConfig(
        r=5, k=1, population=PopulationConfig(generations=2,
                                              migrate=False)),
        constraints=FAST)
    res = Campaign(H100ModelPlatform(device="cpu"),
                   max_workers=1).run([job])[0]
    g0 = res.rounds[0]
    assert {p: st.get("errors") for p, st in g0.personae.items()} == \
        dict.fromkeys(PERSONAE, 1)
    assert not g0.candidates and res.speedup == 1.0
    assert res.stop_reason == "wave exhausted (no novel candidates)"


# ---------------------------------------- (iii) parity with the JAX side --
GARBAGE = {
    "refusal": "I'd rather not answer in JSON today.",
    "malformed": '[{"block_m": 64,, }]',
    "not a list": '{"block_m": 64}',
    "not a dict": "[64, 128]",
    "outside the space": '[{"block_m": 48}]',
}
GOOD = [
    '[{"block_m": 64}, {"compute_dtype": "bf16", "fuse_epilogue": true}]',
    'Sure! Here: [{"block_n": 256, "block_k": 64, "unknown_knob": 3}] ok',
    "[]",
    '[{"block_m": 128}, {"block_m": 256}, {"block_n": 32}, '
    '{"block_k": 32}]',
]


def _states(case, jcase):
    diag_terms = (0.2, 0.7, 0.05)
    kw = dict(round=1, baseline_variant=dict(case.baseline_variant),
              baseline_time_s=1e-3,
              feedback={"flops": 2e9, "traffic_bytes": 1.2e7,
                        "arithmetic_intensity": 166.7},
              errors=["FloatingPointError: FE violation: x"],
              hints=[{"block_m": 128}])
    return (RoundState(diagnosis=classify(*diag_terms), **kw),
            JRoundState(diagnosis=jclassify(*diag_terms), **kw))


def _outcome(proposer, case, state, n=3):
    try:
        return ("ok", proposer.propose(case, state, n))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("persona", ("",) + PERSONAE)
def test_one_transport_gives_both_packages_the_same_candidates(persona):
    """Every reply, good or garbage, through each package's proposer (one
    persona, or none): the same parsed variants, or the same
    ``ProposalError`` text."""
    case, jcase = get_case("gemm"), jget_case("gemm")
    state, jstate = _states(case, jcase)
    for reply in GOOD + list(GARBAGE.values()):
        def transport(prompt, reply=reply):
            return reply
        p = LLMProposer(batcher=LLMBatcher(transport, max_batch=1))
        jp = JLLMProposer(batcher=JLLMBatcher(transport, max_batch=1))
        if persona:
            p, jp = p.with_persona(persona), jp.with_persona(persona)
        got, want = _outcome(p, case, state), _outcome(jp, jcase, jstate)
        assert got == want
        if reply in GARBAGE.values():
            assert got[0] == "ProposalError"
            assert isinstance(pytest.raises(
                ProposalError, p.propose, case, state, 3).value,
                RuntimeError)
            with pytest.raises(JProposalError):
                jp.propose(jcase, jstate, 3)
        else:
            assert got[0] == "ok"


def test_the_repair_reply_is_parsed_as_the_jax_side_parses_it():
    """``repair``: a good reply gives the same fixed variant; a garbage or
    out-of-space reply defers to AER (None) in both."""
    case, jcase = get_case("gemm"), jget_case("gemm")
    bad = dict(case.baseline_variant, block_m=256)
    for reply in ('{"block_m": 128}', "no idea", '{"block_m": 48}'):
        p, jp = LLMProposer(), JLLMProposer()
        p._chat = jp._chat = lambda prompt, reply=reply: reply
        assert p.repair(case, bad, "MemoryError: smem") == \
            jp.repair(jcase, bad, "MemoryError: smem")


def test_the_prompts_differ_only_in_naming_the_card():
    """The round prompt and persona preambles are the reference's, but for
    the card: the H100 and its tensor-core tile fill and shared memory a
    block stand where the JAX package names the TPU, MXU and VMEM."""
    case, jcase = get_case("gemm"), jget_case("gemm")
    state, jstate = _states(case, jcase)
    for persona in ("",) + PERSONAE:
        sent, jsent = [], []
        p = LLMProposer(batcher=LLMBatcher(
            lambda pr: sent.append(pr) or "[]", max_batch=1))
        jp = JLLMProposer(batcher=JLLMBatcher(
            lambda pr: jsent.append(pr) or "[]", max_batch=1))
        if persona:
            p, jp = p.with_persona(persona), jp.with_persona(persona)
        p.propose(case, state, 2)
        jp.propose(jcase, jstate, 2)
        (prompt,), (jprompt,) = sent, jsent
        assert "TPU" not in prompt and "MXU" not in prompt \
            and "VMEM" not in prompt
        assert "NVIDIA H100 kernel" in prompt
        jprompt = jprompt.replace("a TPU kernel", "an NVIDIA H100 kernel") \
            .replace("MXU alignment and VMEM fit",
                     "tensor-core tile fill and shared memory a block")
        # the diagnosis summary names the card's quantities too
        strip = [ln for ln in prompt.splitlines()
                 if not ln.startswith("Profiler feedback")]
        jstrip = [ln for ln in jprompt.splitlines()
                  if not ln.startswith("Profiler feedback")]
        assert strip == jstrip
    assert LLMBatcher.HEADER == JLLMBatcher.HEADER.replace("TPU", "H100")
