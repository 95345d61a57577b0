"""``BatchedServer`` on CUDA graphs, on a card: reduced models in float32
with the hand-written kernels at their sites (K2 at ``attention``, K6 at
``rwkv_wkv``, K7 at ``ssm_chunk``), random weights from a seeded generator.

* the graph server serves the eager server's tokens, request for request;
* ``aot_compiles`` is 1 + len(buckets) x len(row counts) at construction
  and again after an epoch bump (one decode graph alone for the recurrent
  families, which prefill eagerly at exact lengths);
* a re-capture mid-traffic leaves the live slots' cache bytes untouched;
* an install from the autotuner's thread while the main thread steps
  keeps every request's tokens equal to the control's;
* a failed capture raises (no eager fallback).

Imports no JAX, so it runs on the GPU machine:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_serve_graphs.py``.
Without a CUDA device every test skips (a CUDA graph has no CPU mode).
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import H100ModelPlatform, MEPConstraints, OptConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rwkv_wkv import wkv
from repro_torch.kernels.ssd_scan import ssd
from repro_torch.models import get_model
from repro_torch.models.ssm import stateful_site
from repro_torch.serve import AutotuneConfig, BatchedServer, ServeAutotuner

pytestmark = pytest.mark.cuda

SITES = {"glm4-9b": {"attention": flash_attention},
         "rwkv6-7b": {"rwkv_wkv": stateful_site(wkv)},
         "hymba-1.5b": {"ssm_chunk": stateful_site(ssd),
                        "attention": flash_attention}}
MAX_LEN = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    ops.clear_all()
    ops.telemetry.reset()
    yield torch.device("cuda")
    ops.clear_all()
    ops.telemetry.reset()


def model_of(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    model = get_model(cfg, device="cuda")
    model.init_params(torch.Generator(device="cuda").manual_seed(0))
    return model


def prompts(model, n=6, seed=0):
    """Ragged lengths; the recurrent families' chunked paths take a
    prompt of at most one chunk (8) or a multiple of it."""
    rng = np.random.default_rng(seed)
    lengths = ((3, 20, 9, 14, 3, 9) if model.cfg.family == "dense"
               else (3, 16, 8, 5, 24, 8))
    return [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
            for n in lengths[:n]]


def serve(srv, ps, max_new=5):
    reqs = [srv.submit(p, max_new=max_new) for p in ps]
    srv.run()
    assert all(r.done for r in reqs)
    return [r.tokens for r in reqs]


def install_kernels(arch):
    for site, fn in SITES[arch].items():
        ops.install(site, fn)


@pytest.mark.parametrize("arch", sorted(SITES))
def test_graph_server_serves_the_eager_tokens(cuda, arch):
    model = model_of(arch)
    install_kernels(arch)
    ps = prompts(model)
    eager = serve(BatchedServer(model, slots=4, max_len=MAX_LEN, aot=False),
                  ps)
    srv = BatchedServer(model, slots=4, max_len=MAX_LEN)
    assert srv.aot
    assert serve(srv, ps) == eager


@pytest.mark.parametrize("arch", ["glm4-9b", "rwkv6-7b"])
def test_aot_compiles_counts_captures_and_recaptures(cuda, arch):
    model = model_of(arch)
    install_kernels(arch)
    srv = BatchedServer(model, slots=4, max_len=MAX_LEN)
    rows = 3                                     # 1, 2, 4 packed rows
    want = 1 + len(srv.buckets) * rows if srv.padded_packing else 1
    assert srv.aot_compiles == want and srv.capture_s > 0
    serve(srv, prompts(model, 2))
    assert srv.aot_compiles == want              # served from the graphs
    ops.install("attention" if arch == "glm4-9b" else "rwkv_wkv",
                SITES[arch]["attention" if arch == "glm4-9b"
                            else "rwkv_wkv"])
    serve(srv, prompts(model, 2))
    assert srv.swap_epochs == 1 and srv.aot_compiles == 2 * want


@pytest.mark.parametrize("arch", ["glm4-9b", "hymba-1.5b"])
def test_recapture_leaves_the_live_rows_untouched(cuda, arch):
    model = model_of(arch)
    ps = prompts(model, 4)
    control = serve(BatchedServer(model, slots=4, max_len=MAX_LEN), ps)
    srv = BatchedServer(model, slots=4, max_len=MAX_LEN)
    reqs = [srv.submit(p, max_new=5) for p in ps]
    srv.step()
    srv.step()                     # requests in flight, partially decoded
    assert any(r.tokens and not r.done for r in reqs)
    before = {n: c.clone() for n, c in srv.cache.items()}
    install_kernels(arch)
    srv._refresh_impls()           # the step boundary's re-capture
    torch.cuda.synchronize()
    assert srv.swap_epochs == 1
    for name, c in srv.cache.items():
        assert torch.equal(c, before[name]), name
    srv.run()
    assert [r.tokens for r in reqs] == control


def test_autotuner_thread_install_while_main_steps(cuda):
    """The autotuner runs on its thread (campaign on ``h100-model``, FE and
    the guard probe through K2 on the card) while the main thread serves;
    the install bumps the epoch and the server re-captures under the
    device lock."""
    model = model_of("glm4-9b")
    ps = prompts(model, 6) + prompts(model, 6, seed=1)
    control = serve(BatchedServer(model, slots=4, max_len=MAX_LEN,
                                  aot=False), ps, max_new=8)
    srv = BatchedServer(model, slots=4, max_len=MAX_LEN)
    first = [srv.submit(p, max_new=8) for p in ps[:6]]
    srv.step()
    srv.step()
    tuner = ServeAutotuner(
        H100ModelPlatform(device="cuda"),
        config=AutotuneConfig(min_tokens=1, interval_s=0.01, probe_r=2,
                              max_regression=20.0,
                              opt=OptConfig(d_rounds=2, n_candidates=3, r=5,
                                            k=1),
                              constraints=MEPConstraints(t_max_s=2.0, r=5,
                                                         k=1)))
    tuner.start()
    try:
        deadline = time.time() + 120
        while not any(rep.installed for rep in list(tuner.reports)):
            assert time.time() < deadline, "no install within 120 s"
            if not srv.step():
                time.sleep(0.01)
        second = [srv.submit(p, max_new=8) for p in ps[6:]]
        srv.run()
    finally:
        tuner.stop()
    assert srv.swap_epochs >= 1
    assert srv.aot_compiles >= 2 * (1 + 3 * len(srv.buckets))
    assert [r.tokens for r in first + second] == control


def test_a_failed_capture_raises(cuda):
    """An impl that reads a value back to the host cannot be captured: the
    server refuses at construction, and at the swap epoch after such an
    install, instead of serving eagerly."""
    model = model_of("glm4-9b")

    def host_sync(q, k, v, causal=True, softcap=0.0):
        if float(q.abs().max()) < 0:           # a device-to-host read
            raise AssertionError
        return flash_attention(q, k, v, causal=causal, softcap=softcap)

    srv = BatchedServer(model, slots=2, max_len=MAX_LEN)
    srv.submit(prompts(model, 1)[0], max_new=3)
    srv.step()
    ops.install("attention", host_sync)
    for _ in range(2):             # met again at the next step boundary
        with pytest.raises(RuntimeError, match="CUDA graph capture"):
            srv.step()
        assert srv.swap_epochs == 0
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        BatchedServer(model, slots=2, max_len=MAX_LEN)
    torch.cuda.synchronize()
