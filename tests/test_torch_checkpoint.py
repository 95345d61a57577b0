"""Fault tolerance on the port (``tests/test_fault_tolerance.py``
mirrored, but for its mesh test, which waits for sharding): atomic
checkpoints in the reference's layout, restart-replay determinism,
straggler detection, int8 error-feedback compression bit for bit against
the JAX package; and what the port's in-place state adds: a failure inside
the AdamW update leaves the state as it was, an async save of CPU tensors
is not torn by the next in-place step, a bf16 leaf is saved as its bits.
"""
import dataclasses
import json
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import compress_ef_int8 as jax_compress
from repro.runtime import make_compression_hook as jax_hook
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData, make_global_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model
from repro_torch.runtime import (FailureInjector, FaultTolerantLoop,
                                 StragglerWatchdog, compress_ef_int8,
                                 make_compression_hook)
from repro_torch.train import (AdamWConfig, init_state, make_train_step,
                               model_params, optim)


def _tiny(**step_kw):
    cfg = dataclasses.replace(get_config("stablelm-3b").reduced(),
                              param_dtype="float32")
    model = get_model(cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    data = SyntheticLMData(cfg, 32, 4, seed=3)
    step_fn = make_train_step(model, AdamWConfig(lr=1e-3), **step_kw)
    return cfg, model, data, step_fn


def _run(path, model, data, step_fn, fail_at=None, checkpoint_every=4,
         num_steps=10, async_save=False):
    mgr = CheckpointManager(str(path), keep=2, async_save=async_save)
    loop = FaultTolerantLoop(mgr, checkpoint_every=checkpoint_every,
                             injector=FailureInjector(fail_at or {}))
    params = model_params(model)
    state = {"params": params, "opt": init_state(params)}

    def one(state, step):
        p, o, m = step_fn(state["params"], state["opt"],
                          make_global_batch(data, step, device="cpu"))
        return {"params": p, "opt": o}, m

    state, final = loop.run(state, one, num_steps=num_steps)
    return state, loop, final


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _assert_trees_equal(a, b, **tol):
    tol = tol or dict(rtol=0, atol=0)
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], **tol)
        else:
            torch.testing.assert_close(a[k], b[k], **tol)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((2,), dtype=torch.int32)}}
    save_checkpoint(str(tmp_path), 7, tree, extra={"note": "x"})
    like = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(2, dtype=torch.int32)}}
    got, step, extra = load_checkpoint(str(tmp_path), like)
    assert step == 7 and extra == {"note": "x"}
    _assert_trees_equal(got, tree)
    # restored into the live tensors of like_tree
    assert got["a"] is like["a"] and got["b"]["c"] is like["b"]["c"]
    with pytest.raises(TypeError, match="/x is a ndarray, not a tensor"):
        save_checkpoint(str(tmp_path), 8, {"x": np.zeros(3)})


def test_checkpoint_layout_and_bf16_bits(tmp_path):
    """``step_<N>/leaf_<i>.npy`` + ``manifest.json``, leaves in sorted key
    order; a bf16 leaf is stored as its uint16 bits and restored bit for
    bit."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(5, 3, generator=g).to(torch.bfloat16)
    tree = {"z": torch.arange(3), "w": w, "m": {"b": torch.ones(2),
                                               "a": torch.zeros(1)}}
    save_checkpoint(str(tmp_path), 3, tree)
    d = tmp_path / "step_00000003"
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["n_leaves"] == 4
    assert manifest["treedef"] == ["/m/a", "/m/b", "/w", "/z"]
    assert manifest["dtypes"] == ["float32", "float32", "bfloat16", "int64"]
    bits = np.load(d / "leaf_00002.npy")
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(bits.view(np.int16),
                                  w.view(torch.int16).numpy())
    like = {"z": torch.zeros(3, dtype=torch.int64),
            "w": torch.zeros(5, 3, dtype=torch.bfloat16),
            "m": {"a": torch.ones(1), "b": torch.zeros(2)}}
    got, _, _ = load_checkpoint(str(tmp_path), like)
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
    assert list(got) == list(like)             # like_tree's key order
    _assert_trees_equal(got, {"z": tree["z"], "w": w,
                              "m": {"a": tree["m"]["a"], "b": tree["m"]["b"]}})


def test_checkpoint_retention_and_latest(tmp_path):
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), s, tree, keep=2)
    assert latest_step(str(tmp_path)) == 4
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(kept) == 2


def test_checkpoint_atomicity_tmpdir_ignored(tmp_path):
    tree = {"x": torch.zeros(3)}
    save_checkpoint(str(tmp_path), 1, tree)
    # a crashed half-written save must be invisible
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert latest_step(str(tmp_path)) == 1


def test_failure_restart_replays_identically(tmp_path):
    """Training with an injected failure converges to exactly the same
    params as a run without failure (checkpoint + step-keyed data)."""
    runs = []
    for inject in (True, False):
        _, model, data, step_fn = _tiny()
        state, loop, final = _run(tmp_path / str(inject), model, data,
                                  step_fn, fail_at={6: 1} if inject else {})
        runs.append((state, loop, final))
    (s1, loop1, f1), (s2, loop2, f2) = runs
    assert loop1.restarts == 1 and loop2.restarts == 0
    assert f1 == f2 == 10
    _assert_trees_equal(s1["params"], s2["params"], rtol=1e-6, atol=1e-6)


def test_a_failure_during_an_async_save_restores_that_checkpoint(
        tmp_path, monkeypatch):
    """A failure two steps after an async save, while its writer is still
    on its way, restores that checkpoint (``latest`` waits for the write):
    the run ends at the uninterrupted run's parameters.  Seen on the card,
    where a reduced step takes milliseconds."""
    real_save = np.save
    calls = {"n": 0}

    def slow_save(path, arr, *args, **kw):
        calls["n"] += 1
        if str(path).endswith("leaf_00000.npy"):
            time.sleep(0.5)
        return real_save(path, arr, *args, **kw)
    monkeypatch.setattr(store.np, "save", slow_save)
    runs = []
    for inject in (True, False):
        _, model, data, step_fn = _tiny()
        runs.append(_run(tmp_path / str(inject), model, data, step_fn,
                         fail_at={6: 1} if inject else {}, async_save=True))
    (s1, loop1, f1), (s2, loop2, f2) = runs
    assert loop1.restarts == 1 and loop2.restarts == 0 and f1 == f2 == 10
    assert calls["n"] > 0
    _assert_trees_equal(s1["params"], s2["params"], rtol=1e-6, atol=1e-6)


def test_failure_inside_the_update_leaves_the_state(tmp_path, monkeypatch):
    """A step that raises half way through the AdamW update leaves
    parameters and moments as they were, so the loop's replay from the last
    good step (no checkpoint yet) equals the uninterrupted run."""
    real = optim._update_leaf
    calls = {"n": 0, "armed": True}

    def flaky(*args):
        calls["n"] += 1
        if calls["armed"] and calls["n"] == 7:     # mid-way through the leaves
            calls["armed"] = False
            raise RuntimeError("injected failure inside the update")
        return real(*args)

    # the state after a failed call is the state before it, bit for bit
    _, model, data, step_fn = _tiny()
    params = model_params(model)
    opt = init_state(params)
    batch = make_global_batch(data, 0, device="cpu")
    params, opt, _ = step_fn(params, opt, batch)
    before = _clone({"params": params, "opt": {k: v for k, v in opt.items()}})
    monkeypatch.setattr(optim, "_update_leaf", flaky)
    with pytest.raises(RuntimeError, match="inside the update"):
        step_fn(params, opt, make_global_batch(data, 1, device="cpu"))
    assert calls["n"] == 7
    _assert_trees_equal({"params": params, "opt": opt}, before)

    # the loop replays: fail at step 0's update, with no checkpoint yet
    calls.update(n=0, armed=True)
    _, model, data, step_fn = _tiny()
    s1, loop1, _ = _run(tmp_path / "a", model, data, step_fn,
                        checkpoint_every=100, num_steps=5)
    monkeypatch.setattr(optim, "_update_leaf", real)
    _, model, data, step_fn = _tiny()
    s2, loop2, _ = _run(tmp_path / "b", model, data, step_fn,
                        checkpoint_every=100, num_steps=5)
    assert loop1.restarts == 1 and loop2.restarts == 0
    _assert_trees_equal(s1, s2)


def test_async_save_is_not_torn_by_the_next_in_place_step(tmp_path,
                                                          monkeypatch):
    """``CheckpointManager.save`` snapshots CPU tensors by copy: a train
    step that changes them in place right after the save (the writer
    thread held back until the step is done) does not reach the
    checkpoint."""
    real_save = np.save
    step_done = threading.Event()

    def held_save(*args, **kw):
        assert step_done.wait(timeout=60)
        return real_save(*args, **kw)
    monkeypatch.setattr(store.np, "save", held_save)
    _, model, data, step_fn = _tiny()
    params = model_params(model)
    state = {"params": params, "opt": init_state(params)}
    want = _clone({"params": params, "opt": {"mu": state["opt"]["mu"],
                                             "nu": state["opt"]["nu"],
                                             "step": state["opt"]["step"]}})
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(0, state)
    p, o, _ = step_fn(params, state["opt"],
                      make_global_batch(data, 0, device="cpu"))
    assert any(not torch.equal(p[n], want["params"][n]) for n in p)
    step_done.set()
    mgr.wait()
    like = {"params": {n: torch.empty_like(t) for n, t in p.items()},
            "opt": {"mu": {n: torch.empty_like(t) for n, t in o["mu"].items()},
                    "nu": {n: torch.empty_like(t) for n, t in o["nu"].items()},
                    "step": torch.empty_like(o["step"])}}
    got, step, _ = mgr.restore(like)
    assert step == 0
    _assert_trees_equal(got, want)


def test_straggler_watchdog_flags_slow_steps():
    wd = StragglerWatchdog(factor=3.0, min_samples=2)
    for s in range(4):
        wd.observe(s, 0.01)
    assert wd.observe(4, 0.2)            # 20× slower → flagged
    assert wd.flagged == [4]
    assert not wd.observe(5, 0.011)


# ------------------------------------------------------------ compression -
def test_compress_ef_int8_error_feedback_bounds_error():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal(512).astype(np.float32)) * 0.01
    res = torch.zeros_like(g)
    total_true = torch.zeros_like(g)
    total_deq = torch.zeros_like(g)
    for _ in range(50):
        q, scale, res = compress_ef_int8(g, res)
        total_deq = total_deq + q.float() * scale
        total_true = total_true + g
    # with error feedback the accumulated error stays O(one quantum),
    # not O(steps)
    quantum = float(g.abs().max()) / 127.0
    err = float((total_deq + res - total_true).abs().max())
    assert err <= 3 * quantum


@pytest.mark.parametrize("seed", range(4))
def test_compress_ef_int8_bit_exact_against_jax(seed):
    """int8 values, scale and residual equal the reference's bit for bit
    over 20 error-feedback steps (both round half to even); one input holds
    exact .5 quanta."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(1000) * 10.0 ** rng.uniform(-4, 1)).astype(
        np.float32)
    if seed == 0:
        g = (np.arange(-508, 508, dtype=np.float32) / 2)[:1000]
    jres, pres = jnp.zeros(g.shape, jnp.float32), torch.zeros(g.shape)
    for _ in range(20):
        jq, jscale, jres = jax_compress(jnp.asarray(g), jres)
        pq, pscale, pres = compress_ef_int8(torch.from_numpy(g), pres)
        assert pq.dtype == torch.int8
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
        assert np.float32(pscale.item()).tobytes() == \
            np.asarray(jscale, np.float32).tobytes()
        np.testing.assert_array_equal(pres.numpy().view(np.int32),
                                      np.asarray(jres).view(np.int32))


def test_compression_hook_bit_exact_against_jax():
    rng = np.random.default_rng(7)
    jref, pref = {"value": None}, {"value": None}
    jh, ph = jax_hook(jref), make_compression_hook(pref)
    for _ in range(3):
        grads = {"a": rng.standard_normal((4, 8)).astype(np.float32),
                 "b": rng.standard_normal(5).astype(np.float32) * 1e-3}
        jout = jh({k: jnp.asarray(v) for k, v in grads.items()})
        pout = ph({k: torch.from_numpy(v) for k, v in grads.items()})
        for k in grads:
            np.testing.assert_array_equal(pout[k].numpy(), np.asarray(jout[k]))
            np.testing.assert_array_equal(pref["value"][k].numpy(),
                                          np.asarray(jref["value"][k]))


def test_compression_hook_trains():
    _, model, data, _ = _tiny()
    residuals = {"value": None}
    step_fn = make_train_step(model, AdamWConfig(lr=1e-3),
                              grad_hook=make_compression_hook(residuals))
    params = model_params(model)
    before = {n: p.clone() for n, p in params.items()}
    p, o, m = step_fn(params, init_state(params),
                      make_global_batch(data, 0, device="cpu"))
    assert np.isfinite(m["loss"].item())
    delta = max(float((before[n] - p[n]).abs().max()) for n in p)
    assert delta > 0
    assert set(residuals["value"]) == set(params)


def test_launcher_trains_restarts_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "stablelm-3b", "--smoke", "--device", "cpu",
            "--steps", "6", "--batch", "4", "--seq", "32", "--ckpt",
            str(tmp_path), "--checkpoint-every", "2",
            "--inject-failure-at", "3", "--log-every", "1"]
    launch_train.main(argv)
    out = capsys.readouterr().out
    assert "arch=stablelm-3b-smoke" in out and "device=cpu" in out
    assert "done at step 6" in out and "restarts=1" in out
    assert latest_step(str(tmp_path)) == 6
    launch_train.main(argv[:5] + ["--steps", "2"] + argv[7:])
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "done at step 8" in out
