"""The port's AdamW pieces and synthetic data against the JAX package:
the warmup + cosine schedule over steps 0–150, the weight-decay rule as it
acts on the reference's stacked layers (a kept difference from the rule's
comment, ROADMAP.md queue 3), ``global_norm`` and ``init_state``, and the
data stream bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import SyntheticLMData as JData
from repro.data import make_global_batch as jax_make_global_batch
from repro.models import get_model as jax_model
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import init_state as jax_init_state
from repro.train.optim import apply_update as jax_apply_update
from repro.train.optim import global_norm as jax_global_norm
from repro.train.optim import schedule as jax_schedule
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData, make_global_batch
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax
from repro_torch.train import (AdamWConfig, apply_update, init_state,
                               model_params)
from repro_torch.train.optim import decays, global_norm, schedule

CONFIGS = [dict(), dict(lr=1e-3, warmup_steps=20, total_steps=100_000),
           dict(lr=0.1, warmup_steps=0, total_steps=120, min_lr_ratio=0.0),
           dict(lr=3e-4, warmup_steps=50, total_steps=100, min_lr_ratio=0.3)]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: str(sorted(kw.items())))
def test_schedule_matches_jax_over_steps_0_to_150(kw):
    steps = np.arange(151)
    want = np.asarray(jax_schedule(JAdamWConfig(**kw),
                                   jnp.asarray(steps, jnp.int32)))
    got = schedule(AdamWConfig(**kw), torch.as_tensor(steps, dtype=torch.int32))
    assert got.dtype == torch.float32
    # cos near pi rounds an ulp apart in XLA and torch: 1e-7 of lr absolute
    atol = 1e-7 * AdamWConfig(**kw).lr
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=atol)
    for s in (0, 1, 75, 150):        # a python int as the step
        np.testing.assert_allclose(float(schedule(AdamWConfig(**kw), s)),
                                   want[s], rtol=1e-6, atol=atol)


def test_weight_decay_acts_on_the_reference_stacked_rank():
    """With zero gradients only weight decay moves a parameter.  The
    reference decays ``p.ndim >= 2`` of its stacked ``[L, ...]`` leaves, so
    a layer's norm scale ``ln1`` (``(L, d)``) moves by ``lr·wd·p`` while
    ``final_ln`` (``(d,)``) does not; the port's unstacked ``layers.i.ln1``
    (``(d,)``) moves as the reference's does."""
    cfg_kw = dict(lr=0.1, weight_decay=0.1, warmup_steps=0)
    jcfg = dataclasses.replace(jax_config("glm4-9b").reduced(),
                               param_dtype="float32")
    params = jax_model(jcfg).init_params(jax.random.PRNGKey(0))
    zeros = jax.tree.map(jnp.zeros_like, params)
    jnew, _, jm = jax_apply_update(JAdamWConfig(**cfg_kw), params, zeros,
                                   jax_init_state(params))
    lr = float(jm["lr"])
    cfg = dataclasses.replace(get_config("glm4-9b").reduced(),
                              param_dtype="float32")
    model = get_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray,
                                                            params)))
    p = model_params(model)
    new, _, m = apply_update(AdamWConfig(**cfg_kw), p,
                             {n: torch.zeros_like(t) for n, t in p.items()},
                             init_state(p))
    assert float(m["lr"]) == pytest.approx(lr, rel=1e-7)
    ln1 = np.asarray(params["layers"]["ln1"])
    np.testing.assert_allclose(np.asarray(jnew["layers"]["ln1"]),
                               ln1 * (1 - lr * 0.1), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(jnew["final_ln"]),
                                  np.asarray(params["final_ln"]))
    for i in range(cfg.n_layers):
        np.testing.assert_allclose(new[f"layers.{i}.ln1"].numpy(),
                                   np.asarray(jnew["layers"]["ln1"])[i],
                                   rtol=1e-6)
    torch.testing.assert_close(new["top.final_ln"], p["top.final_ln"],
                               rtol=0, atol=0)
    assert decays("layers.0.ln1", p["layers.0.ln1"])
    assert decays("top.embed", p["top.embed"])
    assert not decays("top.final_ln", p["top.final_ln"])


def test_global_norm_and_init_state():
    rng = np.random.default_rng(0)
    tree = {f"w{i}": rng.standard_normal(shape).astype(np.float32)
            for i, shape in enumerate([(3, 4), (5,), (2, 2, 2)])}
    want = float(jax_global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)
    params = {"a": torch.ones(3, 4, dtype=torch.bfloat16), "b": torch.ones(2)}
    state = init_state(params)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for moments in (state["mu"], state["nu"]):
        assert list(moments) == list(params)
        for n, t in moments.items():
            assert t.dtype == torch.float32 and t.shape == params[n].shape
            assert not t.any()


@pytest.mark.parametrize("arch,seq,batch,seed", [
    ("stablelm-3b", 32, 4, 3), ("glm4-9b", 128, 8, 0),
    ("whisper-medium", 17, 3, 5)])
def test_data_batches_bit_identical(arch, seq, batch, seed):
    jd = JData(jax_config(arch), seq, batch, seed=seed)
    pd = SyntheticLMData(get_config(arch), seq, batch, seed=seed)
    for step in (0, 1, 7, 123):
        want = jd.batch(step)
        got = pd.batch(step)
        for k in ("tokens", "targets"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
        jb = jax_make_global_batch(jd, step)
        tb = make_global_batch(pd, step, device="cpu")
        for k in ("tokens", "targets"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    np.testing.assert_array_equal(pd.host_batch(5, 1, 3)["tokens"],
                                  jd.host_batch(5, 1, 3)["tokens"])
