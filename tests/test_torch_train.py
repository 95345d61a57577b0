"""The port's training path against the JAX package: ``loss``, its
gradients and one AdamW update, for the dense-path configs at their reduced
sizes in float32 on converted parameters (the moe, recurrent and
encoder–decoder configs are in ``test_torch_train_families.py``, which
imports the helpers here); and the reference's own train-step smoke checks
(``tests/test_arch_smoke.py``) on the port, for all ten configs.

Inputs are drawn with numpy from a seed; three targets of the first row are
``-1`` (padding).  Tolerances, in float32:

* the loss and its metrics within 1e-5 relative (seen: equal to 5e-7);
* each gradient within 1e-5 relative plus 1e-5 of the model's largest
  gradient (seen: 7.5e-6 of a leaf's largest; the encoder–decoder's key
  biases have gradients that are zero but for rounding on both sides,
  which only the second term can hold);
* parameters and moments after one ``apply_update`` of the same gradients
  within 1e-6 relative and absolute.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import get_model as jax_model
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import init_state as jax_init_state
from repro.train.optim import apply_update as jax_apply_update
from repro_torch.configs import get_config, list_archs
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax
from repro_torch.train import (AdamWConfig, apply_update, init_state,
                               make_train_step, model_params)

ARCHS = ("glm4-9b", "stablelm-3b", "codeqwen1.5-7b", "command-r-35b",
         "chameleon-34b")
B, S = 2, 32
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
UPDATE_TOL = 1e-6
OPT = dict(lr=1e-2, warmup_steps=0, weight_decay=0.1)


def reduced(get, arch):
    return dataclasses.replace(get(arch).reduced(), param_dtype="float32")


def batches(cfg, seed=1):
    """(JAX batch, port batch) of the same numpy draw."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    targets[0, :3] = -1
    host = {"tokens": tokens, "targets": targets}
    if cfg.family == "encdec":
        host["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(v) for k, v in host.items()})


def port_model(cfg, params_np):
    model = get_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, params_np))
    return model


def port_grads(model, batch):
    """(loss, metrics, grads by name) of the port's model on ``batch``."""
    params = model_params(model)
    for p in params.values():
        p.requires_grad_(True)
    try:
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
    finally:
        for p in params.values():
            p.requires_grad_(False)
    return loss.detach(), metrics, dict(zip(params, grads))


@functools.lru_cache(maxsize=None)
def case(arch):
    """Both packages' loss, metrics and gradients of one reduced config."""
    jcfg, cfg = reduced(jax_config, arch), reduced(get_config, arch)
    jm = jax_model(jcfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    jb, pb = batches(jcfg)
    (jloss, jmetrics), jgrads = jax.jit(
        jax.value_and_grad(jm.loss, has_aux=True))(params, jb)
    model = port_model(cfg, params_np)
    loss, metrics, grads = port_grads(model, pb)
    return {"cfg": cfg, "jcfg": jcfg, "params": params, "model": model,
            "jloss": float(jloss),
            "jmetrics": {k: float(v) for k, v in jmetrics.items()},
            "jgrads": jgrads, "loss": loss, "metrics": metrics,
            "grads": grads}


def check_loss(arch):
    c = case(arch)
    np.testing.assert_allclose(c["loss"].item(), c["jloss"], rtol=LOSS_RTOL)
    assert set(c["metrics"]) == set(c["jmetrics"])
    for k, v in c["jmetrics"].items():
        np.testing.assert_allclose(c["metrics"][k].item(), v,
                                   rtol=LOSS_RTOL, atol=1e-7)


def check_grads(arch):
    c = case(arch)
    want = params_from_jax(c["cfg"], jax.tree.map(np.asarray, c["jgrads"]))
    assert set(want) == set(c["grads"])
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(c["grads"][name].numpy(), w.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                                   err_msg=f"{arch} {name}")


def check_update(arch):
    """One AdamW step of the JAX gradients in each package, from zero
    moments: parameters, moments, step, grad norm and lr."""
    c = case(arch)
    cfg = c["cfg"]
    jnew, jstate, jm = jax.jit(jax_apply_update, static_argnums=0)(
        JAdamWConfig(**OPT), c["params"], c["jgrads"],
        jax_init_state(c["params"]))
    params = model_params(c["model"])
    grads = params_from_jax(cfg, jax.tree.map(np.asarray, c["jgrads"]))
    new, state, m = apply_update(AdamWConfig(**OPT), params, grads,
                                 init_state(params))
    to_np = functools.partial(jax.tree.map, np.asarray)
    for got, want in ((new, jnew), (state["mu"], jstate["mu"]),
                      (state["nu"], jstate["nu"])):
        want = params_from_jax(cfg, to_np(want))
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       rtol=UPDATE_TOL, atol=UPDATE_TOL,
                                       err_msg=f"{arch} {name}")
    assert int(state["step"]) == int(jstate["step"]) == 1
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-7)
    # the update is functional: the model's own parameters are untouched
    for name, p in params.items():
        torch.testing.assert_close(p, params_from_jax(
            cfg, to_np(c["params"]))[name], rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    check_loss(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_update_matches_jax(arch):
    check_update(arch)


# ---- the reference's train-step smoke checks (test_arch_smoke.py) --------
def smoke_setup(arch):
    cfg = reduced(get_config, arch)
    model = get_model(cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
             "targets": torch.randint(0, cfg.vocab_size, (B, S),
                                      generator=g)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(B, cfg.encoder.n_frames, cfg.d_model,
                                      generator=g)
    return cfg, model, batch


@pytest.mark.parametrize("arch", list_archs())
def test_forward_loss_finite(arch):
    cfg, model, batch = smoke_setup(arch)
    with torch.no_grad():
        loss, _ = model.loss(batch)
    assert loss.shape == ()
    assert np.isfinite(loss.item()), f"{arch} loss not finite"
    # random init ⇒ loss ≈ ln(vocab)
    assert abs(loss.item() - np.log(cfg.vocab_size)) < 1.5


@pytest.mark.parametrize("arch", list_archs())
def test_train_step_updates_params(arch):
    cfg, model, batch = smoke_setup(arch)
    params = model_params(model)
    before = {n: p.clone() for n, p in params.items()}
    step = make_train_step(model, AdamWConfig(lr=1e-3))
    p2, opt2, metrics = step(params, init_state(params), batch)
    assert np.isfinite(metrics["loss"].item())
    assert np.isfinite(metrics["grad_norm"].item())
    # params actually moved, in place: p2 is the model's own dict
    assert all(p2[n] is params[n] for n in params)
    delta = max(float((before[n] - p2[n]).abs().max()) for n in params)
    assert delta > 0
    for leaf in p2.values():
        assert torch.isfinite(leaf).all()
        assert not leaf.requires_grad      # serving builds no graph
    assert int(opt2["step"]) == 1
