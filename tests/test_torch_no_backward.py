"""The refusal of K2, K6 and K7 under autograd, on the CPU.

Their wrappers launch into ``torch.empty`` outputs, which carry no
``grad_fn``: under autograd nothing would flow back through them.  The JAX
package has no backward kernel either (a ``jax.grad`` through its Pallas
flash kernel raises in Pallas's jvp rule), so both packages train on the
plain path.  The port refuses by name, before the device dispatch, so the
CPU (where the wrappers compute the plain version) refuses as the card
does; the card's own refusal through the real kernels is in
``test_torch_cuda.py``.  Calls without grad, serving and a model after
training are unchanged.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import get_case
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.no_backward import NoBackwardKernelError
from repro_torch.kernels.rwkv_wkv import wkv
from repro_torch.kernels.ssd_scan import ssd
from repro_torch.models import get_model
from repro_torch.models.ssm import stateful_site
from repro_torch.serve import generate
from repro_torch.train import (AdamWConfig, init_state, make_train_step,
                               model_params)


def inputs(name, grad=True):
    g = torch.Generator().manual_seed(0)
    if name == "flash_attention":
        shapes = [(1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16)]
    elif name == "wkv":
        shapes = [(1, 8, 2, 16)] * 4 + [(2, 16)]
    else:
        shapes = [(1, 8, 2, 16), (1, 8, 2), (2,), (1, 8, 4), (1, 8, 4)]
    out = [torch.randn(s, generator=g) for s in shapes]
    if name == "wkv":
        out[3] = -out[3].abs()
    if name == "ssd":
        out[1] = out[1].abs()
    if grad:
        out[0].requires_grad_(True)
    return out


WRAPPERS = {"flash_attention": (flash_attention, "attention"),
            "wkv": (wkv, "rwkv_wkv"), "ssd": (ssd, "ssm_chunk")}
CASES = {"flash_attention": "attention_prefill", "wkv": "rwkv_wkv",
         "ssd": "mamba_ssd"}


@pytest.fixture(autouse=True)
def _clean_registry():
    ops.clear_all()
    yield
    ops.clear_all()


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_refuses_under_grad_on_the_cpu(name):
    fn, site = WRAPPERS[name]
    with pytest.raises(NoBackwardKernelError) as err:
        fn(*inputs(name), device="cpu")
    assert repr(site) in str(err.value)
    assert "neither this port nor the JAX package has a backward kernel" \
        in str(err.value)
    # without grad, or with no input that requires it, the call runs
    with torch.no_grad():
        fn(*inputs(name), device="cpu")
    fn(*inputs(name, grad=False), device="cpu")


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_refusal_comes_before_the_device_dispatch(name, monkeypatch):
    """The default device is the card; without one the refusal still
    comes first, as on the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn, _ = WRAPPERS[name]
    with pytest.raises(NoBackwardKernelError):
        fn(*inputs(name))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(*inputs(name, grad=False))


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cuda_case_builds_refuse_under_grad(name):
    case = get_case(CASES[name])
    build = case.build(dict(case.baseline_variant), impl="cuda")
    with pytest.raises(NoBackwardKernelError):
        build(*inputs(name))
    with torch.no_grad():
        build(*inputs(name))


@pytest.mark.parametrize("name", ["wkv", "ssd"])
def test_stateful_site_refuses_through_its_kernel_only(name):
    """``stateful_site`` adds no check of its own: a kernel wrapper it
    takes refuses as it does alone, and a plain impl runs under grad with
    its gradient path."""
    from repro_torch.kernels.ref import ssd_ref, wkv_ref
    fn, site = WRAPPERS[name]
    impl = stateful_site(lambda *a: fn(*a, device="cpu"))
    with pytest.raises(NoBackwardKernelError, match=repr(site)):
        impl(*inputs(name), return_state=True)
    with torch.no_grad():
        impl(*inputs(name), return_state=True)
    plain = stateful_site({"wkv": wkv_ref, "ssd": ssd_ref}[name])
    out, _ = plain(*inputs(name), return_state=True)
    assert out.grad_fn is not None


def reduced_model(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    model = get_model(cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    return cfg, model, {"tokens": toks, "targets": toks}


SITE_IMPLS = {
    "glm4-9b": ("attention", lambda q, k, v, causal=True, softcap=0.0:
                flash_attention(q, k, v, causal=causal, softcap=softcap,
                                device=q.device.type)),
    "rwkv6-7b": ("rwkv_wkv", stateful_site(
        lambda *a, chunk=64: wkv(*a, chunk=chunk, device=a[0].device.type))),
    "hymba-1.5b": ("ssm_chunk", stateful_site(
        lambda *a, chunk=128: ssd(*a, chunk=chunk, device=a[0].device.type))),
}


@pytest.mark.parametrize("arch", sorted(SITE_IMPLS))
def test_train_step_with_a_kernel_installed_refuses(arch):
    """A train step through K2, K6 or K7 raises the named error and leaves
    the parameters and moments as they were; without the kernel it
    trains."""
    cfg, model, batch = reduced_model(arch)
    params = model_params(model)
    opt = init_state(params)
    before = {n: p.clone() for n, p in params.items()}
    step = make_train_step(model, AdamWConfig(lr=1e-3))
    site, impl = SITE_IMPLS[arch]
    with ops.use_impl(site, impl):
        with pytest.raises(NoBackwardKernelError, match=repr(site)):
            step(params, opt, batch)
        for n, p in params.items():
            assert torch.equal(p, before[n]) and not p.requires_grad
        assert int(opt["step"]) == 0
        with torch.no_grad():             # serving through it still runs
            model.prefill(batch["tokens"])
    _, opt, m = step(params, opt, batch)
    assert int(opt["step"]) == 1 and np.isfinite(m["loss"].item())


def test_train_step_through_a_plain_impl_at_rwkv_wkv():
    """A plain, differentiable impl installed at ``rwkv_wkv`` (the
    sequential ``wkv_ref``, through ``stateful_site``) trains: its loss and
    gradients equal the uninstalled path's within 1e-5 relative plus 1e-5
    of the largest gradient (f32; the two recurrences sum in another
    order), and a train step through it counts its step and moves the
    parameters."""
    from repro_torch.kernels.ref import wkv_ref
    cfg, model, batch = reduced_model("rwkv6-7b")
    params = model_params(model)
    impl = stateful_site(lambda *a, chunk=64: wkv_ref(*a))

    def loss_and_grads():
        with torch.enable_grad():
            for p in params.values():
                p.requires_grad_(True)
            try:
                loss, _ = model.loss(batch)
                grads = torch.autograd.grad(loss, list(params.values()),
                                            allow_unused=True,
                                            materialize_grads=True)
            finally:
                for p in params.values():
                    p.requires_grad_(False)
        return loss.item(), dict(zip(params, grads))

    want_loss, want = loss_and_grads()
    with ops.use_impl("rwkv_wkv", impl):
        got_loss, got = loss_and_grads()
        before = {n: p.clone() for n, p in params.items()}
        _, opt, m = make_train_step(model, AdamWConfig(lr=1e-3))(
            params, init_state(params), batch)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(m["loss"].item(), want_loss, rtol=1e-5)
    scale = max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        np.testing.assert_allclose(got[n].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=n)
    assert int(opt["step"]) == 1
    assert any(not torch.equal(p, before[n]) for n, p in params.items())


def test_a_trained_model_serves_as_its_weights_loaded_fresh():
    """Training leaves the model fit to serve: no parameter requires grad,
    and generate() gives the tokens of a fresh model holding the trained
    weights."""
    cfg, model, batch = reduced_model("glm4-9b")
    params = model_params(model)
    opt = init_state(params)
    step = make_train_step(model, AdamWConfig(lr=1e-2, warmup_steps=0))
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)
    assert not any(p.requires_grad for p in model.parameters())
    fresh = get_model(cfg, device="cpu")
    fresh.load_state_dict(model.state_dict())
    prompts = np.asarray(batch["tokens"][:, :8])
    np.testing.assert_array_equal(
        generate(model, prompts, max_new=6, device="cpu"),
        generate(fresh, prompts, max_new=6, device="cpu"))
