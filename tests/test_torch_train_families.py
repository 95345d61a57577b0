"""The port's training path against the JAX package for the moe (router,
expert capacity, the load-balancing aux loss), recurrent (rwkv6's WKV,
hymba's SSD beside attention) and encoder–decoder configs: ``loss``, its
gradients and one AdamW update at their reduced sizes in float32, with the
tolerances and helpers of ``test_torch_train.py``; and the reference's
gradient-accumulation check (``tests/test_arch_smoke.py``), accum 1
against 2, on the port.
"""
import dataclasses

import pytest
import torch

import test_torch_train as common
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.train import (AdamWConfig, init_state, make_train_step,
                               model_params)

ARCHS = ("qwen2-moe-a2.7b", "dbrx-132b", "rwkv6-7b", "hymba-1.5b",
         "whisper-medium")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    common.check_loss(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(arch):
    common.check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_update_matches_jax(arch):
    common.check_update(arch)


def test_moe_loss_adds_the_aux_loss():
    c = common.case("qwen2-moe-a2.7b")
    nll, aux = c["metrics"]["nll"], c["metrics"]["aux"]
    assert aux.item() > 0
    torch.testing.assert_close(
        c["loss"], nll + 0.01 * aux / c["cfg"].n_layers, rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["glm4-9b", "rwkv6-7b", "qwen2-moe-a2.7b"])
def test_grad_accumulation_equivalence(arch):
    """accum=2 must match accum=1 up to accumulation-order noise (the
    reference's tolerance)."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32), generator=g),
             "targets": torch.randint(0, cfg.vocab_size, (2, 32),
                                      generator=g)}
    out = []
    for accum in (1, 2):
        model = get_model(cfg, device="cpu")
        model.init_params(torch.Generator().manual_seed(0))
        params = model_params(model)
        step = make_train_step(model, AdamWConfig(lr=1e-3), accum=accum)
        p, _, m = step(params, init_state(params), batch)
        out.append((p, m))
    (p1, m1), (p2, m2) = out
    for name in p1:
        torch.testing.assert_close(p1[name], p2[name], rtol=2e-3, atol=2e-4)


def test_accumulation_sums_microbatch_grads_in_f32():
    """With bf16 parameters the microbatch gradients are added into f32
    buffers: the hook sees f32 gradients equal to the mean of the two
    microbatches' own gradients, each summed in f32."""
    cfg = dataclasses.replace(get_config("glm4-9b").reduced())
    model = get_model(cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=g),
             "targets": torch.randint(0, cfg.vocab_size, (4, 16),
                                      generator=g)}
    seen = {}

    def hook(grads):
        seen.update(grads)
        return grads
    params = model_params(model)
    snapshot = {n: p.clone() for n, p in params.items()}
    make_train_step(model, AdamWConfig(), accum=2, grad_hook=hook)(
        params, init_state(params), batch)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(snapshot[n])
    want = None
    for half in (slice(0, 2), slice(2, 4)):
        _, _, grads = common.port_grads(
            model, {k: v[half] for k, v in batch.items()})
        grads = {n: t.float() for n, t in grads.items()}
        want = grads if want is None else {n: want[n] + grads[n]
                                           for n in grads}
    for n, t in seen.items():
        assert t.dtype == torch.float32
        torch.testing.assert_close(t, want[n] / 2, rtol=0, atol=0)
