"""The port's counter (``repro_torch.launch.hlo_cost``) held against the JAX
package's HLO walker (``repro.launch.hlo_cost``) on the same functions.

The five cases of ``tests/test_hlo_cost.py`` in torch: flops within 5% of
the walker's count of the jitted JAX function (the walker multiplies loop
bodies by their trip counts; the counter sees each trip run); a reduced
stablelm-3b in f32 on both sides (so bytes compare: the walker's
``f32_bytes`` correction is for bf16 legalized to f32) whose forward,
prefill and train step agree within 10%; the ring model's collective
bytes under a ``fake`` process group of 4 ranks; and the two repairs of
the distributed layer the dry run needs (``ShardCtx.group`` under a
``FakeTensorMode``, ``comm.transport`` on the ``fake`` backend).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_config as jax_config
from repro.launch import hlo_cost as jcost
from repro.models import get_model as jax_model
from repro.train.optim import AdamWConfig as JaxAdamW
from repro.train.optim import init_state as jax_init_state
from repro.train.steps import make_train_step as jax_train_step

from repro_torch.configs import get_config
from repro_torch.launch import hlo_cost
from repro_torch.models import get_model
from repro_torch.train import (AdamWConfig, init_state, make_train_step,
                               model_params)

UNIT_RTOL = 0.05        # the five unit cases, flops
MODEL_RTOL = 0.10       # the reduced model, flops and ideal bytes


def walker(fn, *args):
    """The JAX walker's cost of ``fn`` jitted at ``args``' shapes."""
    return jcost.analyze(jax.jit(fn).lower(*args).compile().as_text())


def rng_arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def close(got, want, rtol):
    return abs(got - want) <= rtol * abs(want)


def test_matches_walker_scan_free():
    a, b = rng_arrays((256, 256), (256, 256))
    want = walker(lambda a, b: jnp.tanh(a @ b) @ b, a, b)
    got = hlo_cost.analyze(lambda a, b: torch.tanh(a @ b) @ b,
                           torch.from_numpy(a), torch.from_numpy(b))
    assert close(got.flops, want.flops, UNIT_RTOL), (got.flops, want.flops)
    assert got.transcendentals == 256 * 256


def test_loop_trip_count_multiplies():
    x, w = rng_arrays((64, 128), (128, 128))

    def jfn(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), ()
        c, _ = lax.scan(body, x, None, length=13)
        return c

    def tfn(x, w):
        for _ in range(13):
            x = torch.tanh(x @ w)
        return x

    want = walker(jfn, x, w)
    got = hlo_cost.analyze(tfn, torch.from_numpy(x), torch.from_numpy(w))
    per_iter = 2 * 64 * 128 * 128
    assert got.flops >= 13 * per_iter
    assert close(got.flops, want.flops, UNIT_RTOL), (got.flops, want.flops)


def test_nested_loop():
    x, w = rng_arrays((32, 64), (64, 64))

    def jfn(x, w):
        def outer(c, _):
            def inner(d, _):
                return jnp.tanh(d @ w), ()
            d, _ = lax.scan(inner, c, None, length=4)
            return d, ()
        c, _ = lax.scan(outer, x, None, length=5)
        return c

    def tfn(x, w):
        for _ in range(5):
            for _ in range(4):
                x = torch.tanh(x @ w)
        return x

    want = walker(jfn, x, w)
    got = hlo_cost.analyze(tfn, torch.from_numpy(x), torch.from_numpy(w))
    assert got.flops >= 20 * 2 * 32 * 64 * 64 * 0.95
    assert close(got.flops, want.flops, UNIT_RTOL), (got.flops, want.flops)


def test_slice_write_bytes_model():
    """A loop-carried write into a slice (``slice_scatter``, the twin of
    ``lax.dynamic_update_slice``) counts the walker's flops and 2 x the
    update in bytes, not the whole buffer every trip; so does the same
    write made in place."""
    buf, upd = rng_arrays((4096, 256), (4, 256))

    def jfn(buf, upd):
        def body(b, i):
            return lax.dynamic_update_slice(b, upd, (i * 4, 0)), ()
        b, _ = lax.scan(body, buf, jnp.arange(16))
        return b

    def functional(buf, upd):
        for i in range(16):
            buf = torch.slice_scatter(buf, upd, 0, i * 4, i * 4 + 4)
        return buf

    def in_place(buf, upd):
        for i in range(16):
            buf[i * 4:i * 4 + 4] = upd
        return buf

    want = walker(jfn, buf, upd)
    got = hlo_cost.analyze(functional, torch.from_numpy(buf),
                           torch.from_numpy(upd))
    whole_buffer_every_iter = 16 * 4096 * 256 * 4
    assert close(got.flops, want.flops, UNIT_RTOL), (got.flops, want.flops)
    assert got.hbm_bytes < whole_buffer_every_iter
    assert got.hbm_bytes == 16 * 2 * upd.nbytes
    got = hlo_cost.analyze(in_place, torch.from_numpy(buf),
                           torch.from_numpy(upd))
    assert got.hbm_bytes == 16 * 2 * upd.nbytes


def test_real_dtypes_keep_their_bytes():
    """The counter reads each tensor's own dtype: a bf16 matmul moves half
    an f32 one's bytes (the walker needs ``f32_bytes=2`` for that)."""
    a, b = rng_arrays((128, 128), (128, 128))
    f32 = hlo_cost.analyze(torch.mm, torch.from_numpy(a), torch.from_numpy(b))
    bf16 = hlo_cost.analyze(torch.mm, torch.from_numpy(a).bfloat16(),
                            torch.from_numpy(b).bfloat16())
    assert f32.hbm_bytes == 3 * 128 * 128 * 4 == 2 * bf16.hbm_bytes
    assert f32.hbm_bytes_ideal == f32.hbm_bytes and f32.flops == bf16.flops
    assert hlo_cost.tensor_bytes(torch.empty(4, 8)) == 128
    assert hlo_cost.tensor_bytes(torch.empty(10, dtype=torch.bfloat16)) == 20


def test_composite_ops_count_by_their_decomposition():
    """softmax and silu (and their backwards) run their decompositions
    under the counter: flops from primitives, the values unchanged."""
    x = torch.from_numpy(rng_arrays((8, 64))[0]).requires_grad_(True)

    def fn(x):
        y = torch.softmax(x, -1) * torch.nn.functional.silu(x)
        y.sum().backward()
        return y

    counter = hlo_cost.Counter()
    with counter:
        got = fn(x)
    assert counter.uncounted == {}
    assert counter.cost.flops >= 6 * x.numel()        # max, sub, exp, sum, div, ...
    assert counter.cost.transcendentals >= 2 * x.numel()   # exp, sigmoid
    want = torch.softmax(x, -1) * torch.nn.functional.silu(x)
    torch.testing.assert_close(got, want)


def test_live_bytes_peak_arguments_and_outputs():
    x = torch.zeros(1024)                                   # 4 KiB

    def fn(x):
        a = x + 1                                           # temp
        b = a * 2                                           # temp
        return a + b                                        # output

    live = hlo_cost.LiveBytes((x,))
    with hlo_cost.Counter(live):
        out = fn(x)
    mem = live.memory(out)
    assert mem.argument_bytes == 4096 and mem.output_bytes == 4096
    assert mem.peak_bytes == 4096 + 3 * 4096 and mem.temp_bytes == 2 * 4096


# ---- a reduced stablelm-3b against the walker ----------------------------
REDUCED = dict(n_layers=2, d_model=512, d_ff=1024, vocab_size=512,
               n_heads=8, n_kv_heads=8, head_dim=64, param_dtype="float32")
B, S = 2, 128


@pytest.fixture(scope="module")
def reduced_pair():
    jc = dataclasses.replace(jax_config("stablelm-3b").reduced(), **REDUCED)
    tc = dataclasses.replace(get_config("stablelm-3b").reduced(), **REDUCED)
    jm = jax_model(jc)
    params = jm.init_params(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, 512, (B, S)).astype(
        np.int32)
    tm = get_model(tc, "cpu")
    tm.init_params(torch.Generator().manual_seed(0))
    return jm, params, tm, tokens


def steps(kind, jm, params, tm, tokens):
    tok = torch.from_numpy(tokens)
    if kind == "forward":
        return (walker(lambda p, t: jm.forward(p, t)[0], params, tokens),
                hlo_cost.analyze(lambda t: tm.forward(t), tok))
    if kind == "prefill":
        return (walker(lambda p, t: jm.prefill(p, t), params, tokens),
                hlo_cost.analyze(lambda t: tm.prefill(t), tok))
    batch = {"tokens": tokens, "targets": tokens}
    want = walker(jax_train_step(jm, JaxAdamW(), accum=1), params,
                  jax_init_state(params), batch)
    p = model_params(tm)
    got = hlo_cost.analyze(make_train_step(tm, AdamWConfig(), accum=1), p,
                           init_state(p), {"tokens": tok, "targets": tok})
    return want, got


@pytest.mark.parametrize("kind", ["forward", "prefill", "train"])
def test_reduced_model_matches_walker(kind, reduced_pair):
    """Forward, prefill and an accum-1 train step (remat on both sides) of
    a reduced stablelm-3b in f32: flops and ideal bytes (matmul and
    collective traffic, gathers, slice writes) within 10% of the walker's
    on the same step compiled on one CPU device."""
    want, got = steps(kind, *reduced_pair)
    flops = got.flops / want.flops
    ideal = got.hbm_bytes_ideal / want.hbm_bytes_ideal
    assert abs(flops - 1) <= MODEL_RTOL, f"{kind}: flops ratio {flops:.4f}"
    assert abs(ideal - 1) <= MODEL_RTOL, \
        f"{kind}: ideal bytes ratio {ideal:.4f}"


def test_reduced_train_step_has_a_rule_for_every_op(reduced_pair):
    _, _, tm, tokens = reduced_pair
    tok = torch.from_numpy(tokens)
    p = model_params(tm)
    step = make_train_step(tm, AdamWConfig(), accum=2)
    counter = hlo_cost.Counter()
    with counter:
        step(p, init_state(p), {"tokens": tok, "targets": tok})
    assert counter.uncounted == {}


# ---- collectives and the repairs, under a fake group of 4 ranks -----------
FAKE_GROUP = r"""
import json, warnings
import torch, torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch import hlo_cost
from repro_torch.launch.mesh import make_ctx, make_smoke_mesh
from repro_torch.sharding import comm
warnings.simplefilter("ignore")
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
ctx = make_ctx(make_smoke_mesh(4, device_type="cpu"), "fsdp")
out = {}
with FakeTensorMode():
    g = ctx.group(("data", "model"))
    out["group_size"] = dist.get_world_size(g)
    out["transport"] = comm.transport("cpu", g)
    x = torch.empty(8, 16)                       # 512 bytes
    before = dict(comm.calls)
    counter = hlo_cost.Counter()
    with counter:
        comm.all_gather(x, g, 0)                 # result 2048 bytes
        comm.all_gather(x, ctx.group("model"), 1)  # 2 ranks: 1024
        comm.all_reduce(x, g)                    # 2 x 512
        comm.reduce_scatter(x, g, 0)             # 512
        funcol.all_reduce(x, "sum", g)           # 2 x 512
    out["calls"] = {k: comm.calls[k] - before[k] for k in before}
    out["bytes"] = counter.cost.coll_bytes
    out["count"] = counter.cost.coll_count
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_collectives_by_the_ring_model_on_a_fake_group():
    """Under a ``fake`` group of 4 ranks (a DeviceMesh (2, 2)): each
    collective of ``sharding.comm`` and a functional all-reduce counted by
    kind with the ring model's bytes, the counts equal to ``comm.calls``;
    ``ShardCtx.group`` of two axes made under a ``FakeTensorMode`` (the
    mesh's rank tensor read outside it) and ``comm.transport`` direct on
    the ``fake`` backend."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    run = subprocess.run([sys.executable, "-c", FAKE_GROUP], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    out = json.loads(run.stdout.splitlines()[-1])
    assert out["group_size"] == 4 and out["transport"] == "direct"
    assert out["calls"] == {"all_gather": 2, "all_reduce": 1,
                            "reduce_scatter": 1}
    assert out["bytes"] == {"all-gather": 2048 + 1024,
                            "all-reduce": 2 * 512 + 2 * 512,
                            "reduce-scatter": 512}
    assert out["count"] == {"all-gather": 2, "all-reduce": 2,
                            "reduce-scatter": 1}
    assert out["count"]["all-gather"] == out["calls"]["all_gather"]
    assert out["count"]["reduce-scatter"] == out["calls"]["reduce_scatter"]
