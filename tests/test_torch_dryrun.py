"""The port's dry run (``repro_torch.launch.dryrun``) held against the JAX
package's ``repro.launch.dryrun``.

``resolve_rules`` gives the JAX package's answer for every config, shape,
mesh and rules name; a SKIP cell's record is the JAX package's; and the
JAX package's own slow cell, whisper-medium x decode_32k on the single
pod, runs end to end in a subprocess (a ``fake`` group of 256 ranks, fake
tensors) to ``OK`` with ``fits_hbm`` true and the record's keys, which
``--resume`` then skips.  On fake tensors, the train step at rest tracks a
lower peak than the step with whole weights by at least the f32 bytes of
the weights a rank does not hold; a layer gathered outside its remat body
loses that.
"""
import json
import os
import subprocess
import sys

import pytest

from repro.configs import REGISTRY, SHAPES, cell_applicable
from repro.configs import get_config as jax_config

from repro_torch import hw
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun

RULES = ("auto", "default", "fsdp", "ep", "cp")


@pytest.fixture(scope="module")
def jax_dryrun():
    """The JAX package's dry-run module, imported with this process's
    XLA_FLAGS kept (the module sets them for its own process)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jdryrun


@pytest.mark.parametrize("arch", list(REGISTRY))
def test_resolve_rules_match_jax(arch, jax_dryrun):
    for shape in SHAPES:
        for multi_pod in (False, True):
            for rules in RULES:
                assert dryrun.resolve_rules(
                    get_config(arch), get_shape(shape.name), rules,
                    multi_pod) == jax_dryrun.resolve_rules(
                        jax_config(arch), shape, rules, multi_pod)
    assert dryrun.KV_QUANT_DECODE == jax_dryrun.KV_QUANT_DECODE


def test_skip_cell_record_matches_jax(jax_dryrun):
    skipped = [(a, s.name) for a in REGISTRY for s in SHAPES
               if not cell_applicable(jax_config(a), s)[0]]
    assert len(skipped) == 8
    for arch, shape in skipped:
        for multi_pod in (False, True):
            got = dryrun.run_cell(arch, shape, multi_pod=multi_pod)
            want = jax_dryrun.run_cell(arch, shape, multi_pod=multi_pod)
            assert got["status"] == want["status"] == "SKIP"
            assert got == want


DECODE_CELLS = r"""
import json, warnings
warnings.simplefilter("ignore")
from repro_torch.launch.dryrun import run_cell
print(json.dumps([run_cell(arch, "decode_32k", multi_pod=False,
                           verbose=False)
                  for arch in ("stablelm-3b", "qwen2-moe-a2.7b")]))
"""
WHISPER = ("--arch", "whisper-medium", "--shape", "decode_32k",
           "--single-pod")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Side by side: the whisper cell through the command line (its record
    in ``out``), and two decoder-only decode cells in one process."""
    out = tmp_path_factory.mktemp("dryrun") / "dryrun.jsonl"
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in ([sys.executable, "-W", "ignore", "-m",
                          "repro_torch.launch.dryrun", *WHISPER, "--out",
                          str(out)],
                         [sys.executable, "-c", DECODE_CELLS])]
    done = []
    for proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            proc.kill()
        done.append((proc.returncode, stdout, stderr))
    return out, env, done


def test_whisper_decode_cell_end_to_end(runs):
    """The JAX package's slow dry-run test (tests/test_system.py), on the
    port: whisper-medium x decode_32k on 256 ranks reads OK and fits the
    H100's memory; the record has the JAX record's keys with ``count_s``
    for the compile times and the port's memory keys; ``--resume`` skips
    it."""
    out, env, ((rc, stdout, stderr), _) = runs
    assert rc == 0, stdout[-2000:] + stderr[-2000:]
    assert "[whisper-medium × decode_32k × 16x16] OK" in stdout
    assert "fits=True" in stdout
    assert "done: 1 ok, 0 skip, 0 fail" in stdout
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["status"] == "OK"
    assert set(rec) == {"arch", "shape", "mesh", "rules", "accum",
                        "seq_shard", "moe_impl", "ssm_chunk", "q_chunk",
                        "kv_quant", "status", "count_s", "memory",
                        "roofline"}
    mem = rec["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "peak_bytes", "fits_hbm"}
    assert mem["fits_hbm"] is True and 0 < mem["peak_bytes"] <= hw.HBM_BYTES
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                 + mem["output_bytes"])
    rf = rec["roofline"]
    assert rf["n_chips"] == 256 and rf["flops_per_chip"] > 0
    assert rf["collective_count_by_kind"]["all-gather"] > 0
    assert (rec["mesh"], rec["rules"]) == ("16x16", "default")
    again = subprocess.run(
        [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
         *WHISPER, "--out", str(out), "--resume"], env=env,
        capture_output=True, text=True, timeout=300)
    assert again.returncode == 0 and "done: 0 ok, 0 skip, 0 fail" in \
        again.stdout
    assert len(out.read_text().splitlines()) == 1


def test_decoder_decode_cells_in_one_process(runs):
    """A decoder-only decode step with its weights at rest as DTensor
    pieces (each layer gathered whole, as the forward does) under
    ``tp_seq``, and a second cell after the first one's process group was
    destroyed (an equal mesh handed back by DTensor's cache gets groups of
    the new one); the MoE cell's cache split over the model axis."""
    _, _, (_, (rc, stdout, stderr)) = runs
    assert rc == 0, stderr[-3000:]
    dense, moe = json.loads(stdout.splitlines()[-1])
    for rec in (dense, moe):
        assert rec["status"] == "OK" and rec["memory"]["fits_hbm"]
        assert rec["rules"] == "default" and rec["kv_quant"] is False
        kinds = rec["roofline"]["collective_count_by_kind"]
        assert kinds["all-gather"] > 0 and kinds["all-reduce"] > 0


MEMORY = r"""
import dataclasses, json, math, sys, warnings
warnings.simplefilter("ignore")
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.launch import hlo_cost
from repro_torch.launch.dryrun import fake_ranks
from repro_torch.launch.mesh import make_ctx
from repro_torch.launch.specs import token_layout
from repro_torch.models import get_model
from repro_torch.sharding import Layout
from repro_torch.train import optim
from repro_torch.train.steps import (make_train_step, model_params,
                                     param_layouts, rest_sharded)

fake_ranks(16)


def gathered_before_the_layers(model):
    # every layer gathered before the first runs, as a remat body's
    # default argument evaluated outside it would: all held to the backward
    # (under tensor parallelism each layer's pieces, as the forward takes)
    forward, layer_params = model.forward, model._layer_params

    def outside(tokens, *a, **kw):
        tp = model._tp(tokens.shape[1])
        held = {id(layer): layer_params(layer, tp) for layer in model.layers}
        model._layer_params = lambda layer, tp=None: held[id(layer)]
        try:
            return forward(tokens, *a, **kw)
        finally:
            del model._layer_params
    model.forward = outside


def tracked(cfg, ctx, variant):
    with FakeTensorMode():
        model = get_model(cfg, "cpu", ctx=ctx)
        if variant != "whole":
            rest_sharded(model)
        if variant == "outside":
            gathered_before_the_layers(model)
        params, layouts = model_params(model), param_layouts(model)
        opt = optim.init_state(params, layouts)
        step = make_train_step(model, optim.AdamWConfig(),
                               grad_shardings=layouts if variant == "whole"
                               else None)
        lay = token_layout(ctx, ctx.axis_size(ctx.batch_axes), 8)
        batch = {k: torch.zeros(lay.local_shape(
            (ctx.axis_size(ctx.batch_axes), 8)), dtype=torch.int64)
            for k in ("tokens", "targets")}
        live = hlo_cost.LiveBytes((params, opt, batch))
        with hlo_cost.Counter(live):
            step(params, opt, batch)
        held = sum(math.prod(layouts[n].local_shape(p.shape))
                   for n, p in params.items())
        whole = sum(p.numel() for p in params.values())
        # every layer's compute-time pieces under tensor parallelism
        pieces = sum(math.prod(Layout(ctx, ctx.fsdp_spec(
            model._layer_axes[n], w.shape)).local_shape(w.shape))
            for layer in model.layers for n, w in layer.tensors().items())
        return live.peak, whole - held, model._tp(8) is not None, pieces


out = {}
for arch, preset in json.loads(sys.argv[1]):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32", n_layers=8)
    # under default a layer's pieces are 8 times its share at rest
    mesh = init_device_mesh("cpu", (8, 2) if preset == "default" else
                            (4, 4), mesh_dim_names=("data", "model"))
    ctx = make_ctx(mesh, preset=preset)
    out[f"{arch} {preset}"] = {v: tracked(cfg, ctx, v)
                               for v in ("whole", "rest", "outside")}
print(json.dumps(out))
"""
MEMORY_CASES = (("glm4-9b", "fsdp"), ("glm4-9b", "default"),
                ("qwen2-moe-a2.7b", "default"), ("rwkv6-7b", "cp"))


@pytest.fixture(scope="module")
def memory():
    """Each case's three tracked steps, the cases in processes side by
    side."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    procs = [subprocess.Popen([sys.executable, "-c", MEMORY,
                               json.dumps([case])], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for case in MEMORY_CASES]
    out = {}
    for proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            proc.kill()
        assert proc.returncode == 0, stderr[-3000:]
        out.update(json.loads(stdout.splitlines()[-1]))
    return out


@pytest.mark.parametrize("arch,preset", MEMORY_CASES)
def test_step_at_rest_tracks_less_than_whole_weights(memory, arch, preset):
    """Reduced in f32 to 8 layers on 16 fake ranks (mesh 4 x 4 as (data,
    model); 8 x 2 under ``default``), a row of 8 tokens a rank:
    ``LiveBytes``' tracked peak of the step at rest is below the
    whole-weight step's (gradients landed in the same layouts) by at least
    4 bytes x the parameters a rank does not hold at rest; with every
    layer gathered before the layers run (outside the remat body) it is
    not.  Under ``default`` the step at rest is tensor-parallel (a layer
    gathered over the data axis alone into the rank's model-axis pieces):
    4 bytes x every layer's pieces is above the step at rest's peak, and
    the step that gathers them all before the layers run reaches it."""
    got = memory[f"{arch} {preset}"]
    (whole, away, _, _), (rest, _, tp, pieces), (outside, _, _, _) = (
        got[v] for v in ("whole", "rest", "outside"))
    assert away > 0
    assert whole - rest >= 4 * away, (whole, rest, away)
    assert whole - outside < 4 * away, (whole, outside, away)
    assert tp == (preset == "default")
    if tp:
        assert rest < 4 * pieces <= outside, (rest, pieces, outside)
