"""The port's input specs (``repro_torch.launch.specs``) held against the
JAX package's ``repro.launch.specs``.

For every applicable config and shape, each argument of the step the dry
run counts has the JAX ``ShapeDtypeStruct``'s global shape and dtype.  The
port's side runs in a subprocess on a ``fake`` process group of 256 ranks
(the single-pod production mesh, as the dry run makes it, with its
per-kind rules): its arguments are rank 0's pieces, which their layouts
(``sharding.Layout``) scale back to the global shape; the parameters a
train step takes whole, and serving's parameters are DTensors at rest,
whose shape is the global one.  The JAX side runs here under a null ctx
(shapes do not depend on the mesh).  The parameter trees are keyed by the
port's state-dict names (a stacked JAX leaf [L, ...] is L leaves).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from repro.configs import REGISTRY, SHAPES, cell_applicable
from repro.configs import get_config as jax_config
from repro.launch import specs as jspecs
from repro.models import get_model as jax_model
from repro.sharding.ctx import ShardCtx as JaxShardCtx

from repro_torch.launch import dryrun, specs
from repro_torch.models.convert import by_name

CELLS = [(a, s.name) for a in REGISTRY for s in SHAPES
         if cell_applicable(jax_config(a), s)[0]]

PORT_SIDE = r"""
import json, sys, warnings
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
warnings.simplefilter("ignore")


def leaves(arg, layout, ctx, path, out):
    if isinstance(arg, dict):
        for k, v in arg.items():
            leaves(v, layout[k] if isinstance(layout, dict) else layout, ctx,
                   f"{path}/{k}", out)
    elif isinstance(arg, int):
        out[path] = [[], "int32"]
    else:
        shape = list(arg.shape)
        if layout is not None and not isinstance(arg, DTensor):
            for i, e in layout.sharded_dims():
                shape[i] *= ctx.axis_size(e)
        out[path] = [shape, str(arg.dtype).replace("torch.", "")]


dryrun.fake_ranks(256)
mesh = make_production_mesh(device_type="cpu")
result = {}
for cell in json.loads(sys.argv[1]):
    arch, shape_name = cell
    cfg, shape = get_config(arch), get_shape(shape_name)
    rules = dryrun.resolve_rules(cfg, shape, "auto")
    ctx, kw = dryrun.cell_ctx(cfg, shape, mesh, rules, {}, accum=None,
                              seq_shard=True, q_chunk=256, moe_impl="einsum")
    with FakeTensorMode():
        fn, args, in_sh, out_sh, donate = dryrun.step_specs(cfg, shape, ctx,
                                                            **kw)
        out = {}
        for i, (a, sh) in enumerate(zip(args, in_sh)):
            leaves(a, sh, ctx, str(i), out)
    result[f"{arch} {shape_name}"] = {"leaves": out, "donate": list(donate)}
print(json.dumps(result))
"""


@pytest.fixture(scope="module")
def port_specs():
    """The port's side of every cell, in two processes side by side."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    procs = [subprocess.Popen([sys.executable, "-c", PORT_SIDE,
                               json.dumps(CELLS[i::2])], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    result = {}
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-3000:]
        result.update(json.loads(out.splitlines()[-1]))
    return result


def jax_leaves(cfg, tree, path, out):
    """``tree``'s leaves by path; parameter trees by the port's names."""
    if isinstance(tree, dict) and any(k in tree for k in ("layers",
                                                          "enc_layers")):
        tree = by_name(cfg, tree, lambda leaf, i: jax.ShapeDtypeStruct(
            leaf.shape[1:], leaf.dtype))
    if isinstance(tree, dict):
        for k, v in tree.items():
            jax_leaves(cfg, v, f"{path}/{k}", out)
    else:
        out[path] = [list(tree.shape), jnp.dtype(tree.dtype).name]


def jax_specs(arch, shape_name):
    cfg = jax_config(arch)
    shape = next(s for s in SHAPES if s.name == shape_name)
    kv_quant = (shape.kind == "decode" and cfg.family != "encdec"
                and cfg.name in dryrun.KV_QUANT_DECODE)
    model = jax_model(cfg, JaxShardCtx(mesh=None),
                      **({"kv_quant": True} if kv_quant else {}))
    _, args, _, _, donate = jspecs.input_specs(cfg, shape, model,
                                               JaxShardCtx(mesh=None))
    out = {}
    for i, a in enumerate(args):
        jax_leaves(cfg, a, str(i), out)
    return out, list(donate)


@pytest.mark.parametrize("arch", list(REGISTRY))
def test_input_specs_match_jax(arch, port_specs):
    """Every argument leaf of every applicable cell of ``arch``: the same
    path, global shape and dtype as the JAX ``input_specs``' (the decode
    position, a 0-d int32 there, is an int in the port), and the same
    donated arguments."""
    cells = [s for a, s in CELLS if a == arch]
    assert cells
    for shape_name in cells:
        port = port_specs[f"{arch} {shape_name}"]
        want, donate = jax_specs(arch, shape_name)
        assert port["donate"] == donate, shape_name
        assert sorted(port["leaves"]) == sorted(want), shape_name
        for path, got in port["leaves"].items():
            assert got == want[path], (shape_name, path, got, want[path])


def test_train_accum_matches_jax():
    assert specs.TRAIN_ACCUM == jspecs.TRAIN_ACCUM
    assert set(specs.TRAIN_ACCUM) == set(REGISTRY)
