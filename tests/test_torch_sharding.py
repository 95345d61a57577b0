"""The port's sharding context and layouts (``repro_torch.sharding``,
``repro_torch.launch.mesh``) held against the JAX package's
``repro.sharding.ctx`` and ``repro.launch.mesh``, and K2's causal query
offset (``q_offset``) in its plain version and at the ``attention`` site.

Everything here runs in one process: layouts need only a mesh's shape
(``launch.mesh.LayoutMesh``; the JAX side a namespace with ``shape``, as
its dry run's fake mesh); the differentiable gather alone runs on four gloo
ranks in subprocesses.  The rest of the multi-rank behaviour is in
``test_torch_distributed.py``.
"""
import dataclasses
import functools
import json
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY
from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.launch import mesh as jmesh
from repro.models import get_model as jax_model
from repro.models import layers as JL
from repro.runtime import compress as jcompress
from repro.sharding import ctx as jctx

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.no_backward import NoBackwardKernelError
from repro_torch.launch import mesh as tmesh
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models import whisper as twhisper
from repro_torch.models.convert import axes_by_name
from repro_torch.runtime.compress import compressed_psum
from repro_torch.sharding import ctx as tctx

MESHES = {"16x16": False, "2x16x16": True}
PRESETS = ("default", "fsdp", "cp", "ep")
CACHE_BATCH, CACHE_LEN = 32, 32768


def jax_mesh(multi_pod):
    shape = tmesh.production_shape(multi_pod=multi_pod)
    return SimpleNamespace(shape=shape, axis_names=tuple(shape))


@functools.lru_cache(maxsize=None)
def jax_trees(arch):
    """(param axes, param shapes, {kv_quant: (cache axes, cache shapes)})
    of the JAX model at full size (abstract: no arrays)."""
    cfg = jax_config(arch)
    caches = {}
    for kv_quant in ((False, True) if cfg.family != "encdec" else (False,)):
        kw = {"kv_quant": True} if kv_quant else {}
        m = jax_model(cfg, **kw)
        caches[kv_quant] = (m.cache_axes(),
                            m.cache_shapes(CACHE_BATCH, CACHE_LEN))
    m = jax_model(cfg)
    return m.param_axes(), m.abstract_params(), caches


def port_trees(arch, kv_quant):
    cfg = get_config(arch)
    if cfg.family == "encdec":
        return (twhisper.param_axes(cfg), twhisper.param_shapes(cfg),
                twhisper.cache_axes(cfg),
                twhisper.cache_shapes(cfg, CACHE_BATCH, CACHE_LEN))
    return (tlm.param_axes(cfg), tlm.param_shapes(cfg),
            tlm.cache_axes(cfg, kv_quant),
            tlm.cache_shapes(cfg, CACHE_BATCH, CACHE_LEN, kv_quant))


def jax_specs(ctx, axes, shapes):
    return jctx.map_axes(lambda a, leaf: tuple(ctx.spec(a, leaf.shape)),
                         axes, shapes)


def port_specs(ctx, axes, shapes):
    return tctx.map_axes(lambda a, leaf: ctx.spec(a, tctx._shape(leaf)),
                         axes, shapes)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(REGISTRY))
def test_param_and_cache_specs_match_jax(arch, mesh, preset):
    """Every parameter's and cache leaf's spec at full size, under each
    preset on each production mesh, equals the JAX ``ShardCtx.spec``."""
    multi_pod = MESHES[mesh]
    jc = jmesh.make_ctx(jax_mesh(multi_pod), preset=preset)
    tc = tmesh.make_ctx(tmesh.LayoutMesh(tmesh.production_shape(multi_pod=multi_pod)),
                        preset=preset)
    j_axes, j_shapes, j_caches = jax_trees(arch)
    for kv_quant, (jc_axes, jc_shapes) in j_caches.items():
        t_axes, t_shapes, tc_axes, tc_shapes = port_trees(arch, kv_quant)
        assert t_axes == j_axes
        assert tc_axes == jc_axes
        assert jctx.map_axes(lambda a, leaf: tuple(leaf.shape), j_axes,
                             j_shapes) == t_shapes
        assert port_specs(tc, t_axes, t_shapes) == jax_specs(jc, j_axes,
                                                             j_shapes)
        assert port_specs(tc, tc_axes, tc_shapes) == jax_specs(
            jc, jc_axes, jc_shapes)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_presets_and_rules_match_jax(mesh):
    assert tctx.DEFAULT_RULES == jctx.DEFAULT_RULES
    assert tctx.EP_RULES == jctx.EP_RULES
    assert tctx.FSDP_RULES == jctx.FSDP_RULES
    multi_pod = MESHES[mesh]
    for preset in PRESETS:
        j = jmesh.make_ctx(jax_mesh(multi_pod), preset=preset)
        t = tmesh.make_ctx(tmesh.LayoutMesh(tmesh.production_shape(multi_pod=multi_pod)),
                           preset=preset)
        for f in ("dp", "tp", "rules", "seq_shard", "decode_kv", "attn_impl",
                  "moe_impl", "fsdp_axes", "log_fallbacks"):
            assert getattr(t, f) == getattr(j, f), (preset, f)
    with pytest.raises(ValueError):
        tmesh.make_ctx(tmesh.LayoutMesh(tmesh.production_shape()), preset="tp")


def test_fit_axis_chain_and_fsdp_drop_match_jax():
    shape = {"pod": 2, "data": 16, "model": 16}
    j = jctx.ShardCtx(mesh=SimpleNamespace(shape=shape),
                      dp=("pod", "data"))
    t = tctx.ShardCtx(mesh=tmesh.LayoutMesh(shape), dp=("pod", "data"))
    axes = [None, "data", "model", ("pod", "data"), ("pod", "data", "model"),
            ("data", "model")]
    for axis in axes:
        for dim in (1, 2, 4, 8, 16, 25, 32, 60, 64, 96, 512, 2560, 4096):
            assert t._fit_axis(axis, dim) == j._fit_axis(axis, dim), (axis,
                                                                      dim)
        assert t._drop_fsdp(axis) == j._drop_fsdp(axis)
        assert t.axis_size(axis) == j.axis_size(axis)
    # duplicate mesh axes are dropped first come, first served
    assert t.spec(("batch", "d_model", "batch")) == tuple(
        j.spec(("batch", "d_model", "batch")))


def test_placements_shard_each_mesh_dim_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    t = tctx.ShardCtx(mesh=tmesh.LayoutMesh(tmesh.production_shape(multi_pod=True)),
                      dp=("pod", "data"))
    entries = t.spec(("batch", None, "heads"), (64, 7, 32))
    assert entries == (("pod", "data"), None, "model")
    assert t.placements(entries) == (Shard(0), Shard(0), Shard(2))
    assert t.placements(()) == (Replicate(),) * 3
    lay = t.sharding(("d_model", "ffn"), (2560, 6912))
    assert lay.spec == ("data", "model")
    assert lay.local_shape((2560, 6912)) == (160, 432)


def test_map_axes_and_is_axes_leaf_match_jax():
    axes = {"a": ("layer", "d_model"), "b": {"c": (), "d": (None, "heads")},
            "e": [("vocab",), (None,)]}
    shapes = {"a": (3, 4), "b": {"c": 1, "d": (5, 6)}, "e": [(7,), (8,)]}
    fn = lambda ax, leaf: (ax, leaf)                         # noqa: E731
    want = jax.tree.map(fn, axes, shapes, is_leaf=jctx.is_axes_leaf)
    assert tctx.map_axes(fn, axes, shapes) == want
    for x in ((), ("a", None), (None,), ("a", 1), [("a",)], "a"):
        assert tctx.is_axes_leaf(x) == jctx.is_axes_leaf(x)


def test_null_ctx_changes_nothing():
    c = tctx.ShardCtx.null()
    w = torch.ones(4, 6)
    assert not c.enabled and c.axis_size("data") == 1
    assert c.constrain(w, "batch", None) is w
    assert c.gather_fsdp(w, ("d_model", "ffn")) is w
    assert c.gather_params({"w": w}, {"w": ("d_model", "ffn")})["w"] is w
    assert c.sharding(("d_model",), (4,)) is None
    assert c.tree_shardings({"w": ("d_model", "ffn")}, {"w": w}) == {"w": None}
    # an enabled ctx leaves plain tensors (the ranks' own pieces) as they are
    e = tmesh.make_ctx(tmesh.LayoutMesh(tmesh.production_shape()), preset="fsdp")
    assert e.constrain(w, "batch", None) is w
    assert e.gather_fsdp(w, ("d_model", "ffn")) is w


def test_production_mesh_shapes_and_batch_axes():
    assert tmesh.production_shape() == {"data": 16, "model": 16}
    assert tmesh.production_shape(multi_pod=True) == {"pod": 2, "data": 16,
                                                      "model": 16}
    m = tmesh.LayoutMesh(tmesh.production_shape(multi_pod=True))
    assert tmesh.make_ctx(m, "cp").batch_axes == ("pod", "data", "model")
    assert tmesh.make_ctx(m, "fsdp").batch_axes == ("pod", "data", "model")
    assert tmesh.make_ctx(m, "default").batch_axes == ("pod", "data")


@pytest.mark.parametrize("arch", list(REGISTRY))
def test_axes_by_name_covers_every_parameter(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    model = get_model(cfg, "cpu")
    axes = axes_by_name(cfg, model.param_axes())
    params = dict(model.named_parameters())
    assert set(axes) == set(params)
    assert all(len(axes[n]) == params[n].dim() for n in params)


# ---- K2's causal query offset ------------------------------------------
def qkv(B, S, T, H, KV, hd, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in
            ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))]


def masked_softmax(q, k, v, off):
    """Query row i sees key t iff t <= off + i, in float64."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    kk = np.repeat(k, H // KV, axis=2).astype(np.float64)
    vv = np.repeat(v, H // KV, axis=2).astype(np.float64)
    s = np.einsum("bshd,bthd->bhst", q.astype(np.float64), kk) / math.sqrt(hd)
    mask = np.arange(T)[None, :] <= off + np.arange(S)[:, None]
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhst,bthd->bshd", p, vv)


@pytest.mark.parametrize("off", [0, 1, 17, 32, 48, 63])
def test_plain_k2_with_offset_is_the_shifted_causal_softmax(off):
    q, k, v = qkv(2, 16, 80, 8, 2, 32, seed=off)
    got = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=True,
                              q_offset=off)
    np.testing.assert_allclose(got.numpy(), masked_softmax(q, k, v, off),
                               rtol=1e-5, atol=1e-6)
    # and the JAX package's plain path at the same offset
    want = JL.attention_chunked(*map(jnp.asarray, (q, k, v)), causal=True,
                                ctx=jctx.ShardCtx.null(), q_chunk=8,
                                q_offset=off, use_impl=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_offset_shards_join_into_causal_attention(n):
    q, k, v = map(torch.from_numpy, qkv(1, 64, 64, 4, 1, 16, seed=n))
    whole = flash_attention(q, k, v, causal=True, device="cpu")
    s = 64 // n
    parts = [flash_attention(q[:, i * s:(i + 1) * s], k, v, causal=True,
                             q_offset=i * s, device="cpu") for i in range(n)]
    torch.testing.assert_close(torch.cat(parts, 1), whole, rtol=1e-6,
                               atol=1e-6)
    # the layer's plain path agrees
    got = TL.attention_chunked(q[:, s:2 * s], k, v, causal=True, q_chunk=8,
                               q_offset=s, use_impl=False)
    torch.testing.assert_close(got, whole[:, s:2 * s], rtol=1e-5, atol=1e-6)


def test_k2_refusals_with_and_without_offset():
    q, k, v = map(torch.from_numpy, qkv(1, 8, 16, 2, 1, 16))
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, v, causal=True, device="cpu")
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, v, causal=True, q_offset=-1, device="cpu")
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, v, causal=True, q_offset=1.5, device="cpu")
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, v, causal=True, q_offset=8, softcap=30.0,
                        device="cpu")
    # refuse_grad comes first, before any shape check
    with pytest.raises(NoBackwardKernelError):
        flash_attention(q.requires_grad_(), k, v, causal=True, device="cpu")
    # non-causal S != T needs no offset, and ignores one
    a = flash_attention(q.detach(), k, v, causal=False, device="cpu")
    b = flash_attention(q.detach(), k, v, causal=False, q_offset=5,
                        device="cpu")
    torch.testing.assert_close(a, b)


def test_attention_site_receives_the_offset_the_jax_site_drops():
    """The port's ``attention_chunked`` hands an installed impl the causal
    offset; the JAX package's calls its impl with (q, k, v, causal,
    softcap) only (``src/repro/models/layers.py:171-173``), so a
    context-parallel shard's mask starts at 0 there."""
    q, k, v = qkv(1, 8, 16, 2, 1, 16)
    seen_port, seen_jax = [], []

    def port_impl(*a, **kw):
        seen_port.append(kw)
        return flash_attention(*a, device="cpu", **kw)

    def jax_impl(*a, **kw):
        seen_jax.append(kw)
        return JL.attention_chunked(*a, ctx=jctx.ShardCtx.null(),
                                    use_impl=False, **kw)

    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with ops.use_impl("attention", port_impl):
        got = TL.attention_chunked(tq, tk, tv, causal=True, q_offset=8)
        TL.attention_chunked(tk, tk, tv, causal=True)
    assert seen_port[0]["q_offset"] == 8 and "q_offset" not in seen_port[1]
    np.testing.assert_allclose(got.numpy(), masked_softmax(q, k, v, 8),
                               rtol=1e-5, atol=1e-6)
    jops.set_impl("attention", jax_impl)
    try:
        j = JL.attention_chunked(*map(jnp.asarray, (q, k, v)), causal=True,
                                 ctx=jctx.ShardCtx.null(), q_offset=8)
    finally:
        jops.set_impl("attention", None)
    assert "q_offset" not in seen_jax[0]
    # the JAX result is the offset-0 mask's, off the shifted one
    np.testing.assert_allclose(np.asarray(j), masked_softmax(q, k, v, 0),
                               rtol=1e-5, atol=1e-6)
    assert np.abs(np.asarray(j) - masked_softmax(q, k, v, 8)).max() > 1e-2


def test_compressed_psum_on_one_rank_is_the_reference_quantizer():
    """With no group (one rank) the sum is the rank's own dequantized
    value, bit for bit the reference's ``compress_ef_int8``."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    r = (rng.standard_normal((16, 32)) * 1e-3).astype(np.float32)
    total, res = compressed_psum(torch.from_numpy(x), None,
                                 torch.from_numpy(r))
    q, scale, jres = jcompress.compress_ef_int8(jnp.asarray(x), jnp.asarray(r))
    np.testing.assert_array_equal(
        total.numpy(), np.asarray(q.astype(jnp.float32) * scale))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))


PRODUCTION_MESH = """
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_ctx, make_production_mesh
for multi_pod, n in ((False, 256), (True, 512)):
    dist.init_process_group("fake", store=FakeStore(), rank=37,
                            world_size=n)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    ctx = make_ctx(mesh, "cp")
    print(mesh.mesh_dim_names, tuple(mesh.mesh.shape),
          ctx.index(ctx.dp), ctx.index(ctx.tp),
          ctx.spec(("batch", "seq", None), (32, 4096, 8)))
    dist.destroy_process_group()
"""


def test_production_mesh_on_the_fake_process_group():
    """``make_production_mesh`` builds a DeviceMesh of the JAX package's
    shapes and axis names over 256 and 512 ranks (the ``fake`` process
    group stands for them in one process); rank 37 sits at data 2, model 5
    (and pod 0)."""
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", PRODUCTION_MESH], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines() == [
        "('data', 'model') (16, 16) 2 5 ('data', 'model')",
        "('pod', 'data', 'model') (2, 16, 16) 2 5 (('pod', 'data'), 'model')"]


GATHER = r"""
import json, sys, warnings
from datetime import timedelta
warnings.simplefilter("ignore")
import torch
import torch.distributed as dist
from repro_torch.launch.mesh import make_ctx, make_smoke_mesh
from repro_torch.sharding import full, gathered

CASES = (("default", ("d_model", "heads")), ("fsdp", ("d_model", "heads")),
         ("default", (None, None)))
rank, path = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(path + "/store", 4),
                        rank=rank, world_size=4, timeout=timedelta(seconds=60))
mesh = make_smoke_mesh(device_type="cpu")
out = []
for preset, axes in CASES:
    ctx = make_ctx(mesh, preset=preset)
    lay = ctx.sharding(axes, (8, 12))
    for dtype in (torch.float32, torch.bfloat16):
        whole = torch.randn(8, 12, generator=torch.Generator().manual_seed(
            1)).to(dtype)
        w = torch.nn.Parameter(lay.dtensor(lay.shard(whole).clone()))
        # each rank's loss weights the whole value by its batch index's own
        # draw: ranks that share tokens share their gradient
        r = torch.randn(8, 12, generator=torch.Generator().manual_seed(
            10 + ctx.index(ctx.batch_axes)))
        (g,) = torch.autograd.grad((gathered(w, ctx.batch_axes).float()
                                    * r).sum(), [w])
        want = sum(torch.randn(8, 12, generator=torch.Generator().manual_seed(
            10 + i)).to(dtype).float()
            for i in range(ctx.axis_size(ctx.batch_axes))).to(dtype)
        with torch.no_grad():
            value = torch.equal(full(w), whole)
        out.append({"case": [preset, list(axes), str(dtype)],
                    "spec": repr(lay.spec), "dtype": str(g.dtype),
                    "err": float((g.to_local().float() - lay.shard(
                        want).float()).abs().max() / want.float().abs().max()),
                    "value": value})
with open(f"{path}/{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


def test_differentiable_gather_lands_the_whole_gradient(tmp_path):
    """``sharding.gathered`` on four gloo ranks (mesh (2, 2)): the gradient
    autograd leaves on a DTensor parameter is ``land`` of the ranks' whole
    gradients: a dim over the axes that split the tokens is summed and cut
    (``default``'s d_model over data; ``fsdp``'s over both axes), a dim
    over an axis that does not split them is cut (``default``'s heads
    over model), a replicated weight is summed whole; in f32 and, cast by
    autograd to the parameter's dtype, in bf16 (within a rounding of the
    sum, whose order the ranks choose); the forward is the whole value."""
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    procs = [subprocess.Popen([sys.executable, "-c", GATHER, str(r),
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    for proc in procs:
        try:
            _, err = proc.communicate(timeout=180)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-3000:]
    ranks = [json.loads((tmp_path / f"{r}.json").read_text())
             for r in range(4)]
    specs = [r["spec"] for r in ranks[0][::2]]
    assert specs == ["('data', 'model')", "(('data', 'model'),)", "()"]
    for rows in ranks:
        assert len(rows) == 6
        for r in rows:
            # four ranks' terms may sum in another order than here's
            tol = 2.0 ** -8 if r["dtype"] == "torch.bfloat16" else 1e-7
            assert r["err"] <= tol and r["value"], r
            assert r["dtype"] == r["case"][2]
