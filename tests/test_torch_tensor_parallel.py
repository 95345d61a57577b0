"""Tensor parallelism on the model axis (``layers.TensorParallel``, a model
at rest under ``default`` or ``ep``) across real ranks, held against the
JAX package's single-device results.

Two spawns of four gloo ranks (``test_torch_distributed.spawn``): mesh
(2, 2) and mesh (1, 4) as (data, model).  Reduced glm4-9b has 2 KV heads
on 4 model ranks there: its flat KV projection splits into pieces of half
a head, and each rank gathers the columns of the one KV head its query
head uses.  stablelm-3b runs with a vocabulary of 500, padded to 512, so
the pad falls inside the last model rank's rows.  A reduced
qwen2-moe-a2.7b with 3 experts (``UNSPLIT``) splits over no model axis
here under ``ep``: it keeps the whole-row path.  The reduced configs run
in f32 on the JAX package's weights (``params_from_jax``).  The rank
processes import neither ``jax`` nor ``repro``.
"""
import dataclasses
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_distributed import (CP_TOL, TRAIN_ATOL, TRAIN_LOSS_TOL,
                                    TRAIN_RTOL, spawn)

SERVE_ARCHS = ("glm4-9b", "command-r-35b", "stablelm-3b", "chameleon-34b")
MOE_ARCHS = ("qwen2-moe-a2.7b", "dbrx-132b")
# (preset, moe_impl) of the MoE legs (under tensor parallelism both
# moe_impls run ``layers.tp_moe``)
MOE_LEGS = (("default", "einsum"), ("default", "shard_map"), ("ep", "einsum"))
# reduced qwen2-moe-a2.7b with 3 experts, which split over neither model
# axis here: under ``ep`` it keeps the whole-row path (GSPMD's
# divisibility fallback computes the experts dim whole)
UNSPLIT = "qwen2-moe-3-experts"
SEVEN = SERVE_ARCHS + MOE_ARCHS + ("codeqwen1.5-7b",)
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
ROWS, SEQ, MAX_NEW = 4, 16, 8
JOBS = ("serve", "moe", "train")
# a vocabulary whose pad (500..511) lies inside the last model rank's rows
VOCAB = {"stablelm-3b": 500}


def reduced(get_config, arch):
    """``arch``'s reduced config in f32 (``UNSPLIT`` and stablelm-3b's
    vocabulary as above), from either package's ``get_config``."""
    cfg = dataclasses.replace(
        get_config("qwen2-moe-a2.7b" if arch == UNSPLIT else arch).reduced(),
        param_dtype="float32",
        **({"vocab_size": VOCAB[arch]} if arch in VOCAB else {}))
    if arch == UNSPLIT:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=3))
    return cfg


def port_cfg(arch):
    from repro_torch.configs import get_config
    return reduced(get_config, arch)


def load(tmp, name):
    return torch.load(os.path.join(tmp, name + ".pt"), weights_only=False)


# ---- rank side (no jax here) -------------------------------------------
def at_rest(arch, ctx, tmp):
    from repro_torch.models import get_model
    from repro_torch.train.steps import rest_sharded
    model = get_model(port_cfg(arch), "cpu", ctx=ctx)
    model.load_state_dict(load(tmp, f"params_{arch}"))
    rest_sharded(model)
    return model


def pieces_off_spec(model, tp):
    """The leaves whose compute-time piece is not the local shape of its
    ``fsdp_spec`` layout (the router, whole on every rank, aside)."""
    from repro_torch.sharding import Layout
    ctx, bad = model.ctx, []
    for i, layer in enumerate(model.layers):
        got = model._layer_params(layer, tp)
        for name, w in layer.tensors().items():
            want = (tuple(w.shape) if name == "router" else Layout(
                ctx, ctx.fsdp_spec(model._layer_axes[name], w.shape)
            ).local_shape(w.shape))
            if tuple(got[name].shape) != want:
                bad.append((i, name, tuple(got[name].shape), want))
    for name in model._top_axes:
        w = getattr(model.top, name)
        want = Layout(ctx, ctx.fsdp_spec(model._top_axes[name], w.shape)
                      ).local_shape(w.shape)
        if tuple(model._top(name, tp).shape) != want:
            bad.append(("top", name))
    return bad


def serve_once(model, toks, nxt, rows):
    """forward (the rank's rows; its S/n of the sequence under sequence
    parallelism), prefill's logits, the logits of one decode step of the
    token ``nxt`` after it, and generate()'s tokens."""
    from repro_torch.serve import generate
    mine = toks[rows[0]:rows[1]]
    with torch.no_grad():
        hidden, _ = model.forward(mine)
        logits, cache = model.prefill(mine, max_len=SEQ + MAX_NEW)
        cache_heads = cache["k"].shape[3]
        step, _ = model.decode_step(cache, nxt[rows[0]:rows[1]], SEQ)
    tp = model._tp(SEQ)
    return {"hidden": hidden, "logits": logits, "step": step, "rows": rows,
            "seq": ((tp.rank * SEQ // tp.n, (tp.rank + 1) * SEQ // tp.n)
                    if tp is not None and tp.sp else (0, SEQ)),
            "cache_heads": cache_heads, "tp": tp is not None,
            "tokens": generate(model, mine.numpy(), max_new=MAX_NEW,
                               device="cpu"),
            "off_spec": [] if tp is None else pieces_off_spec(model, tp)}


def tp_seq_ctx(mesh):
    """``default`` with the decode cache's sequence split over the model
    axis (``tp_seq``, as the dry run sets it)."""
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.sharding import DEFAULT_RULES
    return make_ctx(mesh, preset="default").replace(
        rules=dict(DEFAULT_RULES, kv_seq="__tp__", kv_heads=None),
        decode_kv="tp_seq")


def job_serve(mesh, rank, tmp):
    """Each dense and vlm config at rest under ``default``, with
    ``seq_shard`` on and off; glm4-9b also with K2's plain version at the
    attention site (the heads it is handed) and decoding over a cache
    split over the model axis (``tp_seq``)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.sharding import comm
    out = {}
    for arch in SERVE_ARCHS:
        toks, nxt = load(tmp, f"tokens_{arch}"), load(tmp, f"next_{arch}")
        for sp in (True, False):
            ctx = make_ctx(mesh, preset="default", seq_shard=sp)
            rows = ctx.sharding(("batch", None), tuple(toks.shape)).bounds(
                tuple(toks.shape))[0]
            model = at_rest(arch, ctx, tmp)
            calls = dict(comm.calls)
            out[(arch, sp)] = serve_once(model, toks, nxt, rows)
            out[(arch, sp)]["calls"] = {k: comm.calls[k] - calls[k]
                                        for k in calls}
    toks = load(tmp, "tokens_glm4-9b")
    ctx = make_ctx(mesh, preset="default")
    rows = ctx.sharding(("batch", None), tuple(toks.shape)).bounds(
        tuple(toks.shape))[0]
    heads = []

    def k2(q, k, v, **kw):
        heads.append((q.shape[2], k.shape[2]))
        return flash_attention(q, k, v, device="cpu", **kw)
    model = at_rest("glm4-9b", ctx, tmp)
    with ops.use_impl("attention", k2), torch.no_grad():
        hidden, _ = model.forward(toks[rows[0]:rows[1]])
    tp = model._tp(SEQ)
    out["k2"] = {"hidden": hidden, "heads": heads, "rows": rows,
                 "seq": (tp.rank * SEQ // tp.n, (tp.rank + 1) * SEQ // tp.n)}
    out["tp_seq"] = serve_once(at_rest("glm4-9b", tp_seq_ctx(mesh), tmp),
                               toks, load(tmp, "next_glm4-9b"), rows)
    return out


def job_moe(mesh, rank, tmp):
    """The MoE configs at rest: forward, prefill and decode logits and
    generate()'s tokens under each of ``MOE_LEGS`` and under ``tp_seq``;
    ``UNSPLIT`` under ``ep``."""
    from repro_torch.launch.mesh import make_ctx
    out = {}
    legs = [(a, preset, impl) for a in MOE_ARCHS for preset, impl in MOE_LEGS]
    legs += [(a, "tp_seq", "einsum") for a in MOE_ARCHS]
    for arch, preset, impl in legs + [(UNSPLIT, "ep", "einsum")]:
        toks, nxt = load(tmp, f"tokens_{arch}"), load(tmp, f"next_{arch}")
        ctx = (tp_seq_ctx(mesh) if preset == "tp_seq" else
               make_ctx(mesh, preset=preset, moe_impl=impl))
        rows = ctx.sharding(("batch", None), tuple(toks.shape)).bounds(
            tuple(toks.shape))[0]
        model = at_rest(arch, ctx, tmp)
        out[(arch, preset, impl)] = dict(
            serve_once(model, toks, nxt, rows),
            experts=model.layers[0].we1.to_local().shape[0])
    return out


TRAIN_LEGS = tuple((a, "default", "einsum", sp) for a in SERVE_ARCHS
                   for sp in (True, False)) + tuple(
    (a, preset, impl, True) for a in MOE_ARCHS for preset, impl in MOE_LEGS)


def job_train(mesh, rank, tmp):
    """One AdamW step at rest on this rank's rows for each of
    ``TRAIN_LEGS``: metrics, and on rank 0 every leaf gathered whole."""
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.launch.specs import token_layout
    from repro_torch.sharding import comm, full
    from repro_torch.train import optim
    from repro_torch.train.steps import (make_train_step, model_params,
                                         param_layouts)
    out = {}
    for arch, preset, impl, sp in TRAIN_LEGS:
        ctx = make_ctx(mesh, preset=preset, seq_shard=sp, moe_impl=impl)
        model = at_rest(arch, ctx, tmp)
        batch = load(tmp, f"batch_{arch}")
        lay = token_layout(ctx, *batch["tokens"].shape)
        params = model_params(model)
        step = make_train_step(model, optim.AdamWConfig(lr=1e-3))
        calls = dict(comm.calls)
        _, _, metrics = step(params, optim.init_state(
            params, param_layouts(model)), {k: lay.shard(v)
                                            for k, v in batch.items()})
        whole = {n: full(p).detach().clone() for n, p in params.items()}
        out[(arch, preset, impl, sp)] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "calls": {k: comm.calls[k] - calls[k] for k in calls},
            "params": whole if rank == 0 else None}
    return out


# ---- JAX side ------------------------------------------------------------
def jax_side(tmp):
    """The JAX package's single-device results on the weights and inputs
    the ranks load."""
    import jax
    from repro.configs import get_config
    from repro.models import get_model
    from repro.serve import generate as jax_generate
    from repro.train import AdamWConfig, init_state
    from repro.train.steps import make_train_step
    from repro_torch.models.convert import params_from_jax

    def save(name, obj):
        torch.save(obj, os.path.join(tmp, name + ".pt"))

    ref = {}
    rng = np.random.default_rng(7)
    for arch in SERVE_ARCHS + MOE_ARCHS + (UNSPLIT,):
        cfg = reduced(get_config, arch)
        m = get_model(cfg)
        params = m.init_params(jax.random.PRNGKey(0))
        save(f"params_{arch}", params_from_jax(
            port_cfg(arch), jax.tree.map(np.asarray, params)))
        toks = rng.integers(0, cfg.vocab_size, (ROWS, SEQ))
        save(f"tokens_{arch}", torch.from_numpy(toks))
        ref[("hidden", arch)] = np.asarray(jax.jit(m.forward)(params,
                                                              toks)[0])
        logits, cache = m.prefill(params, toks, max_len=SEQ + MAX_NEW)
        ref[("logits", arch)] = np.asarray(logits)
        # one decode step of prefill's greedy token
        nxt = np.asarray(logits[:, -1, :cfg.vocab_size].argmax(-1))[:, None]
        save(f"next_{arch}", torch.from_numpy(nxt.copy()))
        ref[("step", arch)] = np.asarray(m.decode_step(params, cache, nxt,
                                                       SEQ)[0])
        ref[("tokens", arch)] = np.asarray(jax_generate(
            m, params, toks, max_new=MAX_NEW))
        if arch == UNSPLIT:
            continue
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, SEQ)),
                 "targets": rng.integers(0, cfg.vocab_size, (8, SEQ))}
        batch["targets"][0, :3] = -1
        save(f"batch_{arch}", {k: torch.from_numpy(v)
                               for k, v in batch.items()})
        p_ref, _, m_ref = jax.jit(make_train_step(m, AdamWConfig(lr=1e-3)))(
            params, init_state(params), batch)
        ref[("train", arch)] = {
            "loss": float(m_ref["loss"]),
            "grad_norm": float(m_ref["grad_norm"]),
            "params": params_from_jax(port_cfg(arch), jax.tree.map(
                np.asarray, p_ref))}
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references, then each mesh's spawn in a directory of its
    own holding the same inputs."""
    import shutil
    base = str(tmp_path_factory.mktemp("tp"))
    ref = jax_side(base)
    out = {}
    for name, shape in MESHES.items():
        tmp = os.path.join(base, name)
        os.makedirs(tmp)
        for f in os.listdir(base):
            if f.endswith(".pt"):
                shutil.copy(os.path.join(base, f), tmp)
        out[name] = spawn(tmp, 4, JOBS, module=__name__,
                          mesh_shape=shape)
    return out, ref


def piece(a, rows, seq):
    return a[rows[0]:rows[1], seq[0]:seq[1]]


def held_to_jax(got, ref, arch):
    """A serving leg against the JAX package within ``CP_TOL``: forward
    (the rank's rows, its S/n under sequence parallelism), prefill's
    whole logits and the next decode step's, the padded vocabulary
    masked, and generate()'s tokens equal."""
    cfg = port_cfg(arch)
    V, rows = cfg.vocab_size, got["rows"]
    want = piece(ref[("hidden", arch)], rows, got["seq"])
    assert got["hidden"].shape == want.shape
    err = np.abs(got["hidden"].numpy() - want).max()
    assert err < CP_TOL, err
    for key in ("logits", "step"):
        wl = ref[(key, arch)][rows[0]:rows[1]]
        assert got[key].shape[-1] == cfg.padded_vocab()
        err = np.abs(got[key].numpy()[..., :V] - wl[..., :V]).max()
        assert err < CP_TOL, (key, err)
        assert (got[key].numpy()[..., V:] < -1e29).all()
    np.testing.assert_array_equal(got["tokens"],
                                  ref[("tokens", arch)][rows[0]:rows[1]])


# ---- the checks ------------------------------------------------------------
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
@pytest.mark.parametrize("sp", [True, False], ids=["seq_shard",
                                                   "no_seq_shard"])
def test_serving_matches_jax(runs, mesh, arch, sp):
    """forward, prefill's and a decode step's logits and generate()'s
    tokens equal the JAX package's (``held_to_jax``); every compute-time
    piece has the local shape of its weight's ``fsdp_spec`` layout; the
    cache holds the KV heads of the rank's query heads."""
    out, ref = runs
    cfg = port_cfg(arch)
    n = MESHES[mesh][1]
    for r in out[mesh]["serve"]:
        got = r[(arch, sp)]
        assert got["tp"] and got["off_spec"] == []
        held_to_jax(got, ref, arch)
        hn, G = cfg.n_heads // n, cfg.n_heads // cfg.n_kv_heads
        assert got["cache_heads"] == max(1, hn // G)
        if sp:
            assert got["calls"]["reduce_scatter"] >= 2 * cfg.n_layers
        else:
            assert got["calls"]["reduce_scatter"] == 0
            assert got["calls"]["all_reduce"] >= 2 * cfg.n_layers


@pytest.mark.parametrize("mesh", MESHES)
def test_k2_gets_the_ranks_heads_and_their_kv_heads(runs, mesh):
    """With K2's plain version at ``attention``, glm4-9b's ranks hand it
    their H/n query heads and the KV heads those use (one of 2 on a
    4-rank model axis, where the KV projection splits in half heads), and
    the forward equals the JAX package's."""
    out, ref = runs
    cfg = port_cfg("glm4-9b")
    n = MESHES[mesh][1]
    for r in out[mesh]["serve"]:
        got = r["k2"]
        assert got["heads"] == [(cfg.n_heads // n,
                                 max(1, cfg.n_kv_heads // n))] * cfg.n_layers
        want = piece(ref[("hidden", "glm4-9b")], got["rows"], got["seq"])
        assert np.abs(got["hidden"].numpy() - want).max() < CP_TOL


@pytest.mark.parametrize("mesh", MESHES)
def test_decode_over_a_cache_split_over_the_model_axis(runs, mesh):
    """``tp_seq``: q and the new token's K/V gathered over the model axis
    before the cache write and the sharded flash-decode, the rank's own
    heads times its rows of ``wo``: glm4-9b's serving legs equal the JAX
    package's (``held_to_jax``), and the cache holds every KV head over
    S/n positions."""
    out, ref = runs
    cfg = port_cfg("glm4-9b")
    for r in out[mesh]["serve"]:
        got = r["tp_seq"]
        assert got["tp"] and got["cache_heads"] == cfg.n_kv_heads
        held_to_jax(got, ref, "glm4-9b")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("leg", MOE_LEGS, ids=lambda leg: "-".join(leg))
def test_moe_serving_matches_jax(runs, mesh, arch, leg):
    """The MoE block's partial sums (the rank's expert-ffn slice under
    ``default`` with either ``moe_impl``, its E/n experts under ``ep``)
    reduced over the model axis, at prefill (the capacity dispatch) and at
    decode (every expert, combined by the gates): ``held_to_jax``."""
    out, ref = runs
    cfg = port_cfg(arch)
    n = MESHES[mesh][1]
    for r in out[mesh]["moe"]:
        got = r[(arch,) + leg]
        assert got["tp"] and got["off_spec"] == []
        assert got["experts"] == (cfg.moe.n_experts // n if leg[0] == "ep"
                                  else cfg.moe.n_experts)
        held_to_jax(got, ref, arch)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_over_a_cache_split_over_the_model_axis(runs, mesh, arch):
    """A MoE model under ``tp_seq``: the decode step's expert-ffn slices
    reduced over the model axis, its cache every KV head over S/n
    positions: ``held_to_jax``."""
    out, ref = runs
    cfg = port_cfg(arch)
    for r in out[mesh]["moe"]:
        got = r[(arch, "tp_seq", "einsum")]
        assert got["tp"] and got["off_spec"] == []
        assert got["cache_heads"] == cfg.n_kv_heads
        held_to_jax(got, ref, arch)


@pytest.mark.parametrize("mesh", MESHES)
def test_a_model_that_does_not_split_keeps_whole_rows(runs, mesh):
    """``UNSPLIT``'s 3 experts split over no model axis here: under
    ``ep`` the model runs no tensor parallelism (``LM._tp`` is None), its
    experts whole on every rank, and serves as the JAX package does
    (``held_to_jax``)."""
    out, ref = runs
    for r in out[mesh]["moe"]:
        got = r[(UNSPLIT, "ep", "einsum")]
        assert not got["tp"] and got["experts"] == 3
        held_to_jax(got, ref, UNSPLIT)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("leg", TRAIN_LEGS, ids=lambda leg: "-".join(
    map(str, leg)))
def test_train_step_at_rest_matches_jax(runs, mesh, leg):
    """One AdamW step at rest on the model axis's pieces equals the JAX
    single-device step: the loss within ``TRAIN_LOSS_TOL``, the gradient
    norm within 1e-4, every leaf (the weights every model rank holds
    whole among them: norms, ``q_scale``/``k_scale``, the router, KV
    weights that fall back) within ``TRAIN_RTOL``/``TRAIN_ATOL``."""
    out, ref = runs
    want = ref[("train", leg[0])]
    results = [r[leg] for r in out[mesh]["train"]]
    for r in results:
        assert abs(r["metrics"]["loss"] - want["loss"]) < TRAIN_LOSS_TOL
        assert abs(r["metrics"]["grad_norm"] - want["grad_norm"]) < 1e-4 * \
            max(1.0, want["grad_norm"])
        # the data axis's gradient reduce-scatters, and the sequence's
        if MESHES[mesh][0] > 1 or leg[3]:
            assert r["calls"]["reduce_scatter"] > 0
    got = results[0]["params"]
    assert set(got) == set(want["params"])
    for n, w in want["params"].items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), err_msg=n,
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL)


# ep is the variant for dbrx-132b's 16 experts (qwen2-moe's 60 do not
# split over 16 ranks: under ep its model keeps the whole-row path)
PIECE_CASES = [(a, "default") for a in SEVEN] + [
    (a, "ep") for a in SEVEN if a != "qwen2-moe-a2.7b"]


@pytest.mark.parametrize("arch,preset", PIECE_CASES)
def test_compute_pieces_are_the_jax_gather_fsdp_spec(arch, preset):
    """On the production mesh (16 x 16, no ranks), every leaf's
    compute-time layout (``ShardCtx.fsdp_spec``) is the spec the JAX
    ``ShardCtx.gather_fsdp`` constrains the weight to (its FSDP axes
    dropped, each dim fitted), its local shape a rank's piece; the heads,
    the ffn (or experts under ``ep``) and the vocabulary split over the
    model axis."""
    from repro.sharding import ctx as jctx
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import LayoutMesh, make_ctx, \
        production_shape
    from repro_torch.models import lm as tlm
    from repro_torch.sharding import Layout
    shape = production_shape()
    ctx = make_ctx(LayoutMesh(shape), preset=preset)
    jax_ctx = jctx.ShardCtx(mesh=SimpleNamespace(shape=shape),
                            dp=ctx.dp, rules=dict(ctx.rules))
    cfg = get_config(arch)
    axes, shapes = tlm.param_axes(cfg), tlm.param_shapes(cfg)
    leaves = [(f"layers.{k}", a[1:], shapes["layers"][k][1:])
              for k, a in axes["layers"].items()]
    leaves += [(k, axes[k], shapes[k]) for k in axes if k != "layers"]
    split = set()
    for name, ax, sh in leaves:
        want = []
        for i, logical in enumerate(ax):
            want.append(jax_ctx._fit_axis(jax_ctx._drop_fsdp(
                jax_ctx._resolve(logical)), sh[i]))
        while want and want[-1] is None:
            want.pop()
        got = ctx.fsdp_spec(ax, sh)
        assert got == tuple(want), name
        local = Layout(ctx, got).local_shape(sh)
        assert math.prod(local) * math.prod(
            ctx.axis_size(e) for e in got if e is not None) == math.prod(sh)
        if "model" in got:
            split.add(name.split(".")[-1])
    need = {"wq", "wo", "embed"} | (
        {"we1", "we2"} if cfg.family == "moe" else {"w1", "w2"})
    assert need <= split, need - split


@pytest.mark.parametrize("preset,on", [("default", True), ("ep", True),
                                       ("fsdp", False), ("cp", False)])
def test_tensor_parallel_runs_where_the_model_axis_splits_work(preset, on):
    """``ShardCtx.tensor_parallel``: an enabled ctx whose attention is
    ``tp`` and whose model axis is no data axis; never a null ctx."""
    from repro_torch.launch.mesh import LayoutMesh, make_ctx, \
        production_shape
    from repro_torch.sharding import ShardCtx
    ctx = make_ctx(LayoutMesh(production_shape()), preset=preset)
    assert ctx.tensor_parallel is on
    assert not ShardCtx.null().tensor_parallel


def test_partial_sums_are_f32_when_serving_a_bf16_model():
    """``layers.partial_mm``: a bf16 product whose result is one rank's
    partial sum comes back in f32 outside autograd (the ranks' sum then
    rounds once), the f32 product of the same values; under autograd, and
    in f32, it is ``x @ w``."""
    from repro_torch.models.layers import partial_mm
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 16, generator=g).to(torch.bfloat16)
    w = torch.randn(16, 8, generator=g).to(torch.bfloat16)
    with torch.no_grad():
        got = partial_mm(x, w)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, x.float() @ w.float(), rtol=0, atol=0)
    assert partial_mm(x.requires_grad_(), w).dtype == torch.bfloat16
    xf, wf = x.detach().float(), w.float()
    assert torch.equal(partial_mm(xf, wf), xf @ wf)
