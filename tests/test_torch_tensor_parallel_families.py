"""Tensor parallelism on the model axis for the ssm, hybrid and encdec
families (rwkv6-7b, hymba-1.5b, whisper-medium) across real ranks, held
against the JAX package's single-device results.

Two spawns of four gloo ranks (``test_torch_distributed.spawn``): mesh
(2, 2) and mesh (1, 4) as (data, model).  The reduced configs run in f32
on the JAX package's weights (``params_from_jax``).  ``HYMBA5`` is reduced
hymba-1.5b with 5 query heads and 5 KV heads: its attention splits over
neither model axis here while its 8 mamba heads do, the pattern of
hymba-1.5b's 25 / 5 attention heads on 16 model ranks, so its attention
keeps whole rows (``lm.split_parts``).  Under ``seq_shard`` the serving
legs run K2's, K6's and K7's plain versions at the ``attention``,
``rwkv_wkv`` and ``ssm_chunk`` sites through recording impls; without it,
the plain model path.  The rank processes import neither ``jax`` nor
``repro``.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_distributed import (CP_TOL, SRC, TRAIN_ATOL, TRAIN_LOSS_TOL,
                                    TRAIN_RTOL, spawn)

HYMBA5 = "hymba-5-heads"
ARCHS = ("rwkv6-7b", "hymba-1.5b", HYMBA5, "whisper-medium")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
ROWS, SEQ, MAX_NEW = 4, 16, 4
TRAIN_ROWS = 4
JOBS = ("serve", "train")
# the recurrent cache entries a rank holds its heads' (or channels') of,
# and their split dim (the layer axis first)
STATE = {"wkv": 2, "ssm": 2, "conv": 3}


def reduced(get_config, arch):
    """``arch``'s reduced config in f32 (``HYMBA5`` as above), from either
    package's ``get_config``."""
    cfg = dataclasses.replace(
        get_config("hymba-1.5b" if arch == HYMBA5 else arch).reduced(),
        param_dtype="float32")
    if arch == HYMBA5:
        cfg = dataclasses.replace(cfg, n_heads=5, n_kv_heads=5)
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


def recording_sites(shapes):
    """K2's, K6's and K7's wrappers (their plain versions on the CPU) at
    their sites, each call's head shapes appended to ``shapes``."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv_wkv import wkv
    from repro_torch.kernels.ssd_scan import ssd
    from repro_torch.models.ssm import stateful_site

    def rec(site, fn):
        def impl(*args, **kw):
            a, b = args[0], args[1]
            shapes.append((site, tuple(a.shape), tuple(b.shape)))
            return fn(*args, **kw)
        return impl
    return {"attention": rec("attention", functools.partial(
                flash_attention, device="cpu")),
            "rwkv_wkv": rec("rwkv_wkv", stateful_site(functools.partial(
                wkv, device="cpu"))),
            "ssm_chunk": rec("ssm_chunk", stateful_site(functools.partial(
                ssd, device="cpu")))}


def states(cache):
    return {n: cache[n].clone() for n in STATE if n in cache}


def job_serve(mesh, rank, tmp):
    """Each arch at rest under ``default``, with ``seq_shard`` on (the
    kernels' plain versions at their sites, recorded) and off: forward
    (decoder-only), prefill's logits and recurrent state, one decode
    step's logits and state, generate()'s tokens; the parts that split;
    hymba's ``w_in`` columns of the rank's channels."""
    import contextlib
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.serve import generate
    out = {}
    for arch in ARCHS:
        toks, nxt = load(tmp, f"tokens_{arch}"), load(tmp, f"next_{arch}")
        frames = load(tmp, f"frames_{arch}") if arch == "whisper-medium" \
            else None
        for sp in (True, False):
            ctx = make_ctx(mesh, preset="default", seq_shard=sp)
            r0, r1 = ctx.sharding(("batch", None), tuple(toks.shape)).bounds(
                tuple(toks.shape))[0]
            model = at_rest(arch, ctx, tmp)
            mine, fr = toks[r0:r1], None if frames is None else frames[r0:r1]
            shapes = []
            with contextlib.ExitStack() as scope, torch.no_grad():
                if sp:
                    for site, fn in recording_sites(shapes).items():
                        scope.enter_context(ops.use_impl(site, fn))
                if frames is None:
                    hidden, _ = model.forward(mine)
                    logits, cache = model.prefill(mine, max_len=SEQ + MAX_NEW)
                else:
                    hidden = None
                    logits, cache = model.prefill(mine, fr,
                                                  max_len=SEQ + MAX_NEW)
                prefilled = states(cache)
                step, cache = model.decode_step(cache, nxt[r0:r1], SEQ)
                gen = generate(model, mine.numpy(), max_new=MAX_NEW,
                               device="cpu", **({} if fr is None
                                                else {"frames": fr}))
            tp = model._tp(SEQ)
            got = {"hidden": hidden, "logits": logits, "step": step,
                   "rows": (r0, r1), "tokens": gen, "shapes": shapes,
                   "prefilled": prefilled, "decoded": states(cache),
                   "tp": None if tp is None else (tp.rank, tp.n, tp.sp),
                   "parts": model._tp_parts}
            if arch == "hymba-1.5b" and tp is not None:
                w = model._layer_params(model.layers[0], tp)["mamba_w_in"]
                got["w_in"] = (tuple(w.shape), tp.paired_columns(
                    w, w.shape[-1] * tp.n // 2))
            out[(arch, sp)] = got
    return out


def job_train(mesh, rank, tmp):
    """One AdamW step at rest on this rank's rows for each arch, with
    ``seq_shard`` on and off: metrics, and on rank 0 every leaf gathered
    whole."""
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.launch.specs import token_layout
    from repro_torch.sharding import full
    from repro_torch.train import optim
    from repro_torch.train.steps import (make_train_step, model_params,
                                         param_layouts)
    out = {}
    for arch in ARCHS:
        for sp in (True, False):
            ctx = make_ctx(mesh, preset="default", seq_shard=sp)
            model = at_rest(arch, ctx, tmp)
            batch = load(tmp, f"batch_{arch}")
            lay = token_layout(ctx, *batch["tokens"].shape)
            r0, r1 = lay.bounds(tuple(batch["tokens"].shape))[0]
            params = model_params(model)
            step = make_train_step(model, optim.AdamWConfig(lr=1e-3))
            _, _, metrics = step(params, optim.init_state(
                params, param_layouts(model)),
                {k: v[r0:r1] for k, v in batch.items()})
            whole = {n: full(p).detach().clone() for n, p in params.items()}
            out[(arch, sp)] = {
                "metrics": {k: float(v) for k, v in metrics.items()},
                "tp": model._tp(SEQ) is not None,
                "params": whole if rank == 0 else None}
    return out


# ---- JAX side ------------------------------------------------------------
def jax_inputs(tmp):
    """The JAX package's weights of each arch and the inputs the ranks
    load (prompts, a decode step's token, frames, a train batch, all from
    a seed), saved under ``tmp``: (arch → (model, params, inputs), the
    starting weights by arch)."""
    import jax
    from repro.configs import get_config
    from repro.models import get_model
    from repro_torch.models.convert import params_from_jax

    def save(name, obj):
        torch.save(obj, os.path.join(tmp, name + ".pt"))

    made, start = {}, {}
    rng = np.random.default_rng(31)
    for arch in ARCHS:
        cfg = reduced(get_config, arch)
        m = get_model(cfg)
        params = m.init_params(jax.random.PRNGKey(1))
        start[arch] = params_from_jax(port_cfg(arch),
                                      jax.tree.map(np.asarray, params))
        save(f"params_{arch}", start[arch])
        inp = {"tokens": rng.integers(0, cfg.vocab_size, (ROWS, SEQ)),
               "next": rng.integers(0, cfg.vocab_size, (ROWS, 1))}
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (TRAIN_ROWS, SEQ)),
                 "targets": rng.integers(0, cfg.vocab_size,
                                         (TRAIN_ROWS, SEQ))}
        batch["targets"][0, :3] = -1
        if cfg.family == "encdec":
            inp["frames"] = rng.standard_normal(
                (ROWS, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
            batch["frames"] = rng.standard_normal(
                (TRAIN_ROWS, cfg.encoder.n_frames, cfg.d_model)).astype(
                    np.float32)
        for name, v in inp.items():
            save(f"{name}_{arch}", torch.from_numpy(v))
        save(f"batch_{arch}", {k: torch.from_numpy(v) for k, v in
                               batch.items()})
        made[arch] = (m, params, dict(inp, batch=batch))
    return made, start


def jax_references(made):
    """The JAX package's single-device results on ``jax_inputs``'."""
    import jax
    import jax.numpy as jnp
    from repro.serve import generate as jax_generate
    from repro.train import AdamWConfig, init_state
    from repro.train.steps import make_train_step
    from repro_torch.models.convert import params_from_jax

    ref = {}
    for arch, (m, params, inp) in made.items():
        toks = inp["tokens"]
        kw = {}
        if "frames" in inp:
            kw["frames"] = jnp.asarray(inp["frames"])
            logits, cache = m.prefill(params, toks, kw["frames"],
                                      max_len=SEQ + MAX_NEW)
        else:
            ref[("hidden", arch)] = np.asarray(jax.jit(m.forward)(
                params, toks)[0])
            logits, cache = m.prefill(params, toks, max_len=SEQ + MAX_NEW)
        ref[("logits", arch)] = np.asarray(logits)
        ref[("prefilled", arch)] = {n: np.asarray(cache[n]) for n in STATE
                                    if n in cache}
        step, cache = m.decode_step(params, cache, inp["next"], SEQ)
        ref[("step", arch)] = np.asarray(step)
        ref[("decoded", arch)] = {n: np.asarray(cache[n]) for n in STATE
                                  if n in cache}
        ref[("tokens", arch)] = np.asarray(jax_generate(
            m, params, toks, max_new=MAX_NEW, **kw))
        p_ref, _, m_ref = jax.jit(make_train_step(m, AdamWConfig(lr=1e-3)))(
            params, init_state(params), inp["batch"])
        ref[("train", arch)] = {
            "loss": float(m_ref["loss"]),
            "grad_norm": float(m_ref["grad_norm"]),
            "params": params_from_jax(port_cfg(arch), jax.tree.map(
                np.asarray, p_ref))}
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's weights and the inputs, then each mesh's spawn
    in a directory of its own holding them, in threads beside the JAX
    references."""
    import shutil
    import threading
    base = str(tmp_path_factory.mktemp("tpf"))
    made, start = jax_inputs(base)
    out, errors = {}, []

    def run(name, shape):
        try:
            out[name] = spawn(os.path.join(base, name), 4, JOBS,
                              module=__name__, mesh_shape=shape)
        except BaseException as e:      # re-raised below
            errors.append(e)
    threads = []
    for name, shape in MESHES.items():
        os.makedirs(os.path.join(base, name))
        for f in os.listdir(base):
            if f.endswith(".pt"):
                shutil.copy(os.path.join(base, f), os.path.join(base, name))
        threads.append(threading.Thread(target=run, args=(name, shape)))
        threads[-1].start()
    try:
        ref = jax_references(made)
    finally:
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    for arch, w in start.items():
        ref[("start", arch)] = w
    return out, ref


def expected_parts(arch):
    """The parts that split over 2 or 4 model ranks at reduced width."""
    if arch == "rwkv6-7b":
        return {"vocab": True, "time_mix": True, "channel_mix": True}
    parts = {"vocab": True, "attn": arch != HYMBA5, "mlp": True}
    if arch != "whisper-medium":
        parts["mamba"] = True
    return parts


def state_heads(want, rows, rank, n, name):
    """The rank's heads (or channels) of a JAX recurrent state [L, B, ...]
    for its rows."""
    dim = STATE[name]
    m = want.shape[dim] // n
    return np.take(want[:, rows[0]:rows[1]],
                   range(rank * m, (rank + 1) * m), axis=dim)


# ---- the checks ------------------------------------------------------------
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sp", [True, False], ids=["seq_shard",
                                                   "no_seq_shard"])
def test_serving_matches_jax(runs, mesh, arch, sp):
    """The parts ``split_parts`` names split (``HYMBA5``'s attention on
    whole rows); forward (the rank's rows, its S/n under sequence
    parallelism), prefill's and a decode step's whole logits within
    ``CP_TOL`` of the JAX package's, the padded vocabulary masked,
    generate()'s tokens equal, and the recurrent state after prefill and
    after decode the rank's heads (channels) of the JAX state."""
    out, ref = runs
    cfg = port_cfg(arch)
    n = MESHES[mesh][1]
    V = cfg.vocab_size
    for r in out[mesh]["serve"]:
        got = r[(arch, sp)]
        rank, tn, tsp = got["tp"]
        assert tn == n and tsp == sp
        assert got["parts"] == expected_parts(arch)
        rows = got["rows"]
        if got["hidden"] is not None:
            m = SEQ // n if sp else SEQ
            want = ref[("hidden", arch)][rows[0]:rows[1],
                                         rank * m if sp else 0:][:, :m]
            assert got["hidden"].shape == want.shape
            assert np.abs(got["hidden"].numpy() - want).max() < CP_TOL
        for key in ("logits", "step"):
            wl = ref[(key, arch)][rows[0]:rows[1]]
            assert got[key].shape[-1] == cfg.padded_vocab()
            err = np.abs(got[key].numpy()[..., :V] - wl[..., :V]).max()
            assert err < CP_TOL, (key, err)
        np.testing.assert_array_equal(got["tokens"],
                                      ref[("tokens", arch)][rows[0]:rows[1]])
        for when in ("prefilled", "decoded"):
            assert set(got[when]) == set(ref[(when, arch)])
            for name, want in ref[(when, arch)].items():
                want = state_heads(want, rows, rank, n, name)
                g = got[when][name].numpy()
                assert g.shape == want.shape, (when, name)
                scale = max(1.0, float(np.abs(want).max()))
                assert np.abs(g - want).max() < CP_TOL * scale, (when, name)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_sites_get_the_ranks_heads(runs, mesh, arch):
    """Under ``seq_shard`` the sites see the rank's heads: K6 [B, S,
    H/n, K] at ``rwkv_wkv``, K7 [B, S, H_m/n, P] at ``ssm_chunk``, K2 the
    rank's H/n query and KV heads at ``attention`` (every head where
    attention keeps whole rows, ``HYMBA5``); whisper's encoder (S = T =
    the frames), prefill self-attention and cross-attention (T = the
    frames) at prefill and at every decode step, as in
    ``test_k2_gets_the_ranks_heads_and_their_kv_heads``."""
    out, _ = runs
    cfg = port_cfg(arch)
    n = MESHES[mesh][1]
    hd = cfg.resolved_head_dim
    for r in out[mesh]["serve"]:
        shapes = r[(arch, True)]["shapes"]
        b = r[(arch, True)]["rows"][1] - r[(arch, True)]["rows"][0]
        sites = {s for s, _, _ in shapes}
        if arch == "rwkv6-7b":
            H, K = cfg.d_model // cfg.ssm.head_dim, cfg.ssm.head_dim
            assert sites == {"rwkv_wkv"}
            assert {(a, c) for _, a, c in shapes} == {
                ((b, SEQ, H // n, K), (b, SEQ, H // n, K))}
            continue
        att = [(a, c) for s, a, c in shapes if s == "attention"]
        heads = ((cfg.n_heads, cfg.n_kv_heads) if arch == HYMBA5 else
                 (cfg.n_heads // n, cfg.n_kv_heads // n))
        assert {(a[2], c[2]) for a, c in att} == {heads}
        assert all(a[3] == hd for a, _ in att)
        if arch == "whisper-medium":
            F = cfg.encoder.n_frames
            # the encoder's layers, prefill's self and cross attention
            # (twice: prefill itself and generate()'s), and generate()'s
            # decode steps' cross attention
            want = sorted([(F, F)] * cfg.encoder.n_layers * 2
                          + [(SEQ, SEQ), (SEQ, F)] * cfg.n_layers * 2
                          + [(1, F)] * cfg.n_layers * (MAX_NEW - 1 + 1))
            assert sorted((a[1], c[1]) for a, c in att) == want
            continue
        _, hm, P = (cfg.ssm.expand * cfg.d_model,
                    cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim,
                    cfg.ssm.head_dim)
        ssd = [a for s, a, _ in shapes if s == "ssm_chunk"]
        assert ssd and {a for a in ssd} == {(b, SEQ, hm // n, P)}
        assert len(att) == len(ssd)


@pytest.mark.parametrize("mesh", MESHES)
def test_w_in_takes_the_ranks_xi_and_z_columns(runs, mesh):
    """hymba's fused ``w_in`` [d, 2·d_in]: a rank's piece is 2·d_in/n
    contiguous columns (on 2 ranks rank 0 holds all of ``xi``, rank 1 all
    of ``z``); ``TensorParallel.paired_columns`` hands each rank the
    columns of its d_in/n channels from both halves."""
    out, ref = runs
    n = MESHES[mesh][1]
    cfg = port_cfg("hymba-1.5b")
    d_in = cfg.ssm.expand * cfg.d_model
    w = ref[("start", "hymba-1.5b")]["layers.0.mamba_w_in"].numpy()
    c = d_in // n
    for r in out[mesh]["serve"]:
        got = r[("hymba-1.5b", True)]
        rank = got["tp"][0]
        shape, cols = got["w_in"]
        assert shape == (cfg.d_model, 2 * d_in // n)
        assert tuple(cols.shape) == (cfg.d_model, 2 * c)
        np.testing.assert_array_equal(cols[:, :c].numpy(),
                                      w[:, rank * c:(rank + 1) * c])
        np.testing.assert_array_equal(
            cols[:, c:].numpy(), w[:, d_in + rank * c:d_in + (rank + 1) * c])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sp", [True, False], ids=["seq_shard",
                                                   "no_seq_shard"])
def test_train_step_at_rest_matches_jax(runs, mesh, arch, sp):
    """One AdamW step at rest on the model axis's pieces equals the JAX
    single-device step: the loss within ``TRAIN_LOSS_TOL``, the gradient
    norm within 1e-4, every leaf within ``TRAIN_RTOL``/``TRAIN_ATOL`` (the
    weights every model rank holds whole but uses on its part among them:
    RWKV's ``mu_*``, ``decay_lora_a``, ``ln_x_*``; the norms under
    sequence parallelism; ``HYMBA5``'s whole-row attention)."""
    out, ref = runs
    want = ref[("train", arch)]
    results = [r[(arch, sp)] for r in out[mesh]["train"]]
    for r in results:
        assert r["tp"]
        assert abs(r["metrics"]["loss"] - want["loss"]) < TRAIN_LOSS_TOL
        assert abs(r["metrics"]["grad_norm"] - want["grad_norm"]) < 1e-4 * \
            max(1.0, want["grad_norm"])
    got = results[0]["params"]
    assert set(got) == set(want["params"])
    for name, w in want["params"].items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   err_msg=name, rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL)


# ---- decisions and layouts with no ranks -----------------------------------
FULL = ("rwkv6-7b", "hymba-1.5b", "whisper-medium")


def full_ctx(n):
    from repro_torch.launch.mesh import LayoutMesh, make_ctx
    return make_ctx(LayoutMesh({"data": 256 // n, "model": n}),
                    preset="default")


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("arch", FULL)
def test_split_parts_at_full_width(arch, n):
    """``lm.split_parts`` at full width: hymba-1.5b's attention (25 heads,
    5 KV heads) keeps whole rows on 2, 4 and 16 model ranks, its mamba
    mixer (50 heads) splits on 2 but not on 4 or 16, its MLP (5504) and
    vocabulary (32256) split; rwkv6-7b (64 heads, d_ff 14336, 65536) and
    whisper-medium (16 heads, 4096, 51968) split fully."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import split_parts
    got = split_parts(get_config(arch), full_ctx(n))
    if arch == "rwkv6-7b":
        want = {"vocab": True, "time_mix": True, "channel_mix": True}
    elif arch == "whisper-medium":
        want = {"vocab": True, "attn": True, "mlp": True}
    else:
        want = {"vocab": True, "attn": False, "mlp": True,
                "mamba": n == 2}
    assert got == want


def jax_fsdp_spec(jax_ctx, axes, shape):
    """The entries the JAX ``gather_fsdp`` builds its ``PartitionSpec``
    from (``src/repro/sharding/ctx.py:196-203``), duplicates and all."""
    want = [jax_ctx._fit_axis(jax_ctx._drop_fsdp(jax_ctx._resolve(a)),
                              shape[i]) for i, a in enumerate(axes)]
    while want and want[-1] is None:
        want.pop()
    return tuple(want)


def dedup(entries):
    out, used = [], set()
    for e in entries:
        names = () if e is None else (e,) if isinstance(e, str) else e
        if any(a in used for a in names):
            e = None
        used.update(() if e is None else names)
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def leaves(arch, cfg):
    if cfg.family == "encdec":
        from repro_torch.models import whisper as m
    else:
        from repro_torch.models import lm as m
    axes, shapes = m.param_axes(cfg), m.param_shapes(cfg)
    out = []
    for k, a in axes.items():
        if isinstance(a, dict):
            out += [(f"{k}.{n}", ax[1:], shapes[k][n][1:])
                    for n, ax in a.items()]
        else:
            out.append((k, a, shapes[k]))
    return out


@pytest.mark.parametrize("n", [2, 16])
@pytest.mark.parametrize("arch", FULL)
def test_fsdp_spec_is_the_jax_gather_fsdp_spec(arch, n):
    """At full width on 2 and 16 model ranks every leaf's compute-time
    layout (``ShardCtx.fsdp_spec``) is the spec the JAX ``gather_fsdp``
    constrains it to, with a mesh axis an earlier dim took dropped from a
    later one: on 2 ranks hymba's ``mamba_w_dt`` ("ffn", "heads") fits
    ``model`` on both dims, where the JAX spec maps one axis to two dims
    (``test_jax_gather_fsdp_raises_on_a_duplicate_axis``) and the port
    keeps the first."""
    from repro.sharding import ctx as jctx
    from repro_torch.configs import get_config
    from repro_torch.sharding import Layout
    ctx = full_ctx(n)
    jax_ctx = jctx.ShardCtx(mesh=SimpleNamespace(shape=dict(
        ctx.mesh.shape)), dp=ctx.dp, rules=dict(ctx.rules))
    cfg = get_config(arch)
    dups = []
    for name, ax, sh in leaves(arch, cfg):
        want = jax_fsdp_spec(jax_ctx, ax, sh)
        got = ctx.fsdp_spec(ax, sh)
        if dedup(want) != want:
            dups.append(name)
        assert got == dedup(want), name
        assert Layout(ctx, got).local_shape(sh)
    assert dups == (["layers.mamba_w_dt"] if (arch, n) == ("hymba-1.5b", 2)
                    else [])


JAX_DUP = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.sharding.ctx import ShardCtx
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
try:
    ShardCtx(mesh=mesh).gather_fsdp(jnp.zeros((128, 8)), ("ffn", "heads"))
except Exception as e:
    print(type(e).__name__)
else:
    print("no error")
"""


def test_jax_gather_fsdp_raises_on_a_duplicate_axis():
    """The JAX ``gather_fsdp`` on a (2, 2) CPU mesh, at reduced hymba's
    ``mamba_w_dt`` ([d_in 128, 8 heads], ("ffn", "heads")): both dims fit
    ``model`` and it raises ``DuplicateSpecError``; the port's
    ``fsdp_spec`` keeps ``model`` on the first dim alone."""
    from repro_torch.launch.mesh import LayoutMesh, make_ctx
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    got = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_DUP)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert got.stdout.strip().splitlines()[-1] == "DuplicateSpecError", \
        got.stderr[-2000:]
    ctx = make_ctx(LayoutMesh({"data": 2, "model": 2}), preset="default")
    assert ctx.fsdp_spec(("ffn", "heads"), (128, 8)) == ("model",)
