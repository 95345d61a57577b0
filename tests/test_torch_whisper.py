"""The port's encoder–decoder (repro_torch.models.whisper.EncDecLM) against
the JAX package's ``EncDecLM`` on reduced whisper-medium in float32 (2
encoder and 2 decoder layers, d_model 64, 16 frames), starting from JAX
``init_params`` converted by ``params_from_jax``; frames and tokens from a
numpy seed.

* ``encode``, ``decode_parallel``'s hidden state, ``logits_fn``,
  ``prefill``'s logits and its four cache entries, 8 teacher-forced
  ``decode_step``s, and ``generate()``'s tokens (equal), without a kernel
  and with one at the ``attention`` site: the Pallas flash kernel in
  interpret mode on the JAX side, K2's wrapper (its plain version on the
  CPU) on the port's;
* the port's decode against its own parallel decoder, as
  tests/test_arch_smoke.py holds the reference;
* a ragged encoder (150 frames): the JAX plain path, the port's plain path
  and K2's wrapper agree, and the Pallas kernel refuses it at its
  ``S % block`` assert (a JAX-side fault, ROADMAP.md queue 3);
* the init rule per parameter name, ``layer_norm``, ``_project_qkv``
  without positions, the parameter specs at full size, bf16 conversion, and the
  refusals: frames of the wrong length, ``generate()`` without frames,
  the slot servers.

Tolerance 1e-5 absolute and relative in f32 (both sides run the same f32
arithmetic in another order; the differences seen are ≤ 1.5e-6), 1e-4
where a kernel stands at the site on both sides (the Pallas kernel's
online softmax sums in another order than the plain reference).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import get_model as jax_model
from repro.models import layers as JL
from repro.serve import generate as jax_generate
from repro.sharding.ctx import ShardCtx
from repro_torch.configs import EncoderSpec, get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models import whisper as W
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import init_rule
from repro_torch.models.lm import LM
from repro_torch.serve import BatchedServer, FixedBatchServer, generate

TOL = 1e-5
KERNEL_TOL = 1e-4


def reduced(get, **kw):
    return dataclasses.replace(get("whisper-medium").reduced(),
                               param_dtype="float32", **kw)


def make_pair(**kw):
    jm = jax_model(reduced(jax_config, **kw))
    jp = jm.init_params(jax.random.PRNGKey(0))
    cfg = reduced(get_config, **kw)
    tm = get_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model) with the same weights."""
    return make_pair()


@pytest.fixture(autouse=True)
def _clean_registry():
    ops.clear_all()
    jops.clear_all()
    yield
    ops.clear_all()
    jops.clear_all()


def frames(B, n_frames=16, d=64, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, n_frames, d)).astype(np.float32)


def tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def t(a):
    return torch.from_numpy(np.asarray(a))


def jax_pallas_impl(q, k, v, causal=True, softcap=0.0):
    return jax_flash(q, k, v, causal=causal, softcap=softcap)


class PortK2:
    """K2's wrapper (the plain version on the CPU) as the site impl, with
    the (causal, S, T) of every call it took."""

    def __init__(self):
        self.shapes = set()

    def __call__(self, q, k, v, *, causal, softcap):
        self.shapes.add((causal, q.shape[1], k.shape[1]))
        return flash_attention(q, k, v, causal=causal, softcap=softcap,
                               device="cpu")


# --------------------------------------------------------------------------
# the model against the JAX EncDecLM
# --------------------------------------------------------------------------
def test_encode(pair):
    jm, jp, tm = pair
    fr = frames(2)
    close(tm.encode(t(fr)), jm.encode(jp, jnp.asarray(fr)))


def test_decode_parallel_hidden_state_and_logits(pair):
    jm, jp, tm = pair
    fr, toks = frames(2, seed=1), tokens(2, 12, seed=1)
    enc = jm.encode(jp, jnp.asarray(fr))
    want_h, _ = jm.decode_parallel(jp, jnp.asarray(toks), enc)
    got_h, caches = tm.decode_parallel(t(toks).long(), tm.encode(t(fr)))
    assert caches is None
    close(got_h, want_h)
    close(tm.logits_fn(got_h), jm.logits_fn(jp, want_h))
    assert (tm.logits_fn(got_h)[..., 512:] == L.NEG_INF).all()


@pytest.mark.parametrize("impls", ["plain", "kernel"])
def test_prefill_logits_and_cache(pair, impls):
    """Prefill's logits and every cache entry (self K/V at [:S], zeros
    beyond; the cross K/V of each layer), with and without a kernel at
    the ``attention`` site."""
    jm, jp, tm = pair
    fr, toks = frames(3, seed=2), tokens(3, 10, seed=2)
    if impls == "kernel":
        jops.install("attention", jax_pallas_impl)
        ops.install("attention", PortK2())
    want_logits, want_cache = jm.prefill(jp, jnp.asarray(toks),
                                         jnp.asarray(fr), max_len=24)
    with torch.no_grad():
        got_logits, got_cache = tm.prefill(t(toks).long(), t(fr), max_len=24)
    tol = TOL if impls == "plain" else KERNEL_TOL
    close(got_logits, want_logits, tol)
    assert set(got_cache) == set(want_cache) == {"k", "v", "xk", "xv"}
    for name, c in got_cache.items():
        assert tuple(c.shape) == want_cache[name].shape, name
        close(c, want_cache[name], tol)


@pytest.mark.parametrize("impls", ["plain", "kernel"])
def test_decode_steps(pair, impls):
    """8 teacher-forced decode steps after a prefill of 8: every step's
    logits, and the self K/V the steps wrote in place."""
    jm, jp, tm = pair
    fr, toks = frames(2, seed=3), tokens(2, 16, seed=3)
    k2 = PortK2()
    if impls == "kernel":
        jops.install("attention", jax_pallas_impl)
        ops.install("attention", k2)
    tol = TOL if impls == "plain" else KERNEL_TOL
    _, jc = jm.prefill(jp, jnp.asarray(toks[:, :8]), jnp.asarray(fr),
                       max_len=16)
    step = jax.jit(jm.decode_step)
    with torch.no_grad():
        _, tc = tm.prefill(t(toks[:, :8]).long(), t(fr), max_len=16)
        for i in range(8, 16):
            want, jc = step(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                            jnp.int32(i))
            got, tc = tm.decode_step(tc, t(toks[:, i:i + 1]).long(), i)
            close(got, want, tol)
    close(tc["k"], jc["k"], tol)
    close(tc["v"], jc["v"], tol)
    if impls == "kernel":     # the encoder, decoder self, cross at S 8 and 1
        assert k2.shapes == {(False, 16, 16), (True, 8, 8), (False, 8, 16),
                             (False, 1, 16)}


@pytest.mark.parametrize("impls", ["plain", "kernel"])
def test_generate_tokens_equal_jax(pair, impls):
    jm, jp, tm = pair
    fr, toks = frames(2, seed=4), tokens(2, 6, seed=4)
    if impls == "kernel":
        jops.install("attention", jax_pallas_impl)
        ops.install("attention", PortK2())
    want = jax_generate(jm, jp, jnp.asarray(toks), max_new=8,
                        frames=jnp.asarray(fr))
    got = generate(tm, toks, max_new=8, frames=fr, device="cpu")
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, np.asarray(want))
    # a tensor on the model's device serves as well as numpy
    np.testing.assert_array_equal(
        generate(tm, toks, max_new=8, frames=t(fr), device="cpu"), got)


def test_decode_matches_parallel(pair):
    """Prefill of 16 then 8 decode steps against the parallel decoder over
    all 24 tokens, on the port's side alone (tests/test_arch_smoke.py's
    check of the reference, at its tolerance 2e-3)."""
    _, _, tm = pair
    fr, toks = t(frames(2, seed=5)), t(tokens(2, 24, seed=5)).long()
    with torch.no_grad():
        logits, cache = tm.prefill(toks[:, :16], fr, max_len=24)
        outs = [logits]
        for i in range(16, 24):
            lg, cache = tm.decode_step(cache, toks[:, i:i + 1], i)
            outs.append(lg)
        hidden, _ = tm.decode_parallel(toks, tm.encode(fr))
        ref = tm.logits_fn(hidden)[:, 15:, :512]
    dec = torch.cat(outs, dim=1)[..., :512]
    torch.testing.assert_close(dec, ref, rtol=2e-3, atol=2e-3)


# --------------------------------------------------------------------------
# whisper's 1500 frames: a ragged encoder
# --------------------------------------------------------------------------
def test_ragged_encoder_agrees_and_the_pallas_kernel_refuses_it():
    """150 frames (1500 = 11 × 128 + 92 at full size: no tile divides
    either).  The port's plain path and K2's wrapper agree with the JAX
    plain path; the JAX Pallas kernel asserts S % block_k == 0 and fails."""
    jm, jp, tm = make_pair(encoder=EncoderSpec(n_layers=2, n_frames=150,
                                               frame_dim=64))
    fr = frames(2, n_frames=150, seed=6)
    want = jm.encode(jp, jnp.asarray(fr))
    close(tm.encode(t(fr)), want)
    with ops.use_impl("attention", PortK2()):
        close(tm.encode(t(fr)), want)
    with jops.use_impl("attention", jax_pallas_impl):
        with pytest.raises(AssertionError):
            jm.encode(jp, jnp.asarray(fr))


# --------------------------------------------------------------------------
# parameters, layers, conversion
# --------------------------------------------------------------------------
def classify(a: np.ndarray):
    if np.all(a == 1):
        return "ones"
    if np.all(a == 0):
        return "zeros"
    return "normal"


def jax_rule(name: str, shape):
    """``repro.models.layers.init_from_spec``'s rule for one name."""
    if name.startswith("ln") or name.endswith("_scale"):
        return "ones"
    if name.startswith("b") or name.endswith("_bias"):
        return "zeros"
    return "normal"


def test_init_params_follows_the_jax_rule():
    """Same rule per name as JAX ``init_params``, names as they are:
    ``ln1_b`` … ``ln3_b`` are ones, ``x_bq``/``x_bk``/``x_bv``,
    ``final_ln``, ``final_ln_b``, ``enc_final_ln`` and ``enc_final_ln_b``
    (which do not start with ``ln`` or ``b``) are drawn normal; 5
    sample-std spreads allowed, as for glm4-9b."""
    cfg = reduced(get_config)
    tm = get_model(cfg, device="cpu")
    tm.init_params(torch.Generator().manual_seed(0))
    jp = jax_model(reduced(jax_config)).init_params(jax.random.PRNGKey(0))
    jflat = {f"{stack}.{i}.{k}": np.asarray(v[i])
             for stack in ("enc_layers", "dec_layers")
             for k, v in jp[stack].items() for i in range(v.shape[0])}
    jflat.update({f"top.{k}": np.asarray(v) for k, v in jp.items()
                  if not k.endswith("layers")})
    sd = tm.state_dict()
    assert set(sd) == set(jflat)
    for name in ("x_bq", "final_ln", "final_ln_b", "enc_final_ln_b"):
        assert init_rule(name, (64,))[0] == "normal"
    for name, a in sd.items():
        short = name.rsplit(".", 1)[-1]
        kind, std = init_rule(short, tuple(a.shape))
        a, j = a.numpy(), jflat[name]
        assert kind == jax_rule(short, a.shape), name
        assert classify(a) == classify(j) == kind, name
        if kind == "normal":
            slack = 5 / math.sqrt(2 * a.size)
            assert abs(a.std() / std - 1) < slack, (name, a.std(), std)
            assert abs(j.std() / std - 1) < slack, (name, j.std(), std)


def test_specs_match_jax_at_full_size():
    """whisper-medium's layer and top parameter shapes (no allocation)."""
    cfg, jm = get_config("whisper-medium"), jax_model(jax_config(
        "whisper-medium"))
    for ours, theirs in ((W.enc_layer_spec, jm.enc_layer_spec),
                         (W.dec_layer_spec, jm.dec_layer_spec),
                         (W.top_spec, jm.top_spec)):
        assert ours(cfg) == {k: s for k, (s, _) in theirs().items()}
    assert W.MAX_DECODER_POS == 32768


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm_matches_jax(dtype, bias):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    scale, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    want = JL.layer_norm(jnp.asarray(x, dtype), jnp.asarray(scale),
                         jnp.asarray(b) if bias else None, 1e-5)
    got = L.layer_norm(t(x).to(getattr(torch, dtype)), t(scale),
                       t(b) if bias else None, 1e-5)
    assert got.dtype == getattr(torch, dtype)
    close(got, np.asarray(want, np.float32),
          TOL if dtype == "float32" else 2.0 ** -7)


@pytest.mark.parametrize("S", [1, 5])
def test_project_qkv_without_positions_matches_jax(S):
    """Whisper's self-attention projection: positions None, which both
    sides' ``rope`` leaves unrotated at whisper's ``rope_theta`` 0."""
    jcfg = dataclasses.replace(jax_config("whisper-medium").reduced(),
                               param_dtype="float32")
    cfg = dataclasses.replace(get_config("whisper-medium").reduced(),
                              param_dtype="float32")
    assert cfg.rope_theta <= 0
    rng = np.random.default_rng(8)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in L.attn_param_spec(cfg).items()}
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    want = JL._project_qkv(jnp.asarray(x),
                           {k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                           ShardCtx.null(), positions=None)
    got = L._project_qkv(t(x), {k: t(v) for k, v in p.items()}, cfg, None)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g, w)


def test_conversion_checks_each_stack_and_keeps_bf16_bits():
    cfg = get_config("whisper-medium").reduced()          # bfloat16 params
    jp = jax.tree.map(np.asarray, jax_model(jax_config(
        "whisper-medium").reduced()).init_params(jax.random.PRNGKey(1)))
    tm = get_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(cfg, jp))
    np.testing.assert_array_equal(
        tm.dec_layers[1].x_wq.view(torch.int16).numpy(),
        np.asarray(jp["dec_layers"]["x_wq"][1]).view(np.int16))
    assert tm.top.enc_pos.dtype == torch.bfloat16
    assert not hasattr(tm.top, "lm_head")
    short = dict(jp, enc_layers={k: v[:1] for k, v in
                                 jp["enc_layers"].items()})
    with pytest.raises(ValueError, match="enc_layers.* stacks 1 layers, "
                       "config has 2"):
        params_from_jax(cfg, short)


# --------------------------------------------------------------------------
# the factory and the refusals
# --------------------------------------------------------------------------
def test_get_model_builds_enc_dec_and_lm_refuses_it():
    cfg = get_config("whisper-medium").reduced()
    assert isinstance(get_model(cfg, device="cpu"), W.EncDecLM)
    with pytest.raises(ValueError, match="get_model"):
        LM(cfg, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        W.EncDecLM(dataclasses.replace(cfg, encoder=None), device="cpu")
    with pytest.raises(ValueError, match="encdec config"):
        W.EncDecLM(get_config("glm4-9b").reduced(), device="cpu")


def test_frames_of_another_length_raise(pair):
    _, _, tm = pair
    for bad in (frames(2, n_frames=15), frames(2, d=32), frames(2)[0]):
        with pytest.raises(ValueError, match=r"frames must be \[B, 16, 64\]"):
            tm.encode(t(bad))


def test_generate_wants_frames_for_encdec_only(pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="needs frames="):
        generate(tm, tokens(2, 4), max_new=2, device="cpu")
    lm = get_model(dataclasses.replace(get_config("glm4-9b").reduced(),
                                       param_dtype="float32"), device="cpu")
    lm.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="no other model takes them"):
        generate(lm, tokens(2, 4), max_new=2, frames=frames(2),
                 device="cpu")


@pytest.mark.parametrize("server", [BatchedServer, FixedBatchServer])
def test_slot_servers_refuse_encdec(pair, server):
    _, _, tm = pair
    with pytest.raises(ValueError, match=r"serve an encdec model with "
                       r"generate\(\)"):
        server(tm, slots=2, max_len=32, device="cpu")
