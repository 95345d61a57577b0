"""Continuous-batching serving engine: ragged decode, bucketed packed
prefill, CUDA graphs re-captured at each swap epoch.

Port of ``repro.serve.decode``.  ``BatchedServer`` keeps a fixed pool of
KV-cache *slots* and streams greedy decode continuously:

* **Ragged decode** — a per-slot position vector is threaded through
  ``model.decode_step``, so every slot advances independently.
* **Bucketed packed prefill** — admitted prompts are grouped into
  power-of-two length buckets, right-padded to their bucket, and
  prefilled as one packed batch per bucket per admission wave.  Under
  causal attention the pad tail cannot influence earlier positions and pad
  K/V beyond the true length is masked out at decode, so packed prefill
  equals per-request prefill — except in the moe family, where an
  expert's capacity grows with the padded length, so a padded row may
  drop fewer tokens than the prompt alone (the JAX twin's docstring calls
  packing exact; the port mirrors its code).  The recurrent families
  (ssm, hybrid) pack exact-length groups instead: a pad token would enter
  the cumulative state (``padded_packing`` False, ``bucket_of`` the
  prompt length).
* **CUDA graphs** (``aot``, the counterpart of the JAX twin's per-bucket
  AOT executables) — one decode graph over all slots (token and positions
  in static buffers, greedy argmax inside, the live cache as its state:
  ``decode_step`` writes it in place) and, under padded packing, one
  prefill graph per (bucket, packed rows) for rows 1, 2, 4, … up to
  ``_next_pow2(slots)``, each holding prefill and argmax through whatever
  impls the registry holds at capture.  The splice of a prefill's cache
  rows into their slots runs eagerly after the replay.  All graphs of a
  server share one memory pool.  Graphs are captured at construction and
  re-captured at the first step boundary after ``ops.registry_epoch()``
  moves (a *swap epoch*); ``aot_compiles`` counts captures (the JAX name).
  Each capture is preceded by one eager warm-up run on the capture stream,
  the decode's on a scratch cache, so a re-capture mid-traffic leaves the
  live slots' cache untouched.  Capture holds ``device.DEVICE_LOCK``.
  A failed capture raises: the server never falls back to eager execution
  (the JAX twin falls back to a lazy jit; ROADMAP.md queue 3).  The swap
  epoch counts as seen only once its capture succeeded, so a failure
  raises again at every later step, and a packed prefill without its
  graph raises ``KeyError``.  ``aot``
  defaults to True on a CUDA model and False on the CPU, where True
  raises.  With ``aot=False`` every step runs eagerly and the model
  consults the registry on every call.
* **Per-bucket telemetry** — every prefill/decode event is observed at the
  ``attention`` site and tagged with the request's bucket.
* **Spans** (``repro_torch.tracing``, recorded only while a profiler or
  ``tracing.recording()`` is on) — ``serve.step`` over each bucket's
  ``serve.prefill`` and the decode's ``serve.inputs``, ``serve.replay``,
  ``serve.readback`` and ``serve.commit`` (``serve.splice`` under a
  prefill), a request's ``serve.queue`` from ``submit`` to its prefill,
  ``serve.capture`` a graph, and the counters ``serve.prefill_tokens`` and
  ``serve.prefill_positions`` (bucket × padded rows).  The replay, splice
  and readback have device intervals; ``serve.inputs``, the uploads from
  host arrays (which wait for the stream), is the host's.

Every decoder-only family (dense, vlm, moe, hybrid, ssm), with the int8
KV cache too (``LM(kv_quant=True)``); the cache's scales and
recurrent-state entries are spliced into their slots like K/V.  Both
servers refuse an encoder–decoder model, as the JAX twin's do: it is
served by ``generate(..., frames=...)``.  ``FixedBatchServer`` is
the pre-continuous baseline of the table-9 comparison (single shared
decode position, one prefill call per request), eager.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import DEVICE_LOCK, resolve_device
from repro_torch.kernels import ops

TELEMETRY_SITE = "attention"      # the site the flash kernel serves


def _check_model_device(model, dev: torch.device) -> None:
    if model.device.type != dev.type:
        raise ValueError(f"the model lives on {model.device}, not on {dev}")


@torch.no_grad()
def generate(model, prompts, *, max_new: int = 16, frames=None,
             eos_id: Optional[int] = None, device="cuda") -> np.ndarray:
    """Greedy generation for a fixed batch.  prompts: [B, S] ints (numpy or
    tensor); a sharded model takes its rank's shard of them (its rows;
    under context parallelism S/n of each row's positions, under tensor
    parallelism every position) and every rank returns the same tokens.
    An encoder–decoder model takes ``frames`` [B, n_frames, d_model]
    (numpy or tensor, moved to the model's device), which no other model
    takes.  With ``eos_id``, a sequence stops at its first EOS: every
    later column is ``eos_id``, and the loop exits once all rows finished.
    """
    dev = resolve_device(device)
    _check_model_device(model, dev)
    encdec = model.cfg.family == "encdec"
    if encdec != (frames is not None):
        raise ValueError("an encdec model needs frames= and no other model "
                         f"takes them ({model.cfg.name} is "
                         f"{model.cfg.family!r})")
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                              device=model.device)
    B = prompts.shape[0]
    S = model.sequence_length(prompts.shape[1])
    vocab = model.cfg.vocab_size
    if encdec:
        logits, cache = model.prefill(
            prompts, torch.as_tensor(frames, device=model.device),
            max_len=S + max_new)
    else:
        logits, cache = model.prefill(prompts, max_len=S + max_new)
    tok = logits[:, -1, :vocab].argmax(dim=-1)[:, None]
    done = (tok[:, 0] == eos_id) if eos_id is not None \
        else torch.zeros(B, dtype=torch.bool, device=model.device)
    out = [tok]
    for i in range(max_new - 1):
        if eos_id is not None and bool(done.all()):
            break
        logits, cache = model.decode_step(cache, tok, S + i)
        nxt = logits[:, -1, :vocab].argmax(dim=-1)[:, None]
        if eos_id is not None:
            nxt = torch.where(done[:, None], torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt[:, 0] == eos_id)
        tok = nxt
        out.append(tok)
    res = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
    if res.shape[1] < max_new:        # early EOS exit: pad-with-eos
        pad = np.full((B, max_new - res.shape[1]), eos_id, res.dtype)
        res = np.concatenate([res, pad], axis=1)
    return res


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    bucket: int = 0               # prefill length bucket admitted under


def _pow2_buckets(max_len: int, lo: int = 8) -> Tuple[int, ...]:
    """Power-of-two prompt-length buckets up to ``max_len``."""
    out, b = [], lo
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _graph_name(key: Tuple) -> str:
    """A graph's name in spans: ``decode`` or ``prefill/<bucket>/<rows>``."""
    return "/".join(map(str, key))


class _SlotServer:
    """What both servers share: the request queue, the slot pool and its
    cache, swap-epoch counting and the drain loop.  A server defines
    ``step``; ``_on_swap`` is what a registry change asks of it."""

    def __init__(self, model, *, slots: int, max_len: int,
                 eos_id: Optional[int], telemetry: Optional[ops.Telemetry],
                 device):
        if model.cfg.family == "encdec":
            raise ValueError(f"{type(self).__name__} serves decoder-only "
                             "models; serve an encdec model with generate()")
        dev = resolve_device(device)
        _check_model_device(model, dev)
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.telemetry = telemetry if telemetry is not None else ops.telemetry
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * slots
        self.finished: List[Request] = []
        self.pos = np.zeros(slots, np.int64)      # per-slot cache length
        self.cache = model.init_cache(slots, max_len)
        self.swap_epochs = 0                      # registry changes seen
        self._rid = itertools.count()
        self._queued: Dict[int, int] = {}         # rid -> its serve.queue span
        self._epoch = ops.registry_epoch()

    def bucket_of(self, prompt_len: int) -> int:
        """The prefill bucket a prompt is admitted under (one for all)."""
        return 0

    def submit(self, prompt: np.ndarray, max_new: int = 16) -> Request:
        req = Request(rid=next(self._rid), prompt=prompt, max_new=max_new,
                      bucket=self.bucket_of(len(prompt)))
        sid = tracing.begin("serve.queue", rid=req.rid,
                            prompt_len=len(prompt))
        if sid is not None:
            self._queued[req.rid] = sid
        self.queue.append(req)
        return req

    def _dequeued(self, reqs) -> None:
        """Ends the ``serve.queue`` spans of requests whose prefill
        starts."""
        for req in reqs:
            tracing.end(self._queued.pop(req.rid, None))

    def _finish(self, req: Request, slot: Optional[int]) -> None:
        req.done = True
        self.finished.append(req)
        if slot is not None:
            self.active[slot] = None          # slot recycled at next admit
            self.pos[slot] = 0

    def _on_swap(self) -> None:
        """Nothing: the eager model consults the registry on every call."""

    def _refresh_impls(self) -> None:
        """Swap epoch: if the ops registry changed since the last step
        boundary, ``_on_swap`` and count it.  The epoch is taken as seen
        only once ``_on_swap`` has succeeded, so a failure is met again at
        the next step.  In-flight requests keep their cache rows."""
        epoch = ops.registry_epoch()
        if epoch != self._epoch:
            self._on_swap()
            self._epoch = epoch
            self.swap_epochs += 1

    def run(self, max_steps: int = 1000) -> List[Request]:
        """Drive steps until the queue *and* the slots are both drained."""
        for _ in range(max_steps):
            if not self.queue and all(a is None for a in self.active):
                break
            self.step()
        return self.finished


class BatchedServer(_SlotServer):
    """Continuous-batching greedy server over a fixed slot count."""

    def __init__(self, model, *, slots: int = 4, max_len: int = 128,
                 eos_id: Optional[int] = None, aot: Optional[bool] = None,
                 telemetry: Optional[ops.Telemetry] = None,
                 device="cuda"):
        super().__init__(model, slots=slots, max_len=max_len, eos_id=eos_id,
                         telemetry=telemetry, device=device)
        on_card = model.device.type == "cuda"
        if aot is None:
            aot = on_card
        if aot and not on_card:
            raise ValueError(f"aot=True captures CUDA graphs, and the model "
                             f"lives on {model.device}: pass aot=False")
        # padding a packed batch is only exact when positions beyond a
        # row's true length cannot leak into it: causal attention masks
        # them, but cumulative recurrent state (ssm / hybrid) would absorb
        # the pads — those families pack exact-length groups instead
        self.padded_packing = model.cfg.family not in ("ssm", "hybrid")
        self.buckets: Tuple[int, ...] = (_pow2_buckets(max_len)
                                         if self.padded_packing else ())
        self.aot = aot
        self.aot_compiles = 0                     # graphs captured so far
        self.capture_s = 0.0                      # seconds capturing
        # key → (graph, static outputs, static inputs); key ("decode",) or
        # ("prefill", bucket, rows)
        self._graphs: Dict[Tuple, Tuple] = {}
        if aot:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(model.device)
            self._capture_all()

    # ------------------------------------------------------------ graphs --
    def _capture_all(self) -> None:
        """(Re)capture every graph against the current registry state, so
        a newly installed impl takes effect here and only here."""
        dev = self.model.device
        with DEVICE_LOCK, torch.no_grad():
            t0 = time.perf_counter()
            self._graphs.clear()              # the old graphs' pool memory
            toks = torch.zeros((self.slots, 1), dtype=torch.long, device=dev)
            pos = torch.zeros((self.slots,), dtype=torch.long, device=dev)
            scratch = {n: torch.zeros_like(c) for n, c in self.cache.items()}
            self._graphs[("decode",)] = self._capture(
                ("decode",), self._decode_body, (scratch, toks, pos),
                (self.cache, toks, pos), (toks, pos))
            del scratch
            if self.padded_packing:
                n = 1
                while n <= _next_pow2(self.slots):
                    for bucket in self.buckets:
                        args = (torch.zeros((n, bucket), dtype=torch.long,
                                            device=dev),
                                torch.ones((n,), dtype=torch.long,
                                           device=dev))
                        key = ("prefill", bucket, n)
                        self._graphs[key] = self._capture(
                            key, self._prefill_body, args, args, args)
                    n *= 2
            torch.cuda.synchronize(dev)
            self.capture_s += time.perf_counter() - t0

    def _capture(self, key: Tuple, body: Callable, warm_args, args, static):
        """One eager warm-up run of ``body(*warm_args)`` on the capture
        stream (first-call costs stay out of the graph), then ``body(*args)``
        captured into a graph of this server's pool.  Returns (graph,
        outputs, ``static``: the inputs a replay refills); raises if the
        capture fails."""
        what = _graph_name(key)
        current = torch.cuda.current_stream(self.model.device)
        with tracing.span("serve.capture", graph=what):
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                body(*warm_args)
            current.wait_stream(self._stream)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=self._pool,
                                      stream=self._stream):
                    out = body(*args)
            except Exception as e:
                raise RuntimeError(f"CUDA graph capture of the {what} step "
                                   f"failed: {type(e).__name__}: {e}") from e
        self.aot_compiles += 1
        return graph, out, static

    def _decode_body(self, cache, toks, pos):
        logits, _ = self.model.decode_step(cache, toks, pos)
        return logits[:, -1, :self.model.cfg.vocab_size].argmax(dim=-1)

    def _prefill_body(self, toks, lens):
        logits, cache1 = self.model.prefill(toks, max_len=self.max_len,
                                            lengths=lens)
        return (logits[:, -1, :self.model.cfg.vocab_size].argmax(dim=-1),
                cache1)

    def _replay(self, key, *inputs):
        """Copy ``inputs`` (host arrays) into the graph's static inputs,
        replay it, and return its static outputs."""
        graph, out, static = self._graphs[key]
        name = _graph_name(key) if tracing.on() else None
        with tracing.span("serve.inputs", graph=name):
            for buf, x in zip(static, inputs):
                buf.copy_(torch.from_numpy(x))
        with tracing.span("serve.replay", self.model.device, graph=name):
            graph.replay()
        return out

    def _on_swap(self) -> None:
        """Re-capture every graph against the changed registry; a failed
        capture raises here, and again at every later step."""
        if self.aot:
            self._capture_all()

    # --------------------------------------------------------- admission --
    def bucket_of(self, prompt_len: int) -> int:
        """The prefill bucket a prompt of this length is admitted under (its
        own length under exact-length packing)."""
        if not self.padded_packing:
            if prompt_len > self.max_len:
                raise ValueError(f"prompt length {prompt_len} exceeds "
                                 f"max_len={self.max_len}")
            return prompt_len
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(f"prompt length {prompt_len} exceeds the largest "
                         f"bucket {self.buckets[-1]} (max_len={self.max_len})")

    def _prefill(self, toks: np.ndarray, lens: np.ndarray,
                 si: np.ndarray) -> np.ndarray:
        """Packed prefill + greedy pick + slot splice: row r lands in cache
        slot si[r]; pad rows carry si == slots and are dropped."""
        dev = self.model.device
        key = ("prefill", toks.shape[1], toks.shape[0])
        graph = _graph_name(key) if tracing.on() else None
        if self.aot and self.padded_packing:  # a missing graph raises
            first, cache1 = self._replay(key, toks, lens)
        else:
            with tracing.span("serve.inputs", graph=graph):
                toks = torch.as_tensor(toks, dtype=torch.long, device=dev)
                lens = torch.as_tensor(lens, dtype=torch.long, device=dev)
            with tracing.span("serve.replay", dev, graph=graph):
                first, cache1 = self._prefill_body(toks, lens)
        keep = np.flatnonzero(si < self.slots)
        with tracing.span("serve.inputs", graph=graph):
            rows = torch.as_tensor(keep, device=dev)
            dst = torch.as_tensor(si[keep], device=dev)
        with tracing.span("serve.splice", dev, rows=len(keep)):
            for name, big in self.cache.items():
                big[:, dst] = cache1[name][:, rows]
        with tracing.span("serve.readback", dev, graph=graph):
            return first.cpu().numpy()

    def _decode(self, toks: np.ndarray) -> np.ndarray:
        """One ragged decode over every slot at the per-slot positions:
        the next token of each slot.  Dead slots decode a dummy token at
        pos 0 (their row is fully overwritten at the next admission)."""
        dev = self.model.device
        if self.aot:
            nxt = self._replay(("decode",), toks, self.pos)
        else:
            with tracing.span("serve.inputs", graph="decode"):
                toks = torch.as_tensor(toks, device=dev)
                pos = torch.as_tensor(self.pos, device=dev)
            with tracing.span("serve.replay", dev, graph="decode"):
                nxt = self._decode_body(self.cache, toks, pos)
        with tracing.span("serve.readback", dev, graph="decode"):
            return nxt.cpu().numpy()

    def _admit(self) -> int:
        """Drain the queue into free slots, one packed prefill call per
        bucket per wave.  Returns the number of requests admitted."""
        admitted = 0
        while self.queue:
            free = [s for s in range(self.slots) if self.active[s] is None]
            if not free:
                break
            wave, rest = self.queue[:len(free)], self.queue[len(free):]
            self.queue = rest
            admitted += len(wave)
            groups = {}
            for req in wave:                  # FIFO within each bucket
                groups.setdefault(req.bucket, []).append(req)
            fi = 0
            finished_at_prefill = False
            for bucket, reqs in groups.items():
                n_pad = _next_pow2(len(reqs))  # bounded set of shapes
                with tracing.span("serve.prefill", bucket=bucket,
                                  rows=len(reqs), padded_rows=n_pad) as sp:
                    if self._queued:
                        self._dequeued(reqs)
                    if tracing.on():
                        sp.set(rids=[req.rid for req in reqs])
                        tracing.count("serve.prefill_tokens",
                                      sum(len(req.prompt) for req in reqs))
                        tracing.count("serve.prefill_positions",
                                      bucket * n_pad)
                    toks = np.zeros((n_pad, bucket), np.int64)
                    lens = np.ones((n_pad,), np.int64)
                    # tentative slot per row; pad rows point past the pool
                    # and are dropped by the splice.  A row whose request
                    # finishes at its prefill token leaves garbage in a slot
                    # that stays free — dead slots are masked at decode and
                    # overwritten on re-admission.
                    si = np.full((n_pad,), self.slots, np.int64)
                    for r, req in enumerate(reqs):
                        toks[r, :len(req.prompt)] = req.prompt
                        lens[r] = len(req.prompt)
                        si[r] = free[fi]
                        fi += 1
                    first = self._prefill(toks, lens, si)
                for r, req in enumerate(reqs):
                    tok = int(first[r])
                    req.tokens.append(tok)
                    self.telemetry.observe(
                        TELEMETRY_SITE, scale=len(req.prompt),
                        tokens=len(req.prompt), kind="prefill",
                        bucket=bucket)
                    if ((self.eos_id is not None and tok == self.eos_id)
                            or len(req.tokens) >= req.max_new):
                        self._finish(req, None)  # done at prefill
                        finished_at_prefill = True
                        continue
                    self.active[si[r]] = req
                    self.pos[si[r]] = len(req.prompt)
            if not finished_at_prefill:
                break                         # all tentative slots taken
            # some requests finished at prefill: their slots are still
            # free, loop to admit more while the queue has work
        return admitted

    # ------------------------------------------------------------- steps --
    @torch.no_grad()
    def step(self) -> int:
        """One serving step: admit (packed prefill per bucket), then one
        ragged decode over every occupied slot.  Returns the amount of
        work done — requests admitted plus tokens decoded — so ``0``
        means the server is idle (queue empty, no live slots)."""
        with tracing.span("serve.step") as span:
            self._refresh_impls()
            worked = self._admit()
            live = [s for s in range(self.slots)
                    if self.active[s] is not None]
            span.set(live=len(live), admitted=worked)
            if not live:
                return worked
            toks = np.zeros((self.slots, 1), np.int64)
            for s in live:
                toks[s, 0] = self.active[s].tokens[-1]
            nxt = self._decode(toks)
            with tracing.span("serve.commit", rows=len(live)):
                for s in live:
                    req = self.active[s]
                    tok = int(nxt[s])
                    req.tokens.append(tok)
                    self.pos[s] += 1
                    # context length this token was decoded at (traffic
                    # weighting)
                    self.telemetry.observe(
                        TELEMETRY_SITE, scale=int(self.pos[s]), tokens=1,
                        kind="decode", bucket=req.bucket)
                    if ((self.eos_id is not None and tok == self.eos_id)
                            or len(req.tokens) >= req.max_new
                            or int(self.pos[s]) >= self.max_len):
                        self._finish(req, s)  # EOS / budget / cache full
            return worked + len(live)


class FixedBatchServer(_SlotServer):
    """Pre-continuous baseline: single shared decode position (all slots
    must stay length-aligned; prompts are expected at one ``prompt_len``),
    one prefill call per admitted request, eager.  Kept for the table-9
    old-vs-new serving comparison."""

    def __init__(self, model, *, slots: int = 4, prompt_len: int = 32,
                 max_len: int = 128, eos_id: Optional[int] = None,
                 telemetry: Optional[ops.Telemetry] = None,
                 device="cuda"):
        super().__init__(model, slots=slots, max_len=max_len, eos_id=eos_id,
                         telemetry=telemetry, device=device)
        self.prompt_len = prompt_len

    def _admit(self) -> None:
        vocab = self.model.cfg.vocab_size
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.pop(0)       # FIFO drain order
                if self._queued:
                    self._dequeued([req])
                logits, cache1 = self.model.prefill(
                    torch.as_tensor(req.prompt[None, :], dtype=torch.long,
                                    device=self.model.device),
                    max_len=self.max_len)
                for name, big in self.cache.items():
                    big[:, s:s + 1] = cache1[name]
                tok = int(logits[0, -1, :vocab].argmax())
                req.tokens.append(tok)
                self.telemetry.observe(TELEMETRY_SITE, scale=len(req.prompt),
                                       tokens=len(req.prompt),
                                       kind="prefill")
                if ((self.eos_id is not None and tok == self.eos_id)
                        or len(req.tokens) >= req.max_new):
                    self._finish(req, None)
                    continue
                self.active[s] = req
                self.pos[s] = len(req.prompt)

    @torch.no_grad()
    def step(self) -> bool:
        """One decode step for all occupied slots (single shared pos)."""
        self._refresh_impls()
        self._admit()
        live = [s for s in range(self.slots) if self.active[s] is not None]
        if not live:
            return False
        toks = np.zeros((self.slots, 1), np.int64)
        for s in live:
            toks[s, 0] = self.active[s].tokens[-1]
        pos = int(self.pos[live[0]] + len(self.active[live[0]].tokens) - 1)
        logits, self.cache = self.model.decode_step(
            self.cache, torch.as_tensor(toks, device=self.model.device), pos)
        nxt = logits[:, -1, :self.model.cfg.vocab_size].argmax(dim=-1)
        nxt = nxt.cpu().numpy()
        for s in live:
            req = self.active[s]
            tok = int(nxt[s])
            req.tokens.append(tok)
            self.telemetry.observe(
                TELEMETRY_SITE, scale=int(self.pos[s]) + len(req.tokens) - 1,
                tokens=1, kind="decode")
            if ((self.eos_id is not None and tok == self.eos_id)
                    or len(req.tokens) >= req.max_new):
                self._finish(req, s)
        return True
