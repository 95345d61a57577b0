"""Continuous-batching serving engine: ragged decode, bucketed packed
prefill.

Port of ``repro.serve.decode``.  ``BatchedServer`` keeps a fixed pool of
KV-cache *slots* and streams greedy decode continuously:

* **Ragged decode** — a per-slot position vector is threaded through
  ``model.decode_step``, so every slot advances independently.
* **Bucketed packed prefill** — admitted prompts are grouped into
  power-of-two length buckets, right-padded to their bucket, and
  prefilled as one packed batch per bucket per admission wave.  Under
  causal attention the pad tail cannot influence earlier positions and pad
  K/V beyond the true length is masked out at decode, so packed prefill
  equals per-request prefill.
* **Swap epochs** — the registry (``ops.registry_epoch``) is re-checked at
  every step boundary and each change is counted.  Execution is eager, so
  the model consults the registry on every call and a newly installed impl
  serves the next prefill or decode; the JAX twin's per-bucket AOT
  executables become CUDA graphs in a later slice (ROADMAP).
* **Per-bucket telemetry** — every prefill/decode event is observed at the
  ``attention`` site and tagged with the request's bucket.

The dense family only: recurrent families (exact-length packing) and
``FixedBatchServer`` come with their ports.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

TELEMETRY_SITE = "attention"      # the site the flash kernel serves


def _check_model_device(model, dev: torch.device) -> None:
    if model.device.type != dev.type:
        raise ValueError(f"the model lives on {model.device}, not on {dev}")


@torch.no_grad()
def generate(model, prompts, *, max_new: int = 16,
             eos_id: Optional[int] = None, device="cuda") -> np.ndarray:
    """Greedy generation for a fixed batch.  prompts: [B, S] ints (numpy or
    tensor).  With ``eos_id``, a sequence stops at its first EOS: every
    later column is ``eos_id``, and the loop exits once all rows finished.
    """
    dev = resolve_device(device)
    _check_model_device(model, dev)
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                              device=model.device)
    B, S = prompts.shape
    vocab = model.cfg.vocab_size
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


class BatchedServer:
    """Continuous-batching greedy server over a fixed slot count."""

    def __init__(self, model, *, slots: int = 4, max_len: int = 128,
                 eos_id: Optional[int] = None,
                 telemetry: Optional[ops.Telemetry] = None,
                 device="cuda"):
        dev = resolve_device(device)
        _check_model_device(model, dev)
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.buckets: Tuple[int, ...] = _pow2_buckets(max_len)
        self.telemetry = telemetry if telemetry is not None else ops.telemetry
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * slots
        self.finished: List[Request] = []
        self.pos = np.zeros(slots, np.int64)      # per-slot cache length
        self.cache = model.init_cache(slots, max_len)
        self.swap_epochs = 0                      # registry changes seen
        self._rid = itertools.count()
        self._epoch = ops.registry_epoch()

    def _refresh_impls(self) -> None:
        """Swap epoch: count a registry change seen at this step boundary.
        In-flight requests keep their cache rows and continue undisturbed."""
        epoch = ops.registry_epoch()
        if epoch != self._epoch:
            self._epoch = epoch
            self.swap_epochs += 1

    # --------------------------------------------------------- admission --
    def bucket_of(self, prompt_len: int) -> int:
        """The prefill bucket a prompt of this length is admitted under."""
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(f"prompt length {prompt_len} exceeds the largest "
                         f"bucket {self.buckets[-1]} (max_len={self.max_len})")

    def submit(self, prompt: np.ndarray, max_new: int = 16) -> Request:
        req = Request(rid=next(self._rid), prompt=prompt, max_new=max_new,
                      bucket=self.bucket_of(len(prompt)))
        self.queue.append(req)
        return req

    def _finish(self, req: Request, slot: Optional[int]) -> None:
        req.done = True
        self.finished.append(req)
        if slot is not None:
            self.active[slot] = None          # slot recycled at next admit
            self.pos[slot] = 0

    def _prefill(self, toks: np.ndarray, lens: np.ndarray,
                 si: np.ndarray) -> np.ndarray:
        """Packed prefill + greedy pick + slot splice: row r lands in cache
        slot si[r]; pad rows carry si == slots and are dropped."""
        dev = self.model.device
        logits, cache1 = self.model.prefill(
            torch.as_tensor(toks, dtype=torch.long, device=dev),
            max_len=self.max_len,
            lengths=torch.as_tensor(lens, dtype=torch.long, device=dev))
        first = logits[:, -1, :self.model.cfg.vocab_size].argmax(dim=-1)
        keep = np.flatnonzero(si < self.slots)
        rows = torch.as_tensor(keep, device=dev)
        dst = torch.as_tensor(si[keep], device=dev)
        for name, big in self.cache.items():
            big[:, dst] = cache1[name][:, rows]
        return first.cpu().numpy()

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
                toks = np.zeros((n_pad, bucket), np.int64)
                lens = np.ones((n_pad,), np.int64)
                # tentative slot per row; pad rows point past the pool and
                # are dropped by the splice.  A row whose request finishes
                # at its prefill token leaves garbage in a slot that stays
                # free — dead slots are masked at decode and overwritten on
                # re-admission.
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
        self._refresh_impls()
        worked = self._admit()
        live = [s for s in range(self.slots) if self.active[s] is not None]
        if not live:
            return worked
        toks = np.zeros((self.slots, 1), np.int64)
        for s in live:
            toks[s, 0] = self.active[s].tokens[-1]
        # per-slot positions: dead slots decode a dummy token at pos 0
        # (their row is fully overwritten at the next admission)
        dev = self.model.device
        logits, self.cache = self.model.decode_step(
            self.cache, torch.as_tensor(toks, device=dev),
            torch.as_tensor(self.pos, device=dev))
        nxt = logits[:, -1, :self.model.cfg.vocab_size].argmax(dim=-1)
        nxt = nxt.cpu().numpy()
        for s in live:
            req = self.active[s]
            tok = int(nxt[s])
            req.tokens.append(tok)
            self.pos[s] += 1
            # context length this token was decoded at (traffic weighting)
            self.telemetry.observe(TELEMETRY_SITE, scale=int(self.pos[s]),
                                   tokens=1, kind="decode",
                                   bucket=req.bucket)
            if ((self.eos_id is not None and tok == self.eos_id)
                    or len(req.tokens) >= req.max_new
                    or int(self.pos[s]) >= self.max_len):
                self._finish(req, s)          # EOS / budget / cache full
        return worked + len(live)

    def run(self, max_steps: int = 1000) -> List[Request]:
        """Drive steps until the queue *and* the slots are both drained."""
        for _ in range(max_steps):
            if not self.queue and all(a is None for a in self.active):
                break
            self.step()
        return self.finished
