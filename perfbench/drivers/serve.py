"""Serving driver: a closed loop of clients against the port's
``BatchedServer`` on CUDA graphs, with the configuration's kernels
installed at their sites.

Set-up draws the weights from the seed, installs the kernels, builds the
server (which captures its graphs), and runs the loop until every slot has
turned over once.  The window then runs ``seconds`` of steps; a traced run
then traces the traffic's ``trace`` seconds of further steps.  A client
sends its next request as soon as its last one finishes, at the end of
that step.  A token reaches its client when the step that made it returns;
the record keeps, for every request, when it was sent and when each of its
tokens came, and for every step its span on the host clock, the prefills
it ran and the context of every row it decoded.

After the window the K/V that the cache holds for the live slots is read
to the host, the server is freed, and the reference reads the tokens of a
sample of the requests finished in the window, one from every slot and
the longest, and the live slots' K/V in the first layer
(``reference.serve``).
"""
from __future__ import annotations

import gc
import importlib
from typing import Dict, List

import numpy as np

import common
import workload
from reference import serve as ref_serve
from reference import weights as W

clock = common.clock


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


class Loop:
    """The clients, the server and the record of every request and step."""

    def __init__(self, server, requests: workload.Requests, clients: int):
        self.server = server
        self.requests = requests
        self.open: Dict[int, Dict] = {}       # program rid -> record
        self.done: List[Dict] = []
        self.steps: List[Dict] = []
        self.turned = set()                   # slots that have turned over
        self.slot_of: Dict[int, int] = {}
        self.sending = True
        self.trace = None                     # a common.Trace while taken
        for c in range(clients):
            self.send(clock(), c)

    def send(self, now: float, client: int) -> None:
        prompt, out = self.requests.next(client)
        req = self.server.submit(prompt, max_new=out)
        self.open[req.rid] = {"req": req, "prompt": prompt, "sent": now,
                              "client": client, "times": []}

    def step(self) -> None:
        server = self.server
        admits = bool(server.queue) and any(a is None for a in server.active)
        before = {rid: len(r["req"].tokens) for rid, r in self.open.items()}
        t_a = clock()
        with common.span("admit" if admits else "decode", self.trace):
            server.step()
        t_b = clock()
        groups: Dict[int, List[int]] = {}
        decode_keys = []
        for rid, r in list(self.open.items()):
            req, n0 = r["req"], before[rid]
            n1 = len(req.tokens)
            if n1 == n0:
                continue
            r["times"].extend([t_b] * (n1 - n0))
            plen = len(r["prompt"])
            if n0 == 0:                       # admitted: its prefill
                groups.setdefault(req.bucket, []).append(plen)
                decode_keys.extend([plen + 1] * (n1 - 1))
            else:
                decode_keys.append(plen + n0)
            if req.done:
                del self.open[rid]
                r["finished"] = t_b
                self.done.append(r)
                r["slot"] = self.slot_of.pop(rid, None)
                if r["slot"] is not None:
                    self.turned.add(r["slot"])
                if self.sending:
                    self.send(t_b, r["client"])
        for s, req in enumerate(server.active):
            if req is not None and req.rid not in self.slot_of:
                self.slot_of[req.rid] = s
        rec = {"t_a": t_a, "t_b": t_b, "admitted": sum(map(len,
                                                          groups.values())),
               "prefills": [[b, _next_pow2(len(v)), v]
                            for b, v in groups.items()],
               "decode_keys": decode_keys}
        self.steps.append(rec)


def _install(kernels: Dict[str, str]) -> None:
    from repro_torch.kernels import ops
    ops.clear_all()
    for site, ref in kernels.items():
        module, name = ref.split(":")
        fn = getattr(importlib.import_module(module), name)
        ops.install(site, fn, kernel=name, route="cuda")


def _sample(done: List[Dict], seed: int) -> List[Dict]:
    """Requests finished in the window: one drawn from the seed for every
    slot that served one, so that a fault in any slot shows, and the
    longest request."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 3]))
    by_slot: Dict[int, List[Dict]] = {}
    for r in done:
        if r["slot"] is not None:         # None: finished at its prefill
            by_slot.setdefault(r["slot"], []).append(r)
    out = [rs[rng.integers(len(rs))] for _, rs in sorted(by_slot.items())]
    if done:
        longest = max(done, key=lambda r: len(r["prompt"])
                      + len(r["req"].tokens))
        if all(r is not longest for r in out):
            out.append(longest)
    return out


# the cache's K/V is compared in the first layer, where the program's
# error before the cache is least (deeper, bf16's rounding carried through
# the layers sets it, whatever the cache stores)
KV_LAYERS = 1


def live_kv(server, layers: int = 0) -> List:
    """(tokens fed, {"k", "v"}) of every live slot: the K/V that its cache
    holds for them in its first ``layers`` layers (0: all), [layers,
    tokens, KV, hd], on the host in float32 (an int8 cache read through its
    scales)."""
    out = []
    for s, req in enumerate(server.active):
        if req is None:
            continue
        n = int(server.pos[s])
        ids = np.concatenate([req.prompt,
                              np.asarray(req.tokens[:-1], np.int64)])
        assert len(ids) == n, (len(ids), n)
        kv = {}
        for name in ("k", "v"):
            rows = (slice(0, layers or None), s, slice(0, n))
            t = server.cache[name][rows].cpu().float()
            if f"{name}_scale" in server.cache:
                t = t * server.cache[f"{name}_scale"][rows].cpu().float()
            kv[name] = t
        out.append((ids, kv))
    return out


def build(ctx: Dict, kv_quant: bool = False):
    """(model, server): the configuration's model with the seed's weights
    and its kernels installed, under a server that has captured its
    graphs; ``kv_quant``: the program's int8 K/V cache (the control)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import get_model
    from repro_torch.serve.decode import BatchedServer

    model_cfg, mix, dev = ctx["config"]["model"], ctx["traffic"], ctx["device"]
    t = clock()
    model = get_model(ModelConfig(**model_cfg), device=dev,
                      **({"kv_quant": True} if kv_quant else {}))
    W.fill(dict(model.named_parameters()), model_cfg, ctx["seed"])
    t_weights = clock()
    # the kernels run on the card only; on the CPU (the tests) the sites
    # keep the plain path
    _install(ctx["config"]["kernels"] if dev != "cpu" else {})
    server = BatchedServer(model, slots=mix["slots"], max_len=mix["max_len"],
                           aot=ctx["aot"], device=dev)
    print(f"set-up: weights {t_weights - t:.2f} s, server "
          f"{clock() - t_weights:.2f} s ({server.aot_compiles} graphs "
          f"captured in {server.capture_s:.2f} s)", flush=True)
    return model, server


def warm(loop: Loop, mix: Dict) -> None:
    """Steps until every slot has turned over once; forgets those steps."""
    t = clock()
    for _ in range(mix["warmup_max_steps"]):
        if len(loop.turned) >= mix["slots"]:
            break
        loop.step()
    else:
        raise RuntimeError(f"slots did not all turn over in "
                           f"{mix['warmup_max_steps']} steps")
    print(f"set-up: warm-up {len(loop.steps)} steps in {clock() - t:.2f} s",
          flush=True)
    del loop.steps[:]


def window(loop: Loop, seconds: float):
    """Runs steps for ``seconds``.  Returns (start, end) on the host
    clock."""
    t_start = clock()
    while clock() < t_start + seconds:
        loop.step()
    return t_start, loop.steps[-1]["t_b"]


def traced(loop: Loop, trace, seconds: float) -> List[Dict]:
    """Runs steps for ``seconds`` under ``trace`` (after the window, so
    that the profiler slows none of the window's steps); returns them."""
    n = len(loop.steps)
    trace.start()
    loop.trace = trace
    t0 = clock()
    while clock() < t0 + seconds:
        loop.step()
    trace.stop()
    loop.trace = None
    steps = loop.steps[n:]
    del loop.steps[n:]
    return steps


def drain(loop: Loop) -> None:
    """Sends nothing more and steps until the server is idle."""
    loop.sending = False
    while loop.open:
        loop.step()


def sample_of(loop: Loop, t_start: float, t_end: float, seed: int):
    """(requests finished in the window, (prompt, served tokens) of the
    sample the reference reads)."""
    done = [r for r in loop.done if t_start <= r["finished"] <= t_end]
    return done, [(r["prompt"], list(r["req"].tokens))
                  for r in _sample(done, seed)]


def run(ctx: Dict) -> Dict:
    import torch
    from repro_torch.kernels import ops

    model_cfg, mix, dev = ctx["config"]["model"], ctx["traffic"], ctx["device"]
    print(f"set-up: start {clock() - ctx['t0']:.2f} s", flush=True)
    model, server = build(ctx)
    loop = Loop(server, workload.Requests(mix, model_cfg["vocab_size"],
                                          ctx["seed"]), mix["clients"])
    warm(loop, mix)
    if dev != "cpu":
        torch.cuda.synchronize()
    ctx["before_window"]()
    setup_s = clock() - ctx["t0"]
    t_start, t_end = window(loop, ctx["seconds"])
    ctx["after_window"]()
    trace = common.Trace() if ctx["trace"] else None
    slice_steps = traced(loop, trace, mix["trace"]["seconds"]) if trace \
        else []
    record = {
        "kind": "serve", "model": model_cfg, "setup_s": setup_s,
        "t_start": t_start, "t_end": t_end, "window_s": t_end - t_start,
        "steps": loop.steps, "traced_steps": slice_steps,
        "requests": [{"sent": r["sent"], "times": r["times"]}
                     for r in loop.done + list(loop.open.values())],
        "trace": trace.result if trace is not None else None,
    }
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    live = live_kv(server, KV_LAYERS)
    done, seqs = sample_of(loop, t_start, t_end, ctx["seed"])
    del server, model, loop
    ops.clear_all()
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    gaps = ref_serve.served_gaps(model_cfg, ctx["seed"], seqs, dev)
    kv = ref_serve.kv_gaps(model_cfg, ctx["seed"], live, dev,
                           layers=KV_LAYERS)
    checks = [{"name": "served_gap", "value": max(gaps) if gaps else None,
               "limit": ctx["limits"]["served_gap"],
               "tokens": len(gaps), "requests": len(seqs)},
              {"name": "kv_gap", "value": kv[0]["fine"] if live else None,
               "limit": ctx["limits"]["kv_gap"], "slots": len(live),
               "tokens": sum(len(ids) for ids, _ in live),
               "rel": kv[0]["rel"] if live else None}]
    return {"record": record, "attempted": len(done), "failed": 0,
            "memory_peak_bytes": peak, "checks": checks}
