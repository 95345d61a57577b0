"""FLOP, byte and collective counter over the aten and c10d ops of one
eager call: the port's twin of ``repro.launch.hlo_cost``.

The JAX package walks the compiled HLO text, multiplying loop bodies by
their trip counts.  Eager PyTorch has no module to walk: ``analyze(fn,
*args)`` runs ``fn`` once under a ``TorchDispatchMode`` and sees every
aten op it dispatches (the backward pass included when ``fn`` calls it,
and ``torch.utils.checkpoint``'s recompute, as remat is in the HLO), so a
Python loop is counted as often as it runs.  On fake tensors
(``torch._subclasses.FakeTensorMode``) nothing is computed or allocated,
and a ``fake`` process group stands for every rank (``launch.dryrun``).
The walker's rules, per op:

  flops       matmuls (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolution):
              2·|out|·|contracted|; arithmetic elementwise ops: |result|,
              transcendentals beside; reductions: |operand|; gathers and
              scatters: |result|.  A composite op (``_softmax``,
              ``native_layer_norm``, ``silu``, their backwards, ...) is
              counted by its decomposition (``torch._decomp``), so that
              elementwise counts follow primitives as XLA's do; its upper
              bytes are its own (eager runs it as one kernel).
  hbm_bytes   operands plus result of every op that is not a view or a
              metadata op: eager runs one kernel an op, which is the port's
              fusion granularity (the upper bound)
  hbm_bytes_ideal
              the same for matmuls and collectives only (the lower bound)
              and, in both, 2 × the update of a write into a slice
              (``copy_`` into a view, ``index_put_``, ``slice_scatter``,
              scatter) and 2 × the result of a gather (``embedding``,
              ``index_select``, ``gather``)
  collectives ring-model bytes a rank sends, by the walker's kind names:
              all-gather → result, all-reduce → 2 × operand, reduce-scatter
              and all-to-all → operand; over the c10d ops a process group
              dispatches and the ``_c10d_functional`` ones a DTensor
              redistribution uses

Everything is per rank: the process runs one rank's program.  Real dtypes
are kept (bf16 is 2 bytes, f32 moments 4), so the JAX package's
``f32_bytes`` correction of XLA:CPU's bf16 legalization and
``xla_cost_analysis`` have no counterpart.  ``LiveBytes`` stands for
``memory_analysis()``: it follows every storage an op creates (a finalizer
per storage) and gives argument, output and temp bytes and the peak.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_ARITH = {
    "add", "sub", "rsub", "mul", "div", "pow", "maximum", "minimum", "tanh",
    "exp", "exp2", "log", "log2", "rsqrt", "sqrt", "neg", "abs", "sign",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "logical_and", "logical_or",
    "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "atan2", "floor", "ceil", "round",
    "trunc", "clamp", "clamp_min", "clamp_max", "remainder", "fmod", "cos",
    "sin", "sigmoid", "expm1", "log1p", "erf", "reciprocal", "masked_fill",
    "square", "floor_divide", "__and__", "__or__", "__xor__", "__invert__",
}
_TRANSCENDENTAL = {"tanh", "exp", "exp2", "log", "log2", "sigmoid", "pow",
                   "cos", "sin", "expm1", "log1p", "erf"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
           "prod", "any", "all", "cumsum", "cumprod", "linalg_vector_norm",
           "norm"}
_GATHER = {"embedding", "index_select", "gather", "index", "_unsafe_index"}
_SCATTER = {"index_put", "index_copy", "index_add", "scatter", "scatter_add",
            "scatter_reduce", "slice_scatter", "select_scatter",
            "diagonal_scatter", "copy"}
_MOVE = {"clone", "_to_copy", "cat", "stack", "contiguous", "flip", "roll",
         "repeat", "constant_pad_nd", "tril", "triu", "fill", "zero",
         "zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
         "new_zeros", "new_ones", "new_full", "arange", "scalar_tensor",
         "lift_fresh_copy", "randn", "rand", "normal", "uniform",
         "bernoulli", "topk", "sort"}
# allocation without a fill: no traffic, but storage to follow
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided"}
# no traffic and no storage of their own: metadata and aliasing
_FREE = {"_unsafe_view", "_local_scalar_dense", "device",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "is_same_size", "set", "resize", "_has_compatible_shallow_copy_type",
         "lift_fresh", "wait_tensor", "record_stream", "_nested_tensor_size",
         "promote_types"}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "convolution",
           "convolution_backward"}
# (kind, operand arg, result arg) of each collective: the walker's names
_COLLECTIVES = {
    "_allgather_base_": ("all-gather", 1, 0),
    "allreduce_": ("all-reduce", 0, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "alltoall_base_": ("all-to-all", 1, 0),
    "all_gather_into_tensor": ("all-gather", 0, None),
    "all_reduce": ("all-reduce", 0, None),
    "reduce_scatter_tensor": ("reduce-scatter", 0, None),
    "all_to_all_single": ("all-to-all", 0, None),
}
_COUNTED = _MATMUL | _ARITH | _REDUCE | _GATHER | _SCATTER | _MOVE
_DECOMPOSITIONS = None


def _decompositions():
    global _DECOMPOSITIONS
    if _DECOMPOSITIONS is None:
        from torch._decomp import decomposition_table
        _DECOMPOSITIONS = decomposition_table
    return _DECOMPOSITIONS


@dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0        # upper bound: one kernel an op
    hbm_bytes_ideal: float = 0.0  # lower bound: perfect elementwise fusion
    transcendentals: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    coll_count: Dict[str, float] = field(default_factory=dict)

    def __add__(self, o: "Cost") -> "Cost":
        cb = dict(self.coll_bytes)
        cc = dict(self.coll_count)
        for k, v in o.coll_bytes.items():
            cb[k] = cb.get(k, 0.0) + v
        for k, v in o.coll_count.items():
            cc[k] = cc.get(k, 0.0) + v
        return Cost(self.flops + o.flops, self.hbm_bytes + o.hbm_bytes,
                    self.hbm_bytes_ideal + o.hbm_bytes_ideal,
                    self.transcendentals + o.transcendentals, cb, cc)

    def __mul__(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.hbm_bytes * k,
                    self.hbm_bytes_ideal * k,
                    self.transcendentals * k,
                    {n: v * k for n, v in self.coll_bytes.items()},
                    {n: v * k for n, v in self.coll_count.items()})

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll_bytes.values())


def tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    """The tensors of an op's arguments or result: a tensor, or tensors in
    (nested) tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        out = []
        for x in tree:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (tuple, list, dict)):
                out.extend(_tensors(x))
        return out
    if isinstance(tree, dict):
        return _tensors(list(tree.values()))
    return []


def _signature(func, args, kwargs):
    """What a composite op's cost depends on: the op, its tensors' shapes
    and dtypes, its other arguments."""
    def sig(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), x.dtype)
        if isinstance(x, (list, tuple)):
            return tuple(sig(y) for y in x)
        return x
    return func, sig(args), tuple(sorted((k, sig(v))
                                         for k, v in kwargs.items()))


_KINDS: Dict[object, Tuple[str, str]] = {}


def _classify(func) -> Tuple[str, str]:
    """(how the counter treats ``func``, its op name without the overload
    and an in-place ``_``): "collective", "free" (views, metadata, ops
    outside aten and c10d), "alloc" (an allocation without a fill), "counted"
    (a rule of the module's), "decompose" or "uncounted"."""
    kind = _KINDS.get(func)
    if kind is not None:
        return kind
    ns, _, rest = func.name().partition("::")
    name = rest.split(".")[0]
    if ns == "aten" and name.endswith("_") and not name.endswith("__"):
        name = name[:-1]
    if ns in ("c10d", "_c10d_functional") and name in _COLLECTIVES:
        kind = "collective"
    elif ns != "aten" or func.is_view or name in _FREE:
        kind = "free"
    elif name in _ALLOC:
        kind = "alloc"
    elif name in _COUNTED:
        kind = "counted"
    elif func in _decompositions():
        kind = "decompose"
    else:
        kind = "uncounted"
    _KINDS[func] = (kind, name)
    return kind, name


@dataclass
class Memory:
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    peak_bytes: int = 0


class LiveBytes:
    """Live bytes of the storages a run creates, with their peak: every
    storage an op returns that is not an argument's is counted from its
    first sight until it is freed (a finalizer on the storage)."""

    def __init__(self, arguments=()):
        self._args = {}
        for t in _tensors(arguments):
            s = _storage(t)
            if s is not None:
                self._args[s._cdata] = s.nbytes()
        self._live: Dict[int, int] = {}
        self.live = 0
        self.peak = 0

    @property
    def argument_bytes(self) -> int:
        return sum(self._args.values())

    def saw(self, out) -> None:
        for t in _tensors(out):
            s = _storage(t)
            if s is None:
                continue
            key = s._cdata
            if key in self._live or key in self._args:
                continue
            n = s.nbytes()
            self._live[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._freed, key)

    def _freed(self, key) -> None:
        self.live -= self._live.pop(key, 0)

    def memory(self, outputs) -> Memory:
        """The run's memory, ``outputs`` being what it returned: peak =
        arguments + the most bytes its own storages held at once, of which
        outputs are those still held by ``outputs``."""
        seen, out = set(), 0
        for t in _tensors(outputs):
            s = _storage(t)
            if s is not None and s._cdata in self._live \
                    and s._cdata not in seen:
                seen.add(s._cdata)
                out += self._live[s._cdata]
        return Memory(argument_bytes=self.argument_bytes, output_bytes=out,
                      temp_bytes=self.peak - out,
                      peak_bytes=self.argument_bytes + self.peak)


def _storage(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t._local_tensor
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


class Counter(TorchDispatchMode):
    """Counts the ops dispatched under it into ``cost`` (see the module's
    rules); with a ``LiveBytes`` it also follows the storages they create.
    Ops with no rule and no decomposition are run, their bytes counted,
    and their names kept in ``uncounted``."""

    def __init__(self, live: Optional[LiveBytes] = None):
        super().__init__()
        self.cost = Cost()
        self.live = live
        self.uncounted: Dict[str, int] = {}
        # a composite op's decomposition's cost by its call's signature
        self._composites: Dict[tuple, Cost] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind, name = _classify(func)
        if kind == "free":
            return func(*args, **kwargs)
        if kind == "decompose":
            out = self._composite(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        if kind == "collective":
            self._collective(name, args, out)
        elif kind == "counted":
            self._op(name, args, kwargs, out)
        elif kind == "uncounted":
            self.uncounted[str(func)] = self.uncounted.get(str(func), 0) + 1
            self._bytes(args, kwargs, out)
        if self.live is not None:
            self.live.saw(out)
        return out

    # ------------------------------------------------------------------
    def _composite(self, func, args, kwargs):
        """A composite op: its flops, transcendentals, ideal and collective
        bytes are its decomposition's (counted by a counter of its own the
        first time a signature is seen), its upper bytes its own operands
        and result (eager runs it as one kernel).  A mutating op runs its
        decomposition every time, any other the op itself once counted."""
        key = _signature(func, args, kwargs)
        cost = self._composites.get(key)
        if cost is None or func._schema.is_mutable:
            inner = Counter()
            with inner:
                out = _decompositions()[func](*args, **kwargs)
            for op, n in inner.uncounted.items():
                self.uncounted[op] = self.uncounted.get(op, 0) + n
            cost = self._composites[key] = inner.cost
        else:
            out = func(*args, **kwargs)
        c = self.cost
        c.flops += cost.flops
        c.transcendentals += cost.transcendentals
        c.hbm_bytes_ideal += cost.hbm_bytes_ideal
        for k, v in cost.coll_bytes.items():
            c.coll_bytes[k] = c.coll_bytes.get(k, 0.0) + v
            c.coll_count[k] = c.coll_count.get(k, 0.0) + cost.coll_count[k]
        self._bytes(args, kwargs, out)
        return out

    def _bytes(self, args, kwargs, out, ideal: bool = False) -> None:
        io = sum(tensor_bytes(t) for t in _tensors((args, kwargs))) + sum(
            tensor_bytes(t) for t in _tensors(out))
        self.cost.hbm_bytes += io
        if ideal:
            self.cost.hbm_bytes_ideal += io

    def _op(self, name, args, kwargs, out) -> None:
        c = self.cost
        result = _tensors(out)
        n_out = sum(t.numel() for t in result)
        if name in _MATMUL:
            c.flops += _matmul_flops(name, args, result)
            self._bytes(args, kwargs, out, ideal=True)
            return
        if name in _ARITH:
            c.flops += n_out
            if name in _TRANSCENDENTAL:
                c.transcendentals += n_out
        elif name in _REDUCE:
            c.flops += max((t.numel() for t in _tensors(args[:1])),
                           default=0)
        elif name in _GATHER or name in _SCATTER:
            c.flops += n_out if name != "copy" else 0
            if name in _GATHER:
                b = 2 * sum(tensor_bytes(t) for t in result)
            else:               # the update, not the buffer it lands in
                ob = [tensor_bytes(t) for t in _tensors((args, kwargs))]
                b = 2 * (sum(ob) - max(ob, default=0))
            c.hbm_bytes += b
            c.hbm_bytes_ideal += b
            return
        self._bytes(args, kwargs, out)

    def _collective(self, name, args, out) -> None:
        kind, operand, result = _COLLECTIVES[name]
        ob = sum(tensor_bytes(t) for t in _tensors(args[operand]))
        rb = sum(tensor_bytes(t) for t in _tensors(
            args[result] if result is not None else out))
        b = {"all-gather": rb, "all-reduce": 2 * ob}.get(kind, ob)
        c = self.cost
        c.coll_bytes[kind] = c.coll_bytes.get(kind, 0.0) + b
        c.coll_count[kind] = c.coll_count.get(kind, 0.0) + 1
        c.hbm_bytes += rb + ob
        c.hbm_bytes_ideal += rb + ob


def _matmul_flops(name, args, result) -> float:
    if name in ("mm", "addmm", "bmm", "baddbmm"):
        a = args[1] if name in ("addmm", "baddbmm") else args[0]
        out = result[0]
        flops = 2.0 * out.numel() * a.shape[-1]
        return flops + (out.numel() if name in ("addmm", "baddbmm") else 0)
    # convolution: (C_in / groups) · kernel products per output element;
    # its backward repeats them for each gradient it computes
    w = args[1] if name == "convolution" else args[2]
    flops = 2.0 * (result[0].numel() if name == "convolution"
                   else args[0].numel()) * (w.numel() // w.shape[0])
    return flops if name == "convolution" else flops * sum(args[10][:2])


def analyze(fn, *args, **kw) -> Cost:
    """The cost of one call ``fn(*args, **kw)`` (run once, eagerly)."""
    with Counter() as counter:
        fn(*args, **kw)
    return counter.cost
