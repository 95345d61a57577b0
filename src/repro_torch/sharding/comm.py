"""The collectives of the port's distributed layer, in one helper.

Ranks are ``torch.distributed`` processes; every collective the models,
the train step, ``compressed_psum`` and the checkpoints make goes through
``all_reduce``, ``all_gather`` or ``reduce_scatter`` here, on a process
group of a ``ShardCtx``'s mesh.  A group of one rank makes no call.

The transport is chosen once per (backend, device type) by ``transport``
and printed by the card's smoke run; it is never changed after a failure.
Every backend the port runs takes the tensors where they lie
(``"direct"``): NCCL on CUDA, gloo on the CPU and on CUDA tensors too.
gloo carries ``all_gather_into_tensor``, ``all_reduce`` (sum, max; f32,
bf16, int32) and ``reduce_scatter_tensor`` on CUDA tensors on the H100
host, where two ranks that share the one card must use it (NCCL refuses
two ranks on one device), so nothing is staged through host memory.  The
``fake`` backend (``torch.testing._internal.distributed.fake_pg``: one
process standing for every rank, as the dry run uses it) issues no
transfer, so it is direct as well.

Under autograd the models use the differentiable forms: ``gather_grad``
(an all-gather whose backward reduce-scatters the ranks' gradients),
``all_reduce_grad`` (a sum whose backward sums the ranks' gradients),
and the pair ``sum_grads`` / ``reduce_partials`` around a region whose
partial results the ranks sum (identity forward with summed gradients,
summed forward with the gradient passed on), as tensor-parallel code
brackets its region.  Each makes the same collective as its plain form,
and the plain form when autograd does not record the tensor.  Under
sequence parallelism the region's brackets are ``gather_grad`` on the way
in and ``scatter_partials`` (a reduce-scatter whose backward all-gathers)
on the way out; ``gather_replicated`` (an all-gather whose backward keeps
the rank's piece) joins a sequence that every rank then uses alike, and
``own_piece`` (a cut whose backward all-gathers) hands the rank its piece
of a result every rank computed alike.
"""
from __future__ import annotations

import warnings
from typing import Dict

import torch
import torch.distributed as dist

# collectives made, by kind (a group of one rank makes none), and their
# bytes: each one's whole tensor (an all-reduce's, an all-gather's output,
# a reduce-scatter's input)
calls: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                         "reduce_scatter": 0}
volume: Dict[str, int] = dict.fromkeys(calls, 0)


def _count(kind: str, x: torch.Tensor, factor: int = 1) -> None:
    calls[kind] += 1
    volume[kind] += x.numel() * x.element_size() * factor


def transport(device_type: str, group=None) -> str:
    """The transport for tensors on ``device_type`` over ``group``'s
    backend: a function of the two alone."""
    backend = str(dist.get_backend(group))
    if backend not in ("gloo", "nccl", "fake") or (
            backend == "nccl" and device_type != "cuda"):
        raise ValueError(f"no transport for {device_type} tensors over "
                         f"the {backend} backend")
    return "direct"


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _run(x: torch.Tensor, group, fn) -> torch.Tensor:
    """``fn`` (a collective on a contiguous tensor, returning its result)
    over the transport of ``x``'s device."""
    transport(x.device.type, group)
    return fn(x.contiguous())


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The ``op`` ("sum" or "max") of ``x`` over ``group``'s ranks, as a
    new tensor."""
    if _size(group) == 1:
        return x.clone()
    _count("all_reduce", x)

    def run(t):
        t = t.clone() if t is x else t
        dist.all_reduce(t, op=_OPS[op], group=group)
        return t
    return _run(x, group, run)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` joined along ``dim`` in group-rank order."""
    n = _size(group)
    if n == 1:
        return x
    _count("all_gather", x, n)
    xt = x.movedim(dim, 0)

    def run(t):
        out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        return out
    return _run(xt.contiguous(), group, run).movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's piece (its group rank's of ``n`` equal pieces along
    ``dim``) of the sum of the ranks' ``x``."""
    n = _size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    _count("reduce_scatter", x)
    xt = x.movedim(dim, 0)

    def run(t):
        out = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, t, group=group)
        return out
    return _run(xt.contiguous(), group, run).movedim(0, dim)


def _records(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, group, dim):
        fctx.group, fctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(fctx, g):
        return reduce_scatter(g, fctx.group, fctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, group, dim):
        fctx.group, fctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(fctx, g):
        return all_gather(g, fctx.group, fctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, group, dim):
        fctx.group, fctx.dim, fctx.n = group, dim, x.shape[dim]
        fctx.lo = dist.get_rank(group) * x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(fctx, g):
        return g.narrow(fctx.dim, fctx.lo, fctx.n), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, group, forward_sums, backward_sums):
        fctx.group, fctx.backward_sums = group, backward_sums
        return all_reduce(x, group) if forward_sums else x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return (all_reduce(g, fctx.group) if fctx.backward_sums else g,
                None, None, None)


def gather_grad(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``all_gather`` whose backward hands each rank its piece of the sum
    of the ranks' gradients (a reduce-scatter): the ranks' ``x`` are
    pieces of one tensor and each rank's gradient of the whole is its own
    loss's."""
    if _size(group) == 1 or not _records(x):
        return all_gather(x, group, dim)
    return _Gather.apply(x, group, dim)


def all_reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' ``x``, whose backward is the sum of the ranks'
    gradients: every rank uses the sum in its own loss, and the gradient
    of the sum of those losses reaches each rank's ``x`` whole."""
    if _size(group) == 1 or not _records(x):
        return all_reduce(x, group)
    return _Sum.apply(x, group, True, True)


def sum_grads(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is, whose backward sums the ranks' gradients: the entry
    of a region where each rank computes a partial result from the same
    ``x`` (the ranks' gradients of ``x`` are partial too)."""
    if _size(group) == 1 or not _records(x):
        return x
    return _Sum.apply(x, group, False, True)


def reduce_partials(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partial ``x``, whose backward passes the
    gradient on: the exit of such a region when every rank goes on with
    the same sum (its gradient is every rank's whole)."""
    if _size(group) == 1 or not _records(x):
        return all_reduce(x, group)
    return _Sum.apply(x, group, True, False)


def scatter_partials(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``reduce_scatter`` of the ranks' partial ``x``, whose backward
    all-gathers the pieces' gradients: the exit of a tensor-parallel
    region under sequence parallelism, each rank going on with its piece
    of the sum (the gradient of a partial is the whole sum's)."""
    if _size(group) == 1 or not _records(x):
        return reduce_scatter(x, group, dim)
    return _Scatter.apply(x, group, dim)


class _OwnPiece(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, group, dim):
        fctx.group, fctx.dim = group, dim
        n = x.shape[dim] // _size(group)
        return x.narrow(dim, dist.get_rank(group) * n, n)

    @staticmethod
    def backward(fctx, g):
        return all_gather(g, fctx.group, fctx.dim), None, None


def own_piece(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's piece (of ``n`` equal pieces along ``dim``) of ``x``,
    which every rank of ``group`` holds alike, with no collective; its
    backward all-gathers the pieces' gradients, so every rank goes on
    with the whole gradient of ``x`` (the adjoint of
    ``gather_replicated``)."""
    n = _size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    if not _records(x):
        m = x.shape[dim] // n
        return x.narrow(dim, dist.get_rank(group) * m, m)
    return _OwnPiece.apply(x, group, dim)


def gather_replicated(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``all_gather`` whose backward keeps this rank's piece of the
    gradient: every rank goes on with the same whole tensor, and the
    gradient each computes of it is the whole one."""
    if _size(group) == 1 or not _records(x):
        return all_gather(x, group, dim)
    return _GatherReplicated.apply(x, group, dim)
