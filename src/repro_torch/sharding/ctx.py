"""Sharding context: logical-axis → mesh-axis rules with divisibility fallback.

Port of ``repro.sharding.ctx``.  Models annotate every parameter and cache
entry with *logical* axes (``('d_model', 'heads')`` for ``wq`` etc.); a
``RuleSet`` maps logical axes to mesh axes (2D FSDP×TP by default), and any
dimension that does not divide by its mesh-axis extent falls back along
``_fit_axis``'s chain, down to replication, so that odd head counts
(hymba's 25) or expert counts (qwen2's 60) never break a layout.  ``spec``
returns the same tuple of mesh-axis entries as the JAX ``PartitionSpec``
(trailing ``None`` dropped); ``placements`` turns those entries into
DTensor placements in mesh-dim order.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims (``launch.mesh``); for layouts alone (no process group) any object
whose ``shape`` maps axis names to sizes will do, as the JAX package's
dry run uses a mesh of fake devices.

How the port runs sharded.  Ranks execute the model on plain local
tensors, as the JAX package's ``shard_map`` bodies do: the batch is split
over the data axes (``batch_axes``), the sequence over the model axis
under the ``cp`` preset, the decode cache's sequence under ``tp_seq`` /
``dp_seq``, and, under ``tensor_parallel`` (``default``, ``ep``), the
dims the rules put on the model axis (heads, ffn, experts, vocab: each
rank computes with its ``fsdp_spec`` piece of every weight of a part
that splits, Megatron's layers, ``models.layers.TensorParallel``, and
``models.lm.split_parts``); every other computation is
replicated over the axes that do not split its data.  GSPMD's implicit
layout changes have no counterpart: ``constrain`` and ``gather_fsdp``
redistribute a ``DTensor`` (the weights at rest and the checkpoints'
sharded state) and leave a plain tensor, whose layout the branch that
made it fixes, as it is.  Both are no-ops under ``ShardCtx.null()``.  A
weight at rest is computed with whole (``full``), or with its piece of
the layout with its FSDP axes gathered under tensor parallelism;
``gathered`` gathers it in one pass, under autograd with a backward that
lands its gradient in the weight's layout (``Layout.land``), the FSDP
step's gather and reduce-scatter.  Every collective goes through
``sharding.comm``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.sharding import comm

Axis = Union[None, str, Tuple[str, ...]]

# Logical axis vocabulary used by the models.
#   batch / seq         activations
#   d_model             residual width (FSDP axis for weights)
#   heads / kv_heads    attention heads
#   ffn / expert_ffn    MLP hidden
#   vocab               embedding rows / logit cols
#   experts             MoE expert dim
#   layer               stacked layer dim (never sharded)
#   state / conv / misc never sharded

RuleSet = Dict[str, Axis]

DEFAULT_RULES: RuleSet = {
    "batch": "__dp__",        # resolved to the ctx's data axes (incl. 'pod')
    "seq": "__tp__",          # sequence parallelism on the model axis
    "kv_seq": None,           # decode KV-cache seq dim; long_500k maps it to dp
    "d_model": "data",        # FSDP
    "heads": "model",         # TP
    "kv_heads": "model",
    "ffn": "model",
    "expert_ffn": "model",
    "vocab": "model",
    "experts": None,
    "layer": None,
    "state": None,
    "conv": None,
    "head_dim": None,
    "frames": None,
    "misc": None,
}

# Expert-parallel variant (dbrx: 16 experts == tp 16).
EP_RULES: RuleSet = dict(DEFAULT_RULES, experts="model", expert_ffn=None)

# Pure FSDP: both mesh axes act as data axes; weights shard over the
# flattened device set and are gathered per layer.  The ShardCtx using this
# preset must set dp to all mesh axes.
FSDP_RULES: RuleSet = dict(
    DEFAULT_RULES,
    batch="__dp__", seq=None, d_model="__dp__",
    heads=None, kv_heads=None, ffn=None, expert_ffn=None, vocab=None,
)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name → size of a ``DeviceMesh`` or of a shape-only mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _names(axis: Axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclass(frozen=True)
class ShardCtx:
    mesh: Optional[object] = None
    dp: Tuple[str, ...] = ("data",)   # data axes, outermost first
    tp: str = "model"
    rules: RuleSet = field(default_factory=lambda: dict(DEFAULT_RULES))
    seq_shard: bool = True            # activation sequence parallelism
    # KV-cache layout at decode: 'local' (seq replicated), 'tp_seq' (seq
    # over the model axis), 'dp_seq' (seq over the data axes)
    decode_kv: str = "local"
    # parallel attention: 'tp' (heads on the model axis) or 'cp' (context
    # parallel: q sequence-sharded on the model axis, K/V all-gathered)
    attn_impl: str = "tp"
    # MoE expert compute: 'einsum' or 'shard_map' (combine-before-reduce:
    # the tp partial sums are reduced as [B,S,d], after the per-token
    # gather, instead of as [B,E,C,d])
    moe_impl: str = "einsum"
    # axes gather_fsdp strips from weights at compute time; None → dp ∪
    # {'data'}
    fsdp_axes: Optional[Tuple[str, ...]] = None
    log_fallbacks: bool = False

    # ------------------------------------------------------------------
    @staticmethod
    def null() -> "ShardCtx":
        return ShardCtx(mesh=None)

    @property
    def enabled(self) -> bool:
        return self.mesh is not None

    def replace(self, **kw) -> "ShardCtx":
        return dataclasses.replace(self, **kw)

    def axis_size(self, axis: Axis) -> int:
        if axis is None or self.mesh is None:
            return 1
        shape = mesh_shape(self.mesh)
        n = 1
        for a in _names(axis):
            n *= shape[a]
        return n

    # ------------------------------------------------------------------
    def _resolve(self, logical: Optional[str]) -> Axis:
        if logical is None:
            return None
        axis = self.rules.get(logical, None)
        if axis == "__dp__":
            return self.dp
        if axis == "__tp__":
            return self.tp if self.seq_shard else None
        return axis

    def _fit_axis(self, axis: Axis, dim: int) -> Axis:
        """Divisibility fallback chain: full tuple → prefixes → each single
        axis → replicated."""
        if axis is None:
            return None
        names = _names(axis)
        candidates = [names[:k] for k in range(len(names), 0, -1)]
        candidates += [(n,) for n in names[1:]]
        for cand in candidates:
            if dim % self.axis_size(cand) == 0:
                return cand[0] if len(cand) == 1 else cand
        return None

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Tuple[Axis, ...]:
        """Mesh-axis entries for the given logical axes (the JAX
        ``PartitionSpec``'s); enforces divisibility when ``shape`` is known
        and drops duplicate mesh axes first come, first served."""
        entries = []
        used = set()
        for i, name in enumerate(logical_axes):
            axis = self._resolve(name)
            if axis is not None and shape is not None:
                axis = self._fit_axis(axis, shape[i])
            if axis is not None:
                if any(n in used for n in _names(axis)):
                    axis = None
                else:
                    used.update(_names(axis))
            entries.append(axis)
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    def placements(self, entries: Sequence[Axis]):
        """DTensor placements of spec ``entries``, in mesh-dim order: a
        mesh dim named in entry i is ``Shard(i)`` (a dim over ``('pod',
        'data')`` is ``Shard(i)`` on both), any other ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        where = {a: i for i, e in enumerate(entries) for a in _names(e)}
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in mesh_shape(self.mesh))

    def sharding(self, logical_axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None) -> Optional["Layout"]:
        if self.mesh is None:
            return None
        return Layout(self, self.spec(logical_axes, shape))

    def constrain(self, x, *logical_axes: Optional[str]):
        """Redistributes a DTensor to the layout of ``logical_axes``; a
        plain tensor, and anything under a null ctx, is returned as is."""
        if self.mesh is None or not _is_dtensor(x):
            return x
        return Layout(self, self.spec(logical_axes, x.shape)).redistribute(x)

    # ------------------------------------------------------------------
    def _drop_fsdp(self, axis: Axis) -> Axis:
        """Remove FSDP (rest-sharding) axes from a resolved mesh axis."""
        if axis is None:
            return None
        drop = (set(self.fsdp_axes) if self.fsdp_axes is not None
                else set(self.dp) | {"data"})
        kept = tuple(n for n in _names(axis) if n not in drop)
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else kept

    def fsdp_spec(self, logical_axes: Sequence[Optional[str]],
                  shape: Sequence[int]) -> Tuple[Axis, ...]:
        """The entries of a weight's layout at compute time: its axes with
        the FSDP axes dropped, each fitted to its dim (the divisibility
        fallback), as the JAX ``gather_fsdp`` constrains it, and a mesh
        axis an earlier dim took dropped from a later one, first come,
        first served, as ``spec`` does (the JAX ``gather_fsdp`` lacks that
        rule and raises ``DuplicateSpecError`` where two dims fit one
        axis, hymba's ``mamba_w_dt`` on 2 model ranks: ROADMAP.md queue
        3)."""
        entries = []
        used = set()
        for i, name in enumerate(logical_axes):
            axis = self._fit_axis(self._drop_fsdp(self._resolve(name)),
                                  shape[i])
            if axis is not None:
                if any(n in used for n in _names(axis)):
                    axis = None
                else:
                    used.update(_names(axis))
            entries.append(axis)
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    def gather_fsdp(self, w, logical_axes: Sequence[Optional[str]]):
        """Explicit FSDP weight gather: a DTensor weight is redistributed to
        its layout with the FSDP axes dropped (``fsdp_spec``: an all-gather
        over them); a plain weight is returned as is."""
        if self.mesh is None or not _is_dtensor(w):
            return w
        return Layout(self, self.fsdp_spec(logical_axes, w.shape)
                      ).redistribute(w)

    @property
    def tensor_parallel(self) -> bool:
        """Whether the model axis splits the layers' work (Megatron tensor
        parallelism, GSPMD's reading of the rules that put heads, ffn and
        vocab on it): an enabled ctx whose attention is ``tp`` and whose
        model axis is no data axis (``default``, ``ep``; never ``fsdp`` or
        ``cp``).  A model at rest then computes with each weight's
        ``fsdp_spec`` piece."""
        return (self.enabled and self.attn_impl == "tp"
                and self.tp not in self.dp)

    def gather_params(self, params, axes_tree):
        """gather_fsdp over a whole (sub)tree of weights."""
        if self.mesh is None:
            return params
        return map_axes(lambda ax, w: self.gather_fsdp(w, ax),
                        axes_tree, params)

    # ------------------------------------------------------------------
    def tree_shardings(self, axes_tree, shape_tree):
        """``Layout``s for a whole tree: ``axes_tree`` mirrors
        ``shape_tree`` (tensors, or shapes as tuples of ints) with tuples
        of logical axis names as leaves."""
        return map_axes(lambda ax, leaf: self.sharding(ax, _shape(leaf)),
                        axes_tree, shape_tree)

    # ---- rank-local execution ----------------------------------------
    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The mesh axes that split a step's tokens: the data axes, and the
        model axis under context parallelism (the sequence)."""
        if self.attn_impl == "cp" and self.tp not in self.dp:
            return tuple(self.dp) + (self.tp,)
        return tuple(self.dp)

    def group(self, axes: Axis):
        """This rank's process group over the mesh ``axes`` (None for one
        rank).  Made on first use, by every rank at once (the ranks run one
        program), for every coset of those axes."""
        names = _names(axes)
        if self.axis_size(names) == 1:
            return None
        mesh = self.mesh
        order = list(mesh.mesh_dim_names)
        if [order.index(a) for a in names] != sorted(order.index(a)
                                                     for a in names):
            raise ValueError(f"axes {names} are not in the mesh's order "
                             f"{tuple(order)}")
        import torch.distributed as dist
        groups = mesh.__dict__.setdefault("_groups_by_axes", {})
        if names not in groups or not _alive(groups[names]):
            # a mesh can outlive its process group: DTensor's sharding
            # cache hands back an equal mesh of an earlier group (the dry
            # run makes one group a cell); its groups are then made anew
            if len(names) == 1 and _alive(mesh.get_group(names[0])):
                groups[names] = mesh.get_group(names[0])
            else:
                # read outside every dispatch mode: under the dry run's
                # FakeTensorMode the rank tensor would turn fake and
                # unreadable, and its counter would count the read
                from torch.utils._python_dispatch import \
                    _disable_current_modes
                with _disable_current_modes():
                    ranks = mesh.mesh.numpy()
                ranks = np.moveaxis(
                    ranks, [order.index(a) for a in names],
                    list(range(len(order) - len(names), len(order))))
                cosets = ranks.reshape(-1, self.axis_size(names)).tolist()
                groups[names], _ = dist.new_subgroups_by_enumeration(cosets)
        return groups[names]

    def index(self, axes: Axis) -> int:
        """This rank's coordinate along the flattened mesh ``axes``
        (outermost first, as a JAX axis tuple flattens)."""
        idx = 0
        for a in _names(axes):
            idx = idx * self.axis_size(a) + self.mesh.get_local_rank(a)
        return idx


def _alive(group) -> bool:
    """Whether ``group`` belongs to the current default process group."""
    import torch.distributed as dist
    try:
        dist.get_backend(group)
    except ValueError:
        return False
    return True


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _shape(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    if isinstance(leaf, tuple) and len(leaf) == 2 and isinstance(leaf[0],
                                                                 tuple):
        return leaf[0]                  # (shape, dtype) of cache_shapes
    return tuple(leaf)


@dataclass(frozen=True)
class Layout:
    """A tensor's layout on a ctx's mesh: spec entries per tensor dim (the
    port's ``NamedSharding``).  ``shard`` cuts this rank's piece out of a
    whole tensor, ``gather`` joins the ranks' pieces, ``dtensor`` wraps a
    piece as a DTensor."""
    ctx: ShardCtx
    spec: Tuple[Axis, ...]

    @property
    def placements(self):
        return self.ctx.placements(self.spec)

    def sharded_dims(self):
        return [(i, e) for i, e in enumerate(self.spec) if e is not None]

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = list(shape)
        for i, e in self.sharded_dims():
            out[i] //= self.ctx.axis_size(e)
        return tuple(out)

    def bounds(self, shape: Sequence[int]):
        """[lo, hi) of this rank's piece along each dim of ``shape``."""
        out = [(0, n) for n in shape]
        for i, e in self.sharded_dims():
            n = shape[i] // self.ctx.axis_size(e)
            lo = self.ctx.index(e) * n
            out[i] = (lo, lo + n)
        return out

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole tensor ``t`` (a view)."""
        for i, (lo, hi) in enumerate(self.bounds(t.shape)):
            if hi - lo != t.shape[i]:
                t = t.narrow(i, lo, hi - lo)
        return t

    def _kept(self, kept: Optional["Layout"]):
        """The sharded dims of this layout that ``kept`` (a layout each of
        whose entries is this one's or None) leaves split."""
        if kept is None:
            return set()
        spec = kept.spec + (None,) * (len(self.spec) - len(kept.spec))
        out = set()
        for i, e in enumerate(spec):
            if e is None:
                continue
            if i >= len(self.spec) or self.spec[i] != e:
                raise ValueError(f"layout {kept.spec} is not {self.spec} "
                                 "with some dims gathered")
            out.add(i)
        return out

    def gather(self, piece: torch.Tensor,
               kept: Optional["Layout"] = None) -> torch.Tensor:
        """The whole tensor from every rank's ``piece``; with ``kept``,
        this rank's piece of the ``kept`` layout (the dims it leaves split
        are not gathered)."""
        skip = self._kept(kept)
        for i, e in self.sharded_dims():
            if i not in skip:
                piece = comm.all_gather(piece, self.ctx.group(e), i)
        return piece

    def land(self, partial: torch.Tensor, summed: Sequence[str],
             kept: Optional["Layout"] = None) -> torch.Tensor:
        """This rank's piece of the sum over the mesh axes ``summed`` of the
        ranks' whole-size ``partial`` (equal across every other axis): a
        reduce-scatter over each sharded dim's axes that are summed, a cut
        for the others, and an all-reduce over the summed axes no dim takes
        (a gradient landing in its parameter's layout).  With ``kept``,
        ``partial`` is the ranks' piece of that layout, and the dims it
        leaves split are this rank's already."""
        left = [a for a in summed]
        skip = self._kept(kept)
        for i, e in self.sharded_dims():
            if i in skip:
                continue
            names = _names(e)
            if all(a in left for a in names):
                partial = comm.reduce_scatter(partial, self.ctx.group(e), i)
                left = [a for a in left if a not in names]
            elif not any(a in left for a in names):
                n = partial.shape[i] // self.ctx.axis_size(e)
                partial = partial.narrow(i, self.ctx.index(e) * n, n)
            else:
                raise ValueError(f"dim {i} over {names} is summed over only "
                                 f"part of its axes ({tuple(summed)})")
        mesh_order = list(mesh_shape(self.ctx.mesh))
        left = tuple(sorted(left, key=mesh_order.index))
        if left:
            partial = comm.all_reduce(partial, self.ctx.group(left))
        return partial

    def replicas(self) -> int:
        """How many ranks hold each piece."""
        split = {n for _, e in self.sharded_dims() for n in _names(e)}
        return self.ctx.axis_size(tuple(a for a in mesh_shape(self.ctx.mesh)
                                        if a not in split))

    def dtensor(self, piece: torch.Tensor):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(piece, self.ctx.mesh, self.placements,
                                  run_check=False)

    @staticmethod
    def of(dt) -> "Layout":
        """The layout a DTensor's placements describe."""
        from torch.distributed.tensor import Shard
        names = list(dt.device_mesh.mesh_dim_names)
        entries = [()] * dt.dim()
        for name, pl in zip(names, dt.placements):
            if isinstance(pl, Shard):
                entries[pl.dim] = entries[pl.dim] + (name,)
        spec = tuple(None if not e else e[0] if len(e) == 1 else e
                     for e in entries)
        return Layout(ShardCtx(mesh=dt.device_mesh), spec)

    def redistribute(self, dt):
        """A DTensor in this layout with ``dt``'s values (gathered whole,
        then cut; the collectives go through ``sharding.comm``)."""
        return self.dtensor(self.shard(full(dt)))


def full(t):
    """The whole value of ``t``: a DTensor gathered over every mesh dim
    that splits it; any other tensor as is."""
    if not _is_dtensor(t):
        return t
    return Layout.of(t).gather(t.to_local())


class _GatherLanded(torch.autograd.Function):
    @staticmethod
    def forward(fctx, w, summed, kept):
        fctx.layout, fctx.summed, fctx.kept = Layout.of(w), summed, kept
        return fctx.layout.gather(w.to_local(), kept)

    @staticmethod
    def backward(fctx, g):
        piece = fctx.layout.land(g.float(), fctx.summed, fctx.kept)
        return fctx.layout.dtensor(piece), None, None


def gathered(w, summed: Sequence[str], kept: Optional[Layout] = None):
    """The value of the weight ``w`` to compute with: whole, as ``full``
    gives it, or with ``kept`` (``w``'s layout with some dims gathered,
    such as its ``ShardCtx.fsdp_spec`` under tensor parallelism) this
    rank's piece of that layout, gathered over the other axes alone, in
    one pass either way.  When autograd records a DTensor ``w`` (a
    parameter at rest, ``train.steps.rest_sharded``), differentiably: the
    backward hands the gradient, in f32, to ``Layout.of(w).land(g,
    summed, kept)``, so the gradient autograd leaves on ``w`` is this
    rank's piece of the sum over the mesh axes ``summed`` (those whose
    ranks hold parts of it: the axes that split the tokens,
    ``ShardCtx.batch_axes``, and under tensor parallelism the model axis
    for a weight every model rank holds whole but uses on its own part):
    a reduce-scatter over the axes that both are summed and shard a
    gathered dim, a cut for the others, an all-reduce over the rest of
    ``summed``.  Autograd casts the piece to ``w``'s dtype.  The FSDP
    gather as the JAX package's layer scan makes it: called inside a remat
    body, the forward holds the layer only while it runs, the recompute
    gathers again, and the backward reduce-scatters each layer's gradient
    as it is done."""
    if not _is_dtensor(w):
        return w
    if not (torch.is_grad_enabled() and w.requires_grad):
        return Layout.of(w).gather(w.to_local(), kept)
    return _GatherLanded.apply(w, tuple(summed), kept)


def is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def map_axes(fn, axes_tree, *trees):
    """A tree map whose leaves are the first tree's logical-axes tuples
    (the empty tuple for scalars): over dicts (the first tree's keys), and
    lists and tuples that are not axes tuples; the other trees are followed
    along the first one's structure, their node at each leaf taken whole."""
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(t[k] for t in trees))
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(map_axes(fn, v, *(t[i] for t in trees))
                               for i, v in enumerate(axes_tree))
    raise TypeError(f"not an axes tree node: {axes_tree!r}")
