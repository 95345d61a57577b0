"""Mesh construction and the sharding presets.

Port of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX package's axis
names over the process group's ranks, which must already be initialised
(``torch.distributed.init_process_group``; a rank's address, world size
and rank are the caller's to give).  The single-pod production mesh is
16 × 16 = 256 ranks (``data``, ``model``); multi-pod adds a leading
``pod`` axis (2 × 16 × 16 = 512) used as an extra data-parallel
dimension.  ``LayoutMesh(production_shape())`` is the same shape with no
process group, for layouts alone (``ShardCtx.spec`` and
``tree_shardings``).

Not ported: ``shard_map`` and ``use_mesh``, which have no PyTorch meaning
(the port's ranks run their shard_map bodies as plain code, and a mesh
needs no activation); and the TPU v5e constants, since the card's figures
are ``repro_torch.hw``'s.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.sharding.ctx import (DEFAULT_RULES, EP_RULES, FSDP_RULES,
                                      ShardCtx)


def production_shape(*, multi_pod: bool = False) -> Dict[str, int]:
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


class LayoutMesh:
    """A mesh's axis names and sizes, with no ranks behind them."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    from torch.distributed.device_mesh import init_device_mesh
    shape = production_shape(multi_pod=multi_pod)
    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def make_ctx(mesh, preset: str = "default", **kw) -> ShardCtx:
    """Rule presets:
      default — 2D FSDP('data') × TP('model') with sequence-parallel
                activations (MoE + decode baseline)
      fsdp    — pure FSDP over all mesh axes, weights gathered per layer,
                no TP activation collectives (dense-train baseline)
      cp      — context parallel: batch on data, SEQUENCE on the model
                axis, weights FSDP over all axes, attention gathers only K/V
      ep      — default + experts on the model axis (dbrx variant)
    """
    pod = ("pod",) if "pod" in _axis_names(mesh) else ()
    if preset == "fsdp":
        dp: Tuple[str, ...] = pod + ("data", "model")
        return ShardCtx(mesh=mesh, dp=dp, tp="model",
                        rules=dict(FSDP_RULES), seq_shard=False, **kw)
    if preset == "cp":
        all_axes = pod + ("data", "model")
        rules = dict(FSDP_RULES, seq="__tp__", d_model=all_axes)
        return ShardCtx(mesh=mesh, dp=pod + ("data",), tp="model",
                        rules=rules, attn_impl="cp",
                        fsdp_axes=all_axes, **kw)
    if preset not in ("default", "ep"):
        raise ValueError(f"unknown preset {preset!r}: default, fsdp, cp, ep")
    rules = dict(EP_RULES) if preset == "ep" else dict(DEFAULT_RULES)
    return ShardCtx(mesh=mesh, dp=pod + ("data",), tp="model",
                    rules=rules, **kw)


def make_smoke_mesh(n: int = 0, device_type: str = "cuda"):
    """Mesh over the process group's ranks (``n``: all of them when 0):
    (n/2, 2) as (data, model) when n is even and above 1, else (n, 1).
    On the card unless ``device_type`` is ``"cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = n or dist.get_world_size()
    model = 2 if n % 2 == 0 and n > 1 else 1
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))
