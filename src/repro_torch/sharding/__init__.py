"""The port's distributed layer: ``ShardCtx`` (logical axes → a
``DeviceMesh``'s axes), layouts and the collectives (``comm``)."""
from repro_torch.sharding.ctx import (DEFAULT_RULES, EP_RULES, FSDP_RULES,
                                      Layout, ShardCtx, full, gathered,
                                      is_axes_leaf, map_axes, mesh_shape)

__all__ = ["DEFAULT_RULES", "EP_RULES", "FSDP_RULES", "Layout", "ShardCtx",
           "full", "gathered", "is_axes_leaf", "map_axes", "mesh_shape"]
