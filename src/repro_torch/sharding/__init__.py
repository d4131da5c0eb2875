"""Sharding of the port's params, quantized stores and decode state over a
:class:`repro_torch.launch.mesh.Mesh` (torch twin of ``repro/sharding``)."""
from repro_torch.sharding.partition import (
    param_shardings,
    batch_spec,
    cache_shardings,
    shard_tree,
)

__all__ = ["param_shardings", "batch_spec", "cache_shardings", "shard_tree"]
