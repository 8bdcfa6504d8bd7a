"""Parallelism over ranks (counterpart of `mxnet_tpu/parallel`).

The port's mesh is a grid of ranks of a ``torch.distributed`` group
(`parallel.mesh`), and data parallelism is what runs over it:
`gluon.FusedTrainStep(mesh=make_mesh({"dp": -1}))`.  The reference's
recipes, ring and Ulysses attention, pipeline and MoE layers
(`recipe`, `ring_attention`, `ulysses`, `pipeline`, `moe`, `layers`) and
``shard_put`` are not ported: ROADMAP queue A items A7d and A8.
"""
from .mesh import (
    Mesh, NamedSharding, PartitionSpec, RuleCoverage, constrain,
    current_mesh, data_sharding, global_put, init_distributed, make_mesh,
    match_partition_rules, mesh_scope, replicated_sharding, shard_parameters,
)

__all__ = [
    "make_mesh", "current_mesh", "mesh_scope", "data_sharding",
    "replicated_sharding", "match_partition_rules", "shard_parameters",
    "global_put", "constrain", "init_distributed", "RuleCoverage",
    "Mesh", "NamedSharding", "PartitionSpec",
]
