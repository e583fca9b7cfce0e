"""Data x spatial meshes on torch.distributed (counterpart of
`tpufusion/parallel/`): `mesh` holds the mesh and its collectives, `halo`
the halo exchanges of a width-sharded convolution, `dryrun` the
multi-rank run held against one process."""

from tpufusion_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate",
]
