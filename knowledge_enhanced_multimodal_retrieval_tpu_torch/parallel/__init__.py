"""Device meshes, placements, the distributed runtime and the parallel layouts (ROADMAP A5)."""

from .mesh import Mesh, MeshRuntime, Placement, make_mesh, runtime_init  # noqa: F401
from .sharding import (  # noqa: F401
    RowShards,
    ShardedParams,
    all_gather_autograd,
    all_gather_processes,
    batch_sharding,
    host_local_batch_to_global,
    pad_to_multiple,
    replicate,
    replicated,
    shard_params,
    shard_rows,
    unreplicate,
)
