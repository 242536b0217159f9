"""Device meshes, placements and the distributed runtime (serving's half of ROADMAP A5)."""

from .mesh import Mesh, MeshRuntime, Placement, make_mesh, runtime_init  # noqa: F401
from .sharding import (  # noqa: F401
    RowShards,
    all_gather_processes,
    batch_sharding,
    pad_to_multiple,
    replicate,
    replicated,
    shard_rows,
    unreplicate,
)
