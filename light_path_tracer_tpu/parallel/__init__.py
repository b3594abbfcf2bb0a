"""Multi-chip scaling: mesh construction + image-tile data parallelism.

Single-host: parallel.tiles.trace_grid_sharded over a local Mesh.
Multi-host: parallel.multihost — jax.distributed
initialization, global mesh, and trace_grid_multihost (validated with
2 CPU processes x 4 virtual devices in tests/test_multihost.py).
"""

from light_path_tracer_tpu.parallel.mesh import make_mesh, shard_map_fn
from light_path_tracer_tpu.parallel.tiles import (
    trace_grid_sharded, trace_disk_grid_sharded)
from light_path_tracer_tpu.parallel.multihost import (
    initialize_multihost, make_global_mesh, trace_grid_multihost,
    trace_disk_grid_multihost)

__all__ = [
    "make_mesh", "shard_map_fn", "trace_grid_sharded",
    "trace_disk_grid_sharded",
    "initialize_multihost", "make_global_mesh", "trace_grid_multihost",
    "trace_disk_grid_multihost",
]
