"""The port's multi-device layer: the row mesh and its collectives
(``dist``), the row-sharded stream mesh with its diagonal-plane and
dense-window routes (``mesh_stream``) and multi-process execution
(``multihost``)."""

from .dist import (
    RowMesh,
    ShardedCSR,
    distributed_spgemm,
    make_row_mesh,
    mesh_spgemm_fixed_cap,
    padded_to_host_csr,
    partition_rows,
)
from .mesh_stream import (
    NeedsetStats,
    RowShards,
    balanced_row_ranges,
    mesh_stream_spgemm,
    mesh_stream_to_host_csr,
)
from .multihost import global_row_mesh, initialize, local_row_range

__all__ = [
    "ShardedCSR", "distributed_spgemm", "make_row_mesh",
    "mesh_spgemm_fixed_cap", "partition_rows",
    "NeedsetStats", "RowShards", "balanced_row_ranges",
    "mesh_stream_spgemm", "mesh_stream_to_host_csr",
    "initialize", "global_row_mesh", "local_row_range",
    "padded_to_host_csr", "RowMesh",
]
