"""The rank layer under distributed training and sharded serving (the
port's `lightgbm_tpu/mesh/`):

 - ``topology``    — `init` (the process group), `Mesh` (1-D and
                     ("dcn", "ici") layouts of its ranks), `mesh_shape`;
 - ``placement``   — the ranks' row and feature blocks, and placing a
                     rank's rows from memory or from the shard store;
 - ``collectives`` — all_reduce, broadcast, all_gather, the ring's
                     hops and the split merge, counted and timed.

The reference's `mesh/compat.py` (its shim over `jax.shard_map`
versions) has no counterpart: nothing here depends on a JAX version.
"""
from .collectives import (STATS, all_gather, all_gather_rows,  # noqa: F401
                          all_reduce_sum, broadcast, broadcast_last,
                          merge_split, recv_tensors, reset_stats,
                          ring_fold, send_tensors)
from .placement import (collective_span, feature_block,  # noqa: F401
                        padded_feature_count, padded_row_count,
                        place_from_datastore, place_rows, row_block,
                        row_counts, stream_shard_plan)
from .topology import (Mesh, backend, build_mesh, describe,  # noqa: F401
                       get_mesh, get_mesh_2level, init, initialized,
                       parse_mesh_shape, rank, rank_device, shutdown,
                       world_size)

__all__ = [
    "Mesh", "backend", "build_mesh", "describe", "get_mesh",
    "get_mesh_2level", "init", "initialized", "parse_mesh_shape", "rank",
    "rank_device", "shutdown", "world_size",
    "collective_span", "feature_block", "padded_feature_count",
    "padded_row_count", "place_from_datastore", "place_rows", "row_block",
    "row_counts", "stream_shard_plan",
    "STATS", "all_gather", "all_gather_rows", "all_reduce_sum",
    "broadcast", "broadcast_last", "merge_split", "recv_tensors",
    "reset_stats", "ring_fold", "send_tensors",
]
