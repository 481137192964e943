"""The corpus sharded over a 1-D device mesh (the port of the JAX
package's ``parallel/``): the mesh and row-sharded arrays, process-group
start-up, the sharded top-k, the ring k-NN graph and sharded checkpoints.
The sharded IVF is not ported yet, and the JAX module's ``replicated`` /
``row_sharded`` shardings have no counterpart: a ``ShardedRows`` is the
row-sharded layout, and nothing of the port is replicated by hand."""

from .mesh import (
    DATA_AXIS,
    Mesh,
    ShardedRows,
    gather_rows,
    make_mesh,
    shard_rows,
)
from .distributed import global_mesh, initialize_distributed
from .checkpoint import load_sharded_index, save_sharded_index
from .sharded_topk import make_sharded_topk
from .knn import sharded_knn_graph

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "ShardedRows",
    "gather_rows",
    "make_mesh",
    "shard_rows",
    "make_sharded_topk",
    "sharded_knn_graph",
    "load_sharded_index",
    "save_sharded_index",
    "global_mesh",
    "initialize_distributed",
]
