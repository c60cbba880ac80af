"""Multi-device scaling: mesh + sharded search (port of `leann_tpu/parallel`).

The corpus is sharded over a mesh of devices:

  - vector blocks (or per-shard subgraphs) live row-sharded across the
    mesh's devices
  - a query batch is data-parallel over the `dp` axis
  - every shard searches its local rows; the per-shard top-k candidates
    are concatenated in shard order and merged with a final top-k, so
    the only traffic between devices is B x k ids and scores

One process drives its whole mesh; across processes `init_distributed`
joins them and one all_gather merges their candidates.
"""

from leann_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from leann_tpu_torch.parallel.sharded import (
    ShardedFlatIndex,
    ShardedGraphIndex,
    ShardedIvf8Index,
    ShardedIvfIndex,
)

__all__ = ["init_distributed", "make_mesh", "Mesh", "ShardedFlatIndex",
           "ShardedGraphIndex", "ShardedIvfIndex", "ShardedIvf8Index"]
