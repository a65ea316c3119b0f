"""The parallel layer over ``torch.distributed`` (counterpart of
:mod:`auvtpu.parallel`): what the JAX package does when one device is too
small.

The port is SPMD over processes: every rank of the default process group
calls the same function with the same arguments, holds only its own band
or block, and gets back what the JAX function returns.  A sharded plane
stays sharded, as JAX's global array does: a :class:`ShardedPlane` holds
this rank's band or block, and its ``full_tensor()`` gathers the plane.

- **query data parallelism**: :func:`shard_queries` splits a query batch
  over the ranks, the grid replicated (:func:`gather_queries` joins the
  answers);
- **spatial sharding**: :func:`sharded_fill` (row bands),
  :func:`sharded_fill2d` (2-D blocks) and :func:`sharded_fit_fill` (the
  distributed fit-then-fill) with multi-hop halo exchange, for grids larger
  than one device;
- **streaming**: :class:`ShardedStreamingInterpolator` and
  :class:`ShardedStreamingInterpolator2D`, mosaics larger than one device
  while the vehicle moves;
- **mission atlases**: :func:`build_atlas_sharded`, the K pages of an atlas
  one per rank;
- **processes**: :mod:`.multihost` joins a group from torchrun's
  environment; :mod:`.launch` starts ranks on this machine.
"""

from .mesh import Mesh, gather_queries, make_mesh, make_mesh2d, replicated, shard_queries
from .mission import build_atlas_sharded, fill_page_dynamic
from .spatial import ShardedPlane, sharded_fill, sharded_fill2d, sharded_fit_fill
from .streaming import ShardedStreamingInterpolator, ShardedStreamingInterpolator2D

__all__ = [
    "Mesh",
    "build_atlas_sharded",
    "fill_page_dynamic",
    "gather_queries",
    "make_mesh",
    "make_mesh2d",
    "replicated",
    "shard_queries",
    "ShardedPlane",
    "sharded_fill",
    "sharded_fill2d",
    "sharded_fit_fill",
    "ShardedStreamingInterpolator",
    "ShardedStreamingInterpolator2D",
]
