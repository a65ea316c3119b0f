"""Multi-process execution from torchrun's environment (counterpart of
:mod:`auvtpu.parallel.multihost`).

The sharded functions read the default process group; this module joins
one so that the same :func:`~.spatial.sharded_fit_fill` runs across
processes, on one machine or several:

- :func:`initialize` joins the group torchrun describes (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); with one process it does
  nothing;
- :func:`global_mesh` is a 1-D mesh over every rank;
- :func:`fit_fill_multihost` is the SPMD entry every process calls with
  the full-grid numpy plane.

On a machine with one card every rank shares ``cuda:0`` and the group is
``gloo`` (NCCL refuses two ranks on one card)::

    torchrun --nproc-per-node 2 -m auvtpu_torch.parallel.multihost
"""

from __future__ import annotations

import argparse
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import make_mesh, rank_device, transport_for


def initialize(device="cuda") -> bool:
    """Join the process group that torchrun's environment describes
    (``MASTER_ADDR``/``MASTER_PORT`` rendezvous, ``WORLD_SIZE``, ``RANK``),
    over :func:`.mesh.transport_for` ``device`` and the machine's
    ``LOCAL_WORLD_SIZE`` ranks.  With one process (or none configured) this
    is a no-op and returns False."""
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 or "MASTER_ADDR" not in os.environ:
        return False
    backend = transport_for(device, int(os.environ.get("LOCAL_WORLD_SIZE", world_size)))
    dist.init_process_group(backend, init_method="env://", world_size=world_size, rank=int(os.environ["RANK"]),
                            timeout=datetime.timedelta(seconds=300))
    return True


def global_mesh(axis: str = "dp", *, device=None):
    """1-D mesh over every rank of the process group (one rank without)."""
    return make_mesh(axis=axis, device=device)


def fit_fill_multihost(elev_np, extent, *, max_radius: int = 10, max_lag: int = 10, n_bins: int = 10, device=None):
    """SPMD fit+fill: every process calls this with the SAME full-grid numpy
    plane (NaN gaps); each rank copies only its band to its device.
    Returns (the :class:`~.spatial.ShardedPlane` of the (H, W) plane, this
    rank's band on its device; (nugget, sill, range), the same on every
    rank).  ``full_tensor()`` on every rank gathers the plane, as
    ``process_allgather`` does for the JAX package's."""
    from ..grid import RegularGrid
    from .spatial import sharded_fit_fill

    mesh = global_mesh(device=device)
    grid = RegularGrid.from_nan_array(np.asarray(elev_np, np.float32), extent, device="cpu")
    return sharded_fit_fill(mesh, grid, max_radius=max_radius, max_lag=max_lag, n_bins=n_bins)


def _child_main(argv=None):
    """Join the group (under torchrun) and run one fit+fill of the masked
    shelf-and-seamount grid.  Every rank prints one line, ``MH <nugget>
    <sill> <range> <nansum>``, and the transport."""
    from ..config import Extent
    from ..masking import mask_grid
    from ..synthetic import shelf_seamount

    p = argparse.ArgumentParser()
    p.add_argument("--shape", type=int, nargs=2, default=[64, 40])
    p.add_argument("--device", default="cuda", help="torch device of the ranks (default: the card)")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    joined = initialize(args.device)
    try:
        H, W = args.shape
        elev, _, _ = mask_grid(shelf_seamount(H, W), 0.2, seed=7)
        ext = Extent(0.0, float(W - 1), 0.0, float(H - 1))
        plane, vparams = fit_fill_multihost(elev, ext, max_radius=5, max_lag=5, n_bins=5, device=args.device)
        chk = float(torch.nansum(plane.full_tensor().double()))
        n, s, r = (float(v) for v in vparams)
        print(f"MH {n:.9g} {s:.9g} {r:.9g} {chk:.17g}", flush=True)
        print(f"rank {dist.get_rank() if joined else 0} on {rank_device(args.device)}, transport "
              f"{dist.get_backend() if joined else 'none'}", flush=True)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    _child_main()
