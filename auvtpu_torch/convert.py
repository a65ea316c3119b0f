"""Carry the JAX package's state into the port: numpy in, tensors out.

Both packages can then be fed identical state, e.g.
``grid_from_arrays(np.asarray(jgrid.elev), np.asarray(jgrid.valid),
jgrid.min_lon, jgrid.max_lon, jgrid.min_lat, jgrid.max_lat, device)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .grid import RegularGrid


def grid_from_arrays(elev_np, valid_np, min_lon, max_lon, min_lat, max_lat, device) -> RegularGrid:
    """A port grid holding exactly the given (H, W) elevation and validity
    planes (dtype kept) on ``device``."""
    elev = torch.from_numpy(np.array(elev_np, copy=True)).to(device)
    valid = torch.from_numpy(np.array(valid_np, copy=True)).to(device)
    if elev.shape != valid.shape or elev.ndim != 2:
        raise ValueError(f"elev {tuple(elev.shape)} and valid {tuple(valid.shape)} must be one (H, W) shape")
    return RegularGrid(
        elev=elev,
        valid=valid.to(elev.dtype),
        min_lon=float(min_lon),
        max_lon=float(max_lon),
        min_lat=float(min_lat),
        max_lat=float(max_lat),
    )


def vparams_from_arrays(nugget, p1, p2, device):
    """Fitted variogram parameters (numpy or python scalars) as a tuple of
    0-d f32 tensors on ``device``, the form the port's fit returns."""
    return tuple(torch.tensor(float(np.asarray(v)), dtype=torch.float32, device=device) for v in (nugget, p1, p2))


def learned_params_from_arrays(flat, device) -> dict:
    """The learned inpainter's parameters from the JAX package's: its flax
    parameter tree ({"stem": {"kernel": ..., "bias": ...}, ...}) or the flat
    npz mapping of ``save_params`` ({"stem/kernel": ...}), numpy in.  Returns
    the port's ``state_dict`` on ``device``: HWIO kernels as OIHW weights,
    biases as they are, float32."""
    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    params = {}
    for key, v in leaves(flat):
        name, kind = key.rsplit("/", 1)
        t = torch.from_numpy(np.array(v, dtype=np.float32))
        if kind == "kernel":
            params[f"{name}.weight"] = t.permute(3, 2, 0, 1).contiguous().to(device)  # HWIO -> OIHW
        elif kind == "bias":
            params[f"{name}.bias"] = t.to(device)
        else:
            raise ValueError(f"unknown parameter {key!r}")
    return params
