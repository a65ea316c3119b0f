"""Terrain of the configurations, made on the device in float64.

Frozen copies of the two synthetic surfaces the configurations name by
dotted path (``terrain.generator``); every generator takes (shape, seed,
device):

- ``shelf_seamount``: the reference study's Grid A surface
  (generate_csv_grids.cpp:38-56), a sloping shelf and a Gaussian seamount
  over [0, 100]^2 mapped onto the grid;
- ``kerguelen_standin``: the stand-in for the Kerguelen GEBCO tile, which
  the repository does not hold: a plateau at about -500 m falling to a
  -4000 m plain, with band-limited roughness at two octaves drawn from
  numpy's ``RandomState(seed)``, rounded to whole metres as GEBCO is.

Only the coarse octave draws (64^2 and 256^2 numbers) are made on the
host; the 5 M-cell surface is computed on the device, so set-up does not
wait seconds for host numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def shelf_seamount(shape, seed: int, device, *, domain=100.0, d0=10.0, k=2.0, amplitude=100.0,
                   center=(75.0, 50.0), sigma=(15.0, 15.0)) -> torch.Tensor:
    """depth(x, y) = -(d0 + k x) + A exp(-[(x-xm)^2/2sx^2 + (y-ym)^2/2sy^2])
    at (num_lat, num_lon) = ``shape``, both axes mapped onto [0, domain];
    float64 on ``device``.  The surface has no random part: ``seed`` is
    taken and not used."""
    h, w = shape
    f64 = dict(dtype=torch.float64, device=device)
    y = (domain * torch.arange(h, **f64) / (h - 1))[:, None]
    x = (domain * torch.arange(w, **f64) / (w - 1))[None, :]
    mountain = amplitude * torch.exp(-((x - center[0]) ** 2 / (2 * sigma[0] ** 2)
                                       + (y - center[1]) ** 2 / (2 * sigma[1] ** 2)))
    return -(d0 + k * x) + mountain


def kerguelen_standin(shape, seed: int, device) -> torch.Tensor:
    """The Kerguelen stand-in at ``shape`` = (num_lat, num_lon), float64 on
    ``device``, whole metres."""
    h, w = shape
    rng = np.random.RandomState(seed)
    f64 = dict(dtype=torch.float64, device=device)
    y = torch.linspace(-1.0, 1.0, h, **f64)[:, None]
    x = torch.linspace(-1.0, 1.0, w, **f64)[None, :]
    r2 = (x * 1.1) ** 2 + (y * 0.9) ** 2
    plateau = -500.0 - 3500.0 / (1.0 + torch.exp(-(r2 - 0.55) * 10.0))

    def octave(cells: int, amp: float) -> torch.Tensor:
        coarse = torch.as_tensor(rng.randn(cells, cells)).to(device)
        yy = torch.linspace(0, cells - 1, h, **f64)
        xx = torch.linspace(0, cells - 1, w, **f64)
        yi = yy.long().clamp(0, cells - 2)
        xi = xx.long().clamp(0, cells - 2)
        ty = (yy - yi)[:, None]
        tx = (xx - xi)[None, :]
        c00 = coarse[yi][:, xi]
        c01 = coarse[yi][:, xi + 1]
        c10 = coarse[yi + 1][:, xi]
        c11 = coarse[yi + 1][:, xi + 1]
        return amp * ((1 - ty) * ((1 - tx) * c00 + tx * c01) + ty * ((1 - tx) * c10 + tx * c11))

    rough = octave(64, 120.0) + octave(256, 35.0)
    return torch.round(plateau + rough)

