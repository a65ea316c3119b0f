"""The JAX package's numbers for the band-router phase of chip_smoke.py.

Run on XLA:CPU from the root of a checkout (a few minutes on one core):

    JAX_PLATFORMS=cpu python3 scripts/band_reference_pins.py

Prints one JSON object with, for each workload of chip_smoke.py's phase 17,
what ``auvtpu.ops.band.BandRouter`` gives under the JAX package's COST_NS:
the route a fresh router picks, and on the band path the page count, the
auto-sized window, the unresolved count and the f64 sum of the served
depths (on the packed path the sum too).  chip_smoke.py pins these beside
its gates.

Workloads: the mission CLI at its defaults (512x640 shelf + seamount, 10 %
masked with seed 42, 200,000 pings, seed 42, --max-bands 8) for the 'band'
and 'diagonal' missions; and the Kerguelen stand-in (2053x2441, 10 % masked,
seed 42) with 5,000,000 pings of the same two missions (trajectory seed 0),
kriging and IDW, band weave with one band and diagonal with up to 8 pages.
The 5M resample runs in slices of whole chunks, which gives the same values
as one call (each chunk is resampled on its own) in a bounded memory.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SLICE = 2048 * 128


def serve_band(router, lon, lat, method):
    """router.<method>(lon, lat, force='band') after prepare(), in slices of
    whole chunks; returns (served f32 depths, unresolved count)."""
    import jax.numpy as jnp

    n = len(lon)
    z = np.empty(n, np.float32)
    ok = np.empty(n, bool)
    for s in range(0, n, SLICE):
        zs, oks = router._resampler.resample(lon[s:s + SLICE], lat[s:s + SLICE])
        z[s:s + SLICE], ok[s:s + SLICE] = np.asarray(zs), np.asarray(oks)
    bad = np.nonzero(~ok)[0]
    if bad.size:
        esc = getattr(router.two_tier, method)
        z[bad] = np.asarray(esc(jnp.asarray(lon[bad]), jnp.asarray(lat[bad])))
    return z, int(bad.size)


def band_pins(router, lon, lat, method):
    out = router.prepare(lon, lat, method=method)
    z, bad = serve_band(router, lon, lat, method)
    assert np.isfinite(z).all()
    rs = router._resampler
    return dict(pages=int(out.shape[0]) if hasattr(out, "origins") else 1, wr=int(rs.wr), wc=int(rs.wc),
                masked=bool(out.masked), unresolved=bad, depth_sum=float(z.astype(np.float64).sum()))


def main():
    from auvtpu.cli.mission import synthetic_trajectory
    from auvtpu.config import KERGUELEN_EXTENT, Extent
    from auvtpu.grid import RegularGrid
    from auvtpu.masking import mask_grid
    from auvtpu.ops.band import BandRouter
    from auvtpu.synthetic import kerguelen_standin, shelf_seamount

    pins = {}
    H, W = 512, 640
    reduced, _, _ = mask_grid(shelf_seamount(H, W), 0.10, 42)
    g = RegularGrid.from_nan_array(np.asarray(reduced, np.float32), Extent(0.0, W - 1.0, 0.0, H - 1.0))
    for kind in ("band", "diagonal"):
        lon, lat = synthetic_trajectory(kind, g, 200_000, 42)
        r = BandRouter(g, max_bands=8)
        p = dict(route=r.route(lon, lat), **band_pins(r, lon, lat, "kriging"))
        packed = np.asarray(BandRouter(g, max_bands=8).kriging(lon, lat, force="packed"))
        p["packed_depth_sum"] = float(packed.astype(np.float64).sum())
        pins[f"cli/{kind}"] = p
        print(f"cli/{kind}: {p}", file=sys.stderr, flush=True)

    reduced, _, _ = mask_grid(kerguelen_standin((2053, 2441)), 0.10)
    g = RegularGrid.from_nan_array(reduced, KERGUELEN_EXTENT)
    for kind, mb in (("band", 1), ("diagonal", 8)):
        lon, lat = synthetic_trajectory(kind, g, 5_000_000, 0)
        for method in ("kriging", "idw"):
            r = BandRouter(g, max_bands=mb)
            p = dict(route=r.route(lon, lat), **band_pins(r, lon, lat, method))
            pins[f"standin/{kind}/{method}"] = p
            print(f"standin/{kind}/{method}: {p}", file=sys.stderr, flush=True)
    print(json.dumps(pins, sort_keys=True))


if __name__ == "__main__":
    main()
