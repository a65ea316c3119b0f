#!/usr/bin/env python3
"""A short first check of the variogram kernels on a card: B9 (pair sums)
and B10 (the Gauss-Newton fit) against their plain twins on the Kerguelen
stand-in r0.10, then their times.

Builds ``csrc/variogram.cu`` and prints its ptxas report; holds B9 to
``pair_sums_ref`` as the whole grid, a 1000-row band and a 1000x1200 2-D
block, with the 10 lag and the 40 (sector, lag) bins (counts equal, the
largest relative difference of the sums, equal once rounded to f32, a
second call bit-equal); holds B10 to ``fit_model_ref`` for every model over
25 steps (landing, relative difference, per-step flags equal); runs
``entry.fit_fill`` with the launch counts zeroed (landing, RMSE, launches);
then B9's wrapper by CUDA events, B9 and B10 by their device duration
(``chip_smoke.device_ms``) and ``fit_fill`` by events and device-busy.
Run from the root of a checkout on a machine with a card:

    python3 scripts/variogram_probe.py
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("variogram_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from auvtpu_torch import entry
    from auvtpu_torch import variogram as tv
    from auvtpu_torch.kernels import build as kbuild
    from auvtpu_torch.kernels import variogram as kv
    from auvtpu_torch.kernels import window_fill as wf

    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    kv.build()
    print("build", time.perf_counter() - t0)
    print(kbuild.library_path("variogram").with_suffix(".log").read_text())
    g, rows, cols, truth = cs.bench_workload("cuda")
    R = 10
    H, W = g.shape
    tables = (("iso", tv._bin_table(R, 10)[:3] + (10,)), ("dir", tv._sector_bin_table(R, 10, 4)[:3] + (40,)))
    layouts = (("whole", (g.elev, g.valid, H, W, 0)),
               ("band", (g.elev[:1000 + R], g.valid[:1000 + R], 1000, W, 0)),
               ("2d", (g.elev[500:1500 + R, 700:1900 + 2 * R], g.valid[500:1500 + R, 700:1900 + 2 * R], 1000, 1200,
                       R)))
    for name, (dys, dxs, bins, n_out) in tables:
        for lay, args in layouts:
            a = kv.pair_sums(*args, dys, dxs, bins, n_out, R)
            b = kv.pair_sums_ref(*args, dys, dxs, bins, n_out, R)
            a2 = kv.pair_sums(*args, dys, dxs, bins, n_out, R)
            torch.cuda.synchronize()
            rel = float(((a[0] - b[0]).abs() / b[0].abs().clamp(min=1e-300)).max())
            print(name, lay, "counts equal", torch.equal(a[1], b[1]), "sums rel", rel, "f32 equal",
                  torch.equal(a[0].float(), b[0].float()), "repeat bit-equal",
                  torch.equal(a[0], a2[0]) and torch.equal(a[1], a2[1]), flush=True)
    lags, gam, cnt = tv.empirical_variogram(g)
    step = 0.5 * (abs(g.lat_step) + abs(g.lon_step))
    h, gd, cd = (lags * step).double(), gam.double(), cnt.double()
    for m in ("exponential", "linear", "spherical", "gaussian"):
        p, fl = kv.fit_walk(h, gd, cd, model=m, iters=25, stop=tv.STOP_DGAMMA)
        rec = []
        w = torch.stack(kv.fit_model_ref(h, gd, cd, model=m, iters=25, stop=tv.STOP_DGAMMA, record=rec))
        print(m, p.tolist(), w.tolist(), "rel", float(((p - w).abs() / w.abs()).max()), "flags equal",
              fl.cpu().tolist() == [[int(a), int(b)] for a, b in rec], flush=True)
    kv.reset_launches()
    wf.reset_launches()
    filled, vp = entry.fit_fill(g)
    torch.cuda.synchronize()
    print("fit_fill", [float(x) for x in vp], cs.rmse(filled, rows, cols, truth), dict(kv.LAUNCHES),
          dict(wf.LAUNCHES), flush=True)

    def events_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    dys, dxs, bins, _ = tv._bin_table(R, 10)
    print("B9 wrapper ms", events_ms(lambda: kv.pair_sums(g.elev, g.valid, H, W, 0, dys, dxs, bins, 10, R)))
    print("B9 device ms", cs.device_ms(lambda: kv.pair_sums(g.elev, g.valid, H, W, 0, dys, dxs, bins, 10, R),
                                       "pair_sums_"))
    print("B10 device ms", cs.device_ms(lambda: kv.fit_walk(h, gd, cd, iters=25, stop=tv.STOP_DGAMMA),
                                        "fit_model_kernel"))
    print("fit_fill ms", events_ms(lambda: entry.fit_fill(g)))
    print("fit_fill device-busy", cs.device_busy_ms(lambda: entry.fit_fill(g)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
