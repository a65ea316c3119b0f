#!/usr/bin/env python3
"""Fit-then-fill on a card, this checkout against another: the host time a
call of ``entry.fit_fill`` and of its layers takes, its device-busy time,
the variogram kernels alone, and the answers' bits.

Each side runs in a process of its own (``--parent DIR`` imports
``auvtpu_torch`` from DIR, another version unpacked with ``git archive``
into a directory .gitignore lists), in turns: parent, this, this, parent.
A side prints one JSON line: the card's name and power limit; the host µs
(quartiles of 300 calls, a synchronise every 8) of ``fit_fill``,
``fit_variogram`` and ``fill_kriging`` on the Kerguelen stand-in r0.10; the
device-busy ms of one ``fit_fill`` (``chip_smoke.device_busy_ms``); and a
digest of its parameters and plane.  This checkout's side also holds
``fit_fill`` bit for bit against the composition it replaced
(``empirical_variogram``, ``fit_exponential`` on ``lags * step``,
``fill_kriging``, the observed cells kept), times B9, B10 on arrays and
B10 on B9's sums alone (kernel records, ``chip_smoke.device_ms``) and
splits the fit's host time: the pair sums' and the fit's wrappers, their
ctypes launches, and the plan's lookup.  Run from the root of a checkout:

    python3 scripts/fitfill_probe.py [--parent DIR]
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_us(fn, reps: int = 300, sync_every: int = 8):
    import numpy as np
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
        if i % sync_every == sync_every - 1:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return [round(float(np.percentile(times, q)), 2) for q in (25, 50, 75)]


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def side(repo: str, label: str, extra: bool) -> dict:
    sys.path.insert(0, repo)
    sys.path.insert(1, REPO)
    import torch

    import chip_smoke as cs  # this checkout's: the workload and the timers
    from auvtpu_torch import entry
    from auvtpu_torch import variogram as tv
    from auvtpu_torch.ops.dense import fill_kriging

    g, _, _, _ = cs.bench_workload("cuda")
    plane, p = entry.fit_fill(g)
    torch.cuda.synchronize()
    out = {"label": label, "repo": repo, "card": cs.card_line(), "params": [float(v) for v in p],
           "digest": digest(torch.stack(p), plane)}
    out["host_us"] = {
        "fit_fill": host_us(lambda: entry.fit_fill(g)),
        "fit_variogram": host_us(lambda: tv.fit_variogram(g)),
        "fill_kriging": host_us(lambda: fill_kriging(g, vparams=p, backend="fused")),
    }
    out["fit_fill_device_busy_ms"] = cs.device_busy_ms(lambda: entry.fit_fill(g))
    if extra:
        from auvtpu_torch.kernels import variogram as kv

        lags, gamma, counts = tv.empirical_variogram(g)
        step = 0.5 * (abs(g.lat_step) + abs(g.lon_step))
        want_p = tv.fit_exponential(lags * step, gamma, counts, iters=25)
        want = torch.where(g.valid > 0.5, g.elev, fill_kriging(g, vparams=want_p, backend="fused"))
        out["bit_equal_to_the_composition"] = (torch.equal(torch.stack(p), torch.stack(want_p))
                                                and torch.equal(plane, want))
        H, W = g.shape
        dys, dxs, bin_of, table, h = tv._fit_plan(10, 10, g.lon_step, g.lat_step, g.dtype, g.device)
        s, c = kv.pair_sums(g.elev, g.valid, H, W, 0, dys, dxs, bin_of, 10, 10, table)
        ga, ca = kv.binned_gamma(s, c, g.dtype)
        out["device_ms"] = {
            "B9": cs.device_ms(lambda: kv.pair_sums(g.elev, g.valid, H, W, 0, dys, dxs, bin_of, 10, 10, table),
                               ("pair_sums_tile_kernel", "pair_sums_finish_kernel")),
            "B10 arrays": cs.device_ms(lambda: kv.fit_model(h, ga, ca, iters=25, stop=tv.STOP_DGAMMA),
                                       "fit_model_kernel"),
            "B10 binned": cs.device_ms(lambda: kv.fit_model(h, s, c, iters=25, stop=tv.STOP_DGAMMA, binned=True),
                                       "fit_model_kernel"),
        }
        out["host_us"].update({
            "plan lookup": host_us(lambda: tv._fit_plan(10, 10, g.lon_step, g.lat_step, g.dtype, g.device)),
            "kv.pair_sums (table)": host_us(
                lambda: kv.pair_sums(g.elev, g.valid, H, W, 0, dys, dxs, bin_of, 10, 10, table)),
            "kv.pair_sums (offsets)": host_us(
                lambda: kv.pair_sums(g.elev, g.valid, H, W, 0, dys, dxs, bin_of, 10, 10)),
            "pair_sums_launch": host_us(lambda: kv.pair_sums_launch(g.elev, g.valid, table, H, W, 0, 10, 10)),
            "kv.fit_model (binned)": host_us(
                lambda: kv.fit_model(h, s, c, iters=25, stop=tv.STOP_DGAMMA, binned=True)),
            "fit_binned_launch": host_us(lambda: kv.fit_binned_launch(h, s, c, None, "exponential", 25,
                                                                      tv.STOP_DGAMMA)),
            "keep observed (where)": host_us(lambda: torch.where(g.valid > 0.5, g.elev, plane)),
            "empirical_variogram": host_us(lambda: tv.empirical_variogram(g)),
        })
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--parent", help="another checkout to time in turns with this one")
    p.add_argument("--side", help=argparse.SUPPRESS)
    p.add_argument("--label", default="this", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.side:
        print(json.dumps(side(args.side, args.label, args.side == REPO)), flush=True)
        return 0
    order = [("this", REPO)] if not args.parent else [("parent", os.path.abspath(args.parent)), ("this", REPO),
                                                      ("this", REPO), ("parent", os.path.abspath(args.parent))]
    for label, repo in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--side", repo, "--label", label],
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-3000:])
        if proc.returncode != 0:
            print(json.dumps({"label": label, "failed": proc.returncode}), flush=True)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
