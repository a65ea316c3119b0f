"""Exact mode of two checkouts of auvtpu_torch on one NVIDIA GPU: the
host and device time of the stand-in r0.10 calls, so a change to exact
mode is measured against another version on one card.

Run from the root of a checkout:

    python3 scripts/exact_ab.py --other DIR [--label NAME]

DIR holds another version unpacked with ``git archive`` (into a directory
.gitignore lists).  Each turn is a fresh process that imports
``auvtpu_torch`` from one checkout; the turns run other, this, this, other.
A turn builds the f64 stand-in (2053x2441, 10 % masked with seed 42:
501,137 cells) and times each of two-tier kriging
(``exact_kriging_at_cells_fast``), strict kriging
(``exact_kriging_at_cells``), cubic and bilinear at those cells: the host
clock of a call ending in a sync (median of 3 after one warm-up), its
device-busy time (this checkout's ``chip_smoke.device_busy_ms``: every
device record of 2 profiled calls) and, for the two krigings, the host
split of ``chip_smoke.host_split_ms`` (cProfile: the query preparation,
the readbacks, the rest); each prediction's nansum is printed, so the two
versions' answers can be compared.  Prints one JSON line a turn and, last,
the card's name and power limit.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke_timers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def turn(repo: str, label: str) -> dict:
    sys.path.insert(0, repo)
    import numpy as np
    import torch

    from auvtpu_torch.config import KERGUELEN_EXTENT
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.masking import mask_grid
    from auvtpu_torch.ops import exact as texact
    from auvtpu_torch.ops import exact_fast as tfast
    from auvtpu_torch.synthetic import kerguelen_standin

    smoke = smoke_module()
    dev = torch.device("cuda", 0)
    reduced, rc, _ = mask_grid(kerguelen_standin((2053, 2441)), 0.10)
    g = RegularGrid.from_nan_array(reduced, KERGUELEN_EXTENT, dtype=torch.float64, device=dev)
    rows, cols = rc[:, 0], rc[:, 1]
    calls = {
        "kriging_two": lambda: tfast.exact_kriging_at_cells_fast(g, rows, cols),
        "kriging_strict": lambda: texact.exact_kriging_at_cells(g, rows, cols),
        "cubic": lambda: texact.exact_cubic_at_cells(g, rows, cols),
        "bilinear": lambda: texact.exact_bilinear_at_cells(g, rows, cols),
    }
    out = {"label": label, "repo": repo}
    for name, fn in calls.items():
        t0 = time.perf_counter()
        pred = fn()
        torch.cuda.synchronize()
        out[f"{name} first ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{name} nansum"] = float(np.nansum(pred))
        out[f"{name} host ms"] = smoke.host_ms(fn, reps=3)
        out[f"{name} device ms"] = smoke.device_busy_ms(fn)
        if name.startswith("kriging"):
            out[f"{name} split ms"] = smoke.host_split_ms(fn)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another checkout's root (timed first and last)")
    ap.add_argument("--label", default="other")
    ap.add_argument("--turn", help=argparse.SUPPRESS)  # a worker: time the checkout at this path
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn, args.label)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("exact_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not args.other:
        ap.error("--other DIR is required")
    order = [(os.path.abspath(args.other), args.label), (HERE, "this"), (HERE, "this"),
             (os.path.abspath(args.other), args.label)]
    for repo, label in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", repo, "--label", label],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
