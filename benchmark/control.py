"""Readings that a cell's correctness limits are set from, on the card at
the cell's own size, in one process:

- the program: for each ``--seeds`` seed, a short window of the cell's
  traffic and the widest gap of its kept answers from the plain reference
  (the lower reading is the largest over the seeds);
- the control: for each ``--control-seeds`` seed, the plain reference in
  bfloat16, the nearest precision below the configuration's float32, put
  in the program's place and judged by the same comparison (the upper
  reading is the smallest).

    python3 benchmark/control.py --workload <name> --seeds 1,2,... --control-seeds 7,8,9 [--seconds 1]

Prints one JSON line of readings.  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.yardstick.names import resolve  # noqa: E402


def program_reading(cell: str, seed: int, seconds: float, device: str = "cuda", overrides=None, spec=None) -> dict:
    """A short window of ``cell`` at ``seed`` and its check."""
    _, cfg, traffic = harness.cell_files(cell, spec, overrides)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    wl = harness.Workload(cfg, traffic, seed, device)
    keeper = harness.Keeper(seed, len(wl.pool), traffic.get("sample", 4))
    done = driver.run(wl, lambda i, t: t >= seconds and i >= len(wl.pool), keeper)
    kept = keeper.kept()
    del wl, keeper
    if device == "cuda":
        torch.cuda.empty_cache()
    return dict(harness.check(cfg, traffic, seed, device, kept), requests=done["requests"])


def control_reading(cell: str, seed: int, device: str = "cuda", overrides=None, dtype=None, spec=None) -> dict:
    """The reference in ``dtype`` (bfloat16 by default) in the program's
    place: its answers for each pool entry judged against the float32
    reference."""
    dtype = torch.bfloat16 if dtype is None else dtype
    _, cfg, traffic = harness.cell_files(cell, spec, overrides)
    pool = resolve(traffic["inputs"])(cfg, traffic, seed, device)
    ref_fn = resolve(traffic["reference"])
    kept = [(i, ref_fn(e["ref"], cfg, dtype)) for i, e in enumerate(pool)]
    del pool
    return harness.check(cfg, traffic, seed, device, kept)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args()
    out = {"workload": args.workload, "program": {}, "control": {}}
    for s in (int(v) for v in args.seeds.split(",")):
        t = time.perf_counter()
        out["program"][s] = program_reading(args.workload, s, args.seconds)
        print(f"program seed {s}: {out['program'][s]} ({time.perf_counter() - t:.1f} s)", file=sys.stderr, flush=True)
    for s in (int(v) for v in args.control_seeds.split(",")):
        out["control"][s] = control_reading(args.workload, s)
        print(f"control seed {s}: {out['control'][s]}", file=sys.stderr, flush=True)
    gaps = [r["max_gap_m"] for r in out["program"].values()]
    cgaps = [r["max_gap_m"] if r["nan_mismatch"] == 0 else float("inf") for r in out["control"].values()]
    out["lower"], out["upper"] = max(gaps), min(cgaps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
