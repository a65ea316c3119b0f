#!/usr/bin/env python3
"""How many of a torch.profiler session's kernel records reach its Chrome
trace, and which ones it loses.

Each session profiles ``n`` back-to-back B1 fills (``fill_kriging`` on the
Kerguelen stand-in r0.10, ~0.4 ms each on an H100), synchronises the card,
waits ``settle`` seconds, and stops; the trace is then read back.  For every
(n, settle) it prints the B1 records kept out of n per session, and from
the records kept: the gap from each kernel's launch (its cudaLaunchKernel
record, by correlation id) to its start on the card, and the gap from the
last kernel's end to the end of the session's last host record (``settle``
pads the window's end).  Then it runs the port's
``utils.profiling.trace`` as a user would, one call a trace.

Last, ``--pairs`` times over, a session of 20 calls (and one of 1 call)
with the window closed at once, then the same through ``trace`` (which
opens with ``WARMUP_KERNELS`` tiny kernels and keeps ``WINDOW_MARGIN_S``
of idle card on both sides of the calls): for each
session that lost records, which launches lost them (the first ones, the
last ones) and the session's launch -> start extremes, whose sign says
which way its device times were skewed.

With ``--soak SECONDS`` it runs only this, in turns for that long: a
session closed at once, one through ``trace``, one through ``trace`` with
each margin of ``--margins``, and for each count of ``--warm`` a
session that first runs that many tiny kernels and synchronises (no
margin), each of 20 calls; it prints, by the time
since the first session, the records each kept and its launch -> start
extremes, to show whether the skew grows as the process ages.
``--after-pytest "ARGS"`` first runs pytest with those arguments in this
process (e.g. ``"tests/test_torch_cuda.py -q --noconftest"``), so that the
sessions run in a process that has done that work.

Run on a machine with a card, from the root of a checkout (~3 min):
    python3 scripts/trace_window_probe.py [--sessions 10] [--pairs 100]
    python3 scripts/trace_window_probe.py --soak 240
    python3 scripts/trace_window_probe.py --soak 30 --margins 0.5 2 \
        --after-pytest "tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider"
It prints one JSON line last.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def read_trace(path: str, match: str) -> dict:
    events = json.load(open(path)).get("traceEvents", [])
    kern = [e for e in events if e.get("cat") == "kernel" and match in str(e.get("name", ""))]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in events
                      if e.get("cat") == "cuda_runtime" and "LaunchKernel" in str(e.get("name", "")))
    kept_ids = {e["args"].get("correlation") for e in kern}
    lost = [i for i, (_, c) in enumerate(launches) if c not in kept_ids]
    host_end = max((e["ts"] + e.get("dur", 0) for e in events if e.get("cat") in ("cpu_op", "cuda_runtime",
                                                                                  "user_annotation")), default=0.0)
    lead = [e["ts"] - launch[e["args"]["correlation"]] for e in kern if e["args"].get("correlation") in launch]
    last_end = max((e["ts"] + e.get("dur", 0) for e in kern), default=None)
    return {"kept": len(kern), "launch_to_start_us": lead, "launches": len(launches), "lost_at": lost,
            "host_end_minus_last_kernel_end_us": None if last_end is None else host_end - last_end}


def session(fn, n: int, settle: float, match: str) -> dict:
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tdir:
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            if settle:
                time.sleep(settle)
        path = os.path.join(tdir, "t.json")
        prof.export_chrome_trace(path)
        return read_trace(path, match)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=10)
    ap.add_argument("--pairs", type=int, default=100)
    ap.add_argument("--soak", type=float, default=0.0)
    ap.add_argument("--margins", type=float, nargs="+", default=[0.5])
    ap.add_argument("--after-pytest", default="")
    ap.add_argument("--warm", type=int, nargs="*", default=[])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 1
    if args.after_pytest:
        import shlex

        import pytest

        print(f"[probe] pytest {args.after_pytest}: exit {pytest.main(shlex.split(args.after_pytest))}", flush=True)
    from auvtpu_torch.config import KERGUELEN_EXTENT
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.masking import mask_grid
    from auvtpu_torch.ops import fill_kriging
    from auvtpu_torch.synthetic import kerguelen_standin
    from auvtpu_torch.utils import profiling
    from auvtpu_torch.utils.profiling import WINDOW_MARGIN_S, trace

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    reduced, _, _ = mask_grid(kerguelen_standin((2053, 2441)), 0.10)
    grid = RegularGrid.from_nan_array(reduced, KERGUELEN_EXTENT, device="cuda")
    fn = lambda: fill_kriging(grid, backend="fused")  # noqa: E731
    fn()
    torch.cuda.synchronize()
    match = "kriging_fill_kernel"
    if args.soak:
        return soak(fn, match, args.soak, card, profiling, args.margins, args.warm)
    rows = []
    for n in (1, 20):
        for settle in (0.0, 0.002, 0.01, 0.05, 0.2):
            res = [session(fn, n, settle, match) for _ in range(args.sessions)]
            kept = [r["kept"] for r in res]
            lead = [x for r in res for x in r["launch_to_start_us"]]
            tail = [r["host_end_minus_last_kernel_end_us"] for r in res
                    if r["host_end_minus_last_kernel_end_us"] is not None]
            row = {"calls": n, "settle_s": settle, "kept": kept,
                   "sessions_missing_any": sum(k < n for k in kept),
                   "launch_to_start_us_median": float(np.median(lead)) if lead else None,
                   "launch_to_start_us_min": float(min(lead)) if lead else None,
                   "host_end_minus_last_kernel_end_us_median": float(np.median(tail)) if tail else None}
            rows.append(row)
            print(f"[probe] {n} call(s), settle {settle} s: B1 records kept per session {kept}; launch -> start "
                  f"median {row['launch_to_start_us_median']} us (min {row['launch_to_start_us_min']}); "
                  f"host end - last kernel end median {row['host_end_minus_last_kernel_end_us_median']} us  "
                  f"[{card}]", flush=True)
    kept_trace = []
    for _ in range(args.sessions):
        with tempfile.TemporaryDirectory() as tdir:
            with trace(tdir):
                fn()
            kept_trace.append(sum(read_trace(f, match)["kept"] for f in glob.glob(os.path.join(tdir, "trace.*.json"))))
    print(f"[probe] utils.profiling.trace, one B1 call a trace: records kept {kept_trace}  [{card}]")

    def traced(n: int) -> dict:
        with tempfile.TemporaryDirectory() as tdir:
            with trace(tdir):
                for _ in range(n):
                    fn()
            return read_trace(glob.glob(os.path.join(tdir, "trace.*.json"))[0], match)

    pairs = {(n, how): {"sessions": 0, "sessions_missing_any": 0, "records_lost": 0, "lost": []}
             for n in (20, 1) for how in ("closed at once", "trace")}
    for n in (20, 1):
        for _ in range(args.pairs):
            for how, run in (("closed at once", lambda: session(fn, n, 0.0, match)), ("trace", lambda: traced(n))):
                r = run()
                acc = pairs[n, how]
                acc["sessions"] += 1
                if r["kept"] < n:
                    acc["sessions_missing_any"] += 1
                    acc["records_lost"] += n - r["kept"]
                    lead = r["launch_to_start_us"]
                    acc["lost"].append({"kept": r["kept"], "launches": r["launches"], "lost_at": r["lost_at"],
                                        "launch_to_start_us_min": min(lead) if lead else None,
                                        "launch_to_start_us_max": max(lead) if lead else None})
        for how in ("closed at once", "trace"):
            acc = pairs[n, how]
            print(f"[probe] {n} call(s) a session, window {how} (margin {WINDOW_MARGIN_S if how == 'trace' else 0} "
                  f"s): {acc['sessions_missing_any']} of {acc['sessions']} sessions lost records, "
                  f"{acc['records_lost']} records in all; the losses {acc['lost'][:12]}  [{card}]", flush=True)
    print(json.dumps({"card": card, "sessions": rows, "trace_one_call": kept_trace,
                      "pairs": [{"calls": n, "window": how, **v} for (n, how), v in pairs.items()]}))
    return 0


def soak(fn, match: str, seconds: float, card: str, profiling, margins, warm) -> int:
    def traced(margin: float) -> dict:
        keep, profiling.WINDOW_MARGIN_S = profiling.WINDOW_MARGIN_S, margin
        try:
            with tempfile.TemporaryDirectory() as tdir:
                with profiling.trace(tdir):
                    for _ in range(20):
                        fn()
                return read_trace(glob.glob(os.path.join(tdir, "trace.*.json"))[0], match)
        finally:
            profiling.WINDOW_MARGIN_S = keep

    def warmed(n: int) -> dict:
        # n tiny kernels and a synchronisation first, inside the session
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        x = torch.zeros(1, device="cuda")
        with tempfile.TemporaryDirectory() as tdir:
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(n):
                    x.add_(1.0)
                torch.cuda.synchronize()
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            path = os.path.join(tdir, "t.json")
            prof.export_chrome_trace(path)
            return read_trace(path, match)

    kinds = {"closed at once": lambda: session(fn, 20, 0.0, match)}
    for m in (profiling.WINDOW_MARGIN_S, *margins):
        kinds[f"trace, margin {m} s"] = lambda m=m: traced(m)
    for n in warm:
        kinds[f"{n} tiny kernels first"] = lambda n=n: warmed(n)
    log = []
    t0 = time.perf_counter()
    next_print = 0.0
    while time.perf_counter() - t0 < seconds:
        for how, run in kinds.items():
            r = run()
            lead = r["launch_to_start_us"]
            log.append({"t_s": round(time.perf_counter() - t0, 2), "window": how, "kept": r["kept"],
                        "lost_at": r["lost_at"], "lead_min_us": min(lead) if lead else None,
                        "lead_max_us": max(lead) if lead else None})
        if log[-1]["t_s"] >= next_print:
            last = log[-len(kinds):]
            print(f"[soak] t={last[-1]['t_s']} s: " + "; ".join(
                f"{e['window']}: kept {e['kept']}/20, lead {e['lead_min_us']}..{e['lead_max_us']} us" for e in last),
                flush=True)
            next_print += 15.0
    for how in kinds:
        mine = [e for e in log if e["window"] == how]
        bad = [e for e in mine if e["kept"] < 20]
        print(f"[soak] {how}: {len(bad)} of {len(mine)} sessions lost records, {sum(20 - e['kept'] for e in bad)} "
              f"in all; first losses {[(e['t_s'], e['kept'], e['lost_at'][:3], e['lead_min_us']) for e in bad[:10]]}  "
              f"[{card}]", flush=True)
    print(json.dumps({"card": card, "soak": log}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
