"""Host cost of one span of ``auvtpu_torch.utils.profiling`` on this
machine: an empty ``with span(name)`` in a loop, with no profiler running
(the guarded no-op, against an unguarded ``torch.profiler.record_function``)
and under a CPU ``torch.profiler`` (``span``, which opens a
``_RecordFunctionFast``, against ``record_function``); with a card, under
a CPU and CUDA profiler, alone and around a tiny kernel's launch (against
the launch alone); and an empty call of a ``spanned`` function against the
plain function.  Each reading is the
least of ``--repeats`` loops of ``--n`` spans, less the empty loop, in
microseconds a span.

    python3 scripts/span_cost.py [--n 200000] [--repeats 5] [--cell NAME [--turns 4]]

``--cell``: also a benchmark cell's profiled window (``benchmark.harness``:
its traffic's ``traced_requests`` after two warm-up passes) with the spans
on and off in turns (on, off, off, on, ...; off: the profiler's check in
``utils.profiling`` answers no, so no span opens), each turn's device idle
share and the profiled window's milliseconds a request.

Prints one JSON line with torch's version and, where nvidia-smi answers,
the card's name and power limit (the host beside the card is the one that
dispatches the program's calls).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from auvtpu_torch.utils.profiling import span, spanned  # noqa: E402


def _least(body, n: int, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        body(n)
        best = min(best, time.perf_counter() - t0)
    return best / n * 1e6


def _empty(n):
    for _ in range(n):
        pass


def _span(n):
    for _ in range(n):
        with span("auvtpu_torch.probe.span"):
            pass


def _record_function(n):
    for _ in range(n):
        with torch.profiler.record_function("auvtpu_torch.probe.record_function"):
            pass


def _plain(x):
    return x


_decorated = spanned(_plain)


def _plain_calls(n):
    for _ in range(n):
        _plain(1)


def _decorated_calls(n):
    for _ in range(n):
        _decorated(1)


def _turns(cell: str, turns: int, seed: int = 2**31 + 4099) -> list[dict]:
    """The cell's profiled window with the spans on and off in turns."""
    import importlib

    from auvtpu_torch.utils import profiling
    from benchmark import harness

    _, cfg, traffic = harness.cell_files(cell)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    wl = harness.Workload(cfg, traffic, seed, "cuda")
    driver.run(wl, lambda i, _t: i >= 2 * len(wl.pool))
    enabled, rows = profiling._enabled, []
    for k in range(turns):
        on = k % 4 in (0, 3)
        profiling._enabled = enabled if on else (lambda: False)
        try:
            red = harness.profiled(wl, driver, traffic["traced_requests"])
        finally:
            profiling._enabled = enabled
        rows.append({"spans": on, "idle_pct": 100.0 * (1.0 - red["busy_us"] / red["window_us"]),
                     "window_ms_a_request": red["window_us"] / red["requests"] * 1e-3,
                     "idle_gaps": red["idle_gaps"][:4]})
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--cell", default=None)
    p.add_argument("--turns", type=int, default=4)
    args = p.parse_args()
    n, r = args.n, args.repeats
    base = _least(_empty, n, r)
    out = {"torch": torch.__version__, "n": n, "repeats": r, "loop_us": base}
    out["off_span_us"] = _least(_span, n, r) - base
    out["off_record_function_us"] = _least(_record_function, n, r) - base
    out["off_spanned_call_extra_us"] = _least(_decorated_calls, n, r) - _least(_plain_calls, n, r)
    on = max(n // 10, 1)  # the profiler keeps every event in memory
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out["on_span_us"] = _least(_span, on, r) - base
        out["on_record_function_us"] = _least(_record_function, on, r) - base
    if torch.cuda.is_available():
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        x = torch.zeros(1, device="cuda")

        def _add(k):
            for _ in range(k):
                x.add_(1.0)

        def _add_in_span(k):
            for _ in range(k):
                with span("auvtpu_torch.probe.span"):
                    x.add_(1.0)

        with torch.profiler.profile(activities=acts):
            out["on_cuda_span_us"] = _least(_span, on, r) - base
            launches = max(on // 10, 1)
            out["on_cuda_span_around_a_launch_us"] = (_least(_add_in_span, launches, r)
                                                      - _least(_add, launches, r))
            torch.cuda.synchronize()
    if args.cell:
        out["cell"] = args.cell
        out["turns"] = _turns(args.cell, args.turns)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        out["card"] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        out["card"] = f"unavailable: {err}"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
