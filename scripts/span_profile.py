"""Host time of a benchmark cell's requests by the program's spans, on one
NVIDIA GPU: one traced run of the cell (``benchmark.harness.run`` with
``--trace 1``: the timed window, then the profiled window of the traffic's
``traced_requests``), then a table of the spans in the profiled window
(``auvtpu_torch.<module>.<function>[:<part>]``) and of the dispatcher's
``auvtpu_torch::<op>`` events: calls a request, total and self host ms a
request (self: less the spans and ops nested in it) with the host events
that take most of its self time, and the idle time of
the card named by the innermost host event at each gap's midpoint
(``benchmark/yardstick/trace.py``).

    python3 scripts/span_profile.py --cell <name> [--seconds 10] [--seed N]

``--cell`` is a cell of BENCHMARK.json.  Prints the run's result line and
the table as JSON lines.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402
from benchmark.yardstick import spans as spans_mod  # noqa: E402
from benchmark.yardstick import trace as trace_mod  # noqa: E402

OP = "auvtpu_torch::"


def table(events: list[dict], requests: int, top: int = 3) -> list[dict]:
    """The spans and ops of the window's thread inside the window, by
    name: calls a request, total and self host ms a request, and the
    ``top`` host events directly inside each (torch's own ops, the CUDA
    runtime's calls) by their ms a request."""
    wins = [e for e in events if e.get("ph") == "X" and e.get("name") == trace_mod.WINDOW]
    w0, w1 = float(wins[0]["ts"]), float(wins[0]["ts"]) + float(wins[0]["dur"])
    tid = wins[0].get("tid")
    evs = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("tid") == tid and e.get("cat") in trace_mod.HOST_CATS
                  and e.get("name") != trace_mod.WINDOW and w0 <= float(e["ts"]) < w1),
                 key=lambda x: (x[0], -x[1]))
    ours = lambda name: bool(spans_mod.SPAN.match(name)) or name.startswith(OP)  # noqa: E731
    calls, total, child = defaultdict(int), defaultdict(float), defaultdict(float)
    inside: dict[str, dict[str, float]] = defaultdict(lambda: defaultdict(float))
    stack: list[tuple[float, float, str]] = []
    for s, t, name in evs:
        while stack and stack[-1][1] <= s:
            stack.pop()
        parent = stack[-1][2] if stack else None
        if ours(name):
            if parent is not None and ours(parent):
                child[parent] += t - s
            calls[name] += 1
            total[name] += t - s
        elif parent is not None and ours(parent):
            inside[parent][name] += t - s
        stack.append((s, t, name))
    per = lambda us: us / requests * 1e-3  # noqa: E731
    return [{"span": name, "calls_a_request": calls[name] / requests, "total_ms": per(total[name]),
             "self_ms": per(total[name] - child[name]),
             "inside_ms": [[k, per(v)] for k, v in sorted(inside[name].items(), key=lambda kv: -kv[1])[:top]]}
            for name in sorted(total, key=lambda n: -total[n])]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cell", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=2**31 + 101)
    args = p.parse_args()
    result = harness.run(args.cell, args.seed, args.seconds, True)
    print(json.dumps({"cell": args.cell, "result": result}), flush=True)
    events = trace_mod.load(harness.TRACE_FILE)
    red = trace_mod.reduce(events, top=20)
    requests = len(spans_mod.reduce(events)["roots"])  # one root span a request
    rows = table(events, max(requests, 1))
    print(json.dumps({"cell": args.cell, "root_spans": requests, "window_us": red["window_us"],
                      "busy_us": red["busy_us"], "idle_gaps": red["idle_gaps"], "spans": rows}), flush=True)
    for r in rows:
        print(f"{r['span']:<62} {r['calls_a_request']:6.2f} {r['total_ms']:8.4f} {r['self_ms']:8.4f}  "
              + ", ".join(f"{k} {v:.4f}" for k, v in r["inside_ms"]), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
