"""Console-script entry points of the port's CLIs (``auvtpu-torch-*`` in
pyproject.toml).  Each runs its CLI's ``main`` on the command line's
arguments and returns 0: the mains return their summaries to Python
callers, which a console script would take for an exit status.  A failed
run raises (``SystemExit`` or the error), as under ``python -m``."""

from __future__ import annotations

import importlib

def _entry(name: str):
    def run() -> int:
        importlib.import_module(f"{__package__}.{name}").main()
        return 0

    run.__name__ = run.__qualname__ = name
    return run


bench_grid_a = _entry("bench_grid_a")
bench_grid_b = _entry("bench_grid_b")
demo = _entry("demo")
gen_grid = _entry("gen_grid")
subset = _entry("subset")
analyze = _entry("analyze")
plots = _entry("plots")
figures = _entry("figures")
prototype = _entry("prototype")
stream_demo = _entry("stream_demo")
learned_eval = _entry("learned_eval")
mission = _entry("mission")
