"""The benchmark of ``auvtpu_torch`` on one NVIDIA H100, driven by data.

A cell of ``BENCHMARK.json`` names a configuration
(``benchmark/configs/<config>.json``: the deployment, its terrain and its
arithmetic) and a traffic mix (``benchmark/traffic/<traffic>.json``: the
pool of inputs, the driver ``benchmark/drivers/<driver>.py`` that offers
them, the program's entry point and its arguments, the defaults of the
program it relies on, the count of the work a request needs and the
reference that judges it).  Each metric is read by
``benchmark/metrics/<name>.py``; each cell's correctness limits are
``benchmark/limits/<cell>.json``.  The data files name code by dotted path
(pool makers, counts, references, terrain, the program's entry points), so
a cell is added by adding files and its entry in ``BENCHMARK.json``, with
no edit to a file that is there.

An argument of the program in a traffic file is a name of the pool entry
(a string among ``args``), a literal, ``{"cfg": key}`` (the configuration's
value at a dotted key; a list of keys gives a tuple) or ``{"call": dotted
path, "args", "kwargs", "item"}``, each evaluated once in set-up.

A run: set-up (inputs made on the device from the seed, the program's
prepared state, two warm-up passes over the pool), the window of
``--seconds``, with ``--trace 1`` a profiled sub-window of
``traffic["traced_requests"]`` requests after it, then the check of the
answers kept from the window against the plain reference, and one JSON
line on standard output.
"""

from __future__ import annotations

import importlib
import importlib.util
import inspect
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

from .yardstick import roofline
from .yardstick import trace as trace_mod
from .yardstick.names import resolve, value

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "auvtpu")
TRACE_FILE = ROOT / "build" / "benchmark" / "trace.json"
# copied from auvtpu_torch.utils.profiling, not imported: the tracer drops
# the first device records of a session in a busy process and now and then
# skews a session ~4 ms early, so the traced window opens behind tiny
# labelled kernels and an idle margin
WARMUP_KERNELS = 128
WINDOW_MARGIN_S = 0.05


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(*parts: str) -> dict:
    with open(BENCH.joinpath(*parts)) as f:
        return json.load(f)


def cell_files(name: str, spec: dict | None = None, overrides: dict | None = None) -> tuple[dict, dict, dict]:
    """(cell entry of BENCHMARK.json, configuration, traffic) of a cell.
    ``overrides`` (tests only) replace keys of the configuration and the
    traffic, for a rehearsal of the same code at a tiny size on the CPU."""
    spec = spec if spec is not None else json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    cfg, traffic = load_json("configs", f"{w['config']}.json"), load_json("traffic", f"{w['traffic']}.json")
    for key, val in (overrides or {}).items():
        (cfg if key in cfg else traffic)[key] = val
    return w, cfg, traffic


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, cell: str, kind: str) -> list[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics this cell reports."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


class Device:
    """Synchronise and events on the card; their host stand-ins on the CPU,
    where the harness only rehearses (a CPU run reports no number)."""

    def __init__(self, device: str):
        self.type = torch.device(device).type
        self.device = device

    def synchronize(self) -> None:
        if self.type == "cuda":
            torch.cuda.synchronize()

    def event(self):
        return torch.cuda.Event(enable_timing=True) if self.type == "cuda" else _HostEvent()


class _HostEvent:
    t = 0.0

    def record(self) -> None:
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


class Keeper:
    """Answers kept from the window for the check: the last answer of each
    pool entry and a reservoir of ``extra`` answers drawn from the seed."""

    def __init__(self, seed: int, pool: int, extra: int):
        self.rng = random.Random(seed)
        self.pool, self.extra = pool, extra
        self.last: dict[int, tuple[int, torch.Tensor]] = {}
        self.sample: list[tuple[int, torch.Tensor]] = []
        self.seen = 0

    def offer(self, i: int, out: torch.Tensor) -> None:
        self.last[i % self.pool] = (i, out)
        self.seen += 1
        if len(self.sample) < self.extra:
            self.sample.append((i, out))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.extra:
                self.sample[j] = (i, out)

    def kept(self) -> list[tuple[int, torch.Tensor]]:
        return sorted({i: out for i, out in list(self.last.values()) + self.sample}.items())


def argument(expr, entry: dict, cfg: dict, names: bool):
    """The value of one argument of a traffic file (see the module's
    docstring); ``names``: a string is a name of the pool entry (positional
    arguments) rather than a literal (keyword arguments)."""
    if isinstance(expr, dict):
        if "cfg" in expr:
            keys = expr["cfg"]
            return tuple(value(cfg, k) for k in keys) if isinstance(keys, list) else value(cfg, keys)
        if "call" in expr:
            out = resolve(expr["call"])(*[argument(a, entry, cfg, True) for a in expr.get("args", [])],
                                        **{k: argument(v, entry, cfg, False) for k, v in expr.get("kwargs", {}).items()})
            return out[expr["item"]] if "item" in expr else out
    if isinstance(expr, str) and names:
        return entry[expr]
    return expr


def fixed_mismatches(cfg: dict, traffic: dict) -> list[str]:
    """What the configuration states that the program is not handed but
    holds as its own default (``traffic["fixed"]``: a dotted path to a
    value, or to a function with ``param``), where the two differ."""
    bad = []
    for f in traffic.get("fixed", []):
        obj = resolve(f["program"])
        held = inspect.signature(obj).parameters[f["param"]].default if "param" in f else obj
        want = value(cfg, f["cfg"])
        if held != want:
            bad.append(f"{f['program']}{'(' + f['param'] + ')' if 'param' in f else ''} = {held!r}, "
                       f"the configuration's {f['cfg']} = {want!r}")
    return bad


class Workload:
    """A cell's pool of inputs and its request: ``call(i)`` hands pool entry
    ``i mod pool`` to the program's entry point and returns its answer."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str):
        self.cfg, self.traffic, self.dev = cfg, traffic, Device(device)
        grid_class = resolve(cfg["grid_class"])
        self.pool = resolve(traffic["inputs"])(cfg, traffic, seed, device, grid_class)
        req = traffic["request"]
        prepared: dict[int, dict] = {}
        for entry in self.pool:
            key = id(entry["grid"])
            if key not in prepared:
                prepared[key] = {name: argument(expr, entry, cfg, True)
                                 for name, expr in traffic.get("prepare", {}).items()}
            entry.update(prepared[key])
            entry["_args"] = [argument(a, entry, cfg, True) for a in req.get("args", [])]
            entry["_kwargs"] = {k: argument(v, entry, cfg, False) for k, v in req.get("kwargs", {}).items()}
        self.fn = resolve(req["call"])
        self.item, self.at = req.get("item"), req.get("at")
        self.points = self.pool[0]["n"]

    def call(self, i: int):
        e = self.pool[i % len(self.pool)]
        out = self.fn(*e["_args"], **e["_kwargs"])
        if self.item is not None:
            out = out[self.item]
        if self.at is not None:
            out = out.reshape(-1)[e[self.at]]
        return out


def device_info(device: str) -> dict:
    """What the run ran on, printed on standard error: the card's name and
    count, nvidia-smi's power limit and clocks, torch's and CUDA's
    versions."""
    info = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if device == "cuda":
        info["kind"] = torch.cuda.get_device_name(0)
        info["count"] = torch.cuda.device_count()
        try:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,clocks.mem",
                                  "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
            info["nvidia_smi"] = smi.stdout.strip().splitlines()
        except (OSError, subprocess.SubprocessError) as err:
            info["nvidia_smi"] = [f"unavailable: {err}"]
    log("device:", json.dumps(info))
    return info


def trace_agrees(span_us: float, events_us: float) -> bool:
    """Whether the profiler's device span over the traced requests agrees
    with CUDA events around them: within 2 % and a millisecond."""
    return abs(span_us - events_us) <= 0.02 * events_us + 1000.0


def profiled(wl: Workload, driver, n: int, attempts: int = 3) -> dict:
    """Run ``n`` requests under torch.profiler and reduce the trace; the
    device's span there is held against CUDA events over the same requests.
    A far-low or cut reading is profiled again, up to ``attempts`` times;
    where none agrees the run ends with no result, since no device metric
    may come from a trace the harness judged wrong."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    TRACE_FILE.parent.mkdir(parents=True, exist_ok=True)
    for attempt in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("benchmark.trace warm-up"):
                x = torch.zeros(1, device="cuda")
                for _ in range(WARMUP_KERNELS):
                    x.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(WINDOW_MARGIN_S)
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(trace_mod.WINDOW):
                ev0.record()
                done = driver.run(wl, lambda i, _t: i >= n)
                ev1.record()
                torch.cuda.synchronize()
            time.sleep(WINDOW_MARGIN_S)
        prof.export_chrome_trace(str(TRACE_FILE))
        red = trace_mod.reduce(trace_mod.load(TRACE_FILE))
        if red is None:
            log(f"trace attempt {attempt}: no device operation in the window")
            continue
        events_us = ev0.elapsed_time(ev1) * 1e3
        red.update(requests=done["requests"], events_us=events_us)
        ok = trace_agrees(red["span_us"], events_us)
        log(f"trace attempt {attempt}: device span {red['span_us']:.1f} us in the profiler, {events_us:.1f} us by "
            f"events, busy {red['busy_us']:.1f} us of a {red['window_us']:.1f} us window, "
            f"{red['n_device_ops']} device ops: {'agree' if ok else 'DISAGREE'}")
        if ok:
            return red
    raise SystemExit(f"no trace of {attempts} agreed with CUDA events over the traced requests: no result")


def gap(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, int]:
    """(widest |answer - reference| where both are numbers, count of answers
    that are NaN on one side only)."""
    out, ref = out.float().reshape(-1), ref.float().reshape(-1).to(out.device)
    nan_o, nan_r = torch.isnan(out), torch.isnan(ref)
    both = ~nan_o & ~nan_r
    widest = float((out[both] - ref[both]).abs().max()) if bool(both.any()) else 0.0
    return widest, int((nan_o != nan_r).sum())


def check(cfg: dict, traffic: dict, seed: int, device: str, kept) -> dict:
    """The numbers compared: each kept answer against the plain reference
    on inputs made again from the seed (the program's state is freed
    first)."""
    pool = resolve(traffic["inputs"])(cfg, traffic, seed, device)
    ref_fn = resolve(traffic["reference"])
    refs: dict[int, torch.Tensor] = {}
    widest, nan_mismatch = 0.0, 0
    for i, out in kept:
        e = i % len(pool)
        if e not in refs:
            refs[e] = ref_fn(pool[e]["ref"], cfg)
        g, m = gap(out, refs[e])
        widest, nan_mismatch = max(widest, g), nan_mismatch + m
    return {"max_gap_m": widest, "nan_mismatch": nan_mismatch, "answers": len(kept)}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(cell: str, seed: int, seconds: float, traced: bool, *, device: str = "cuda", t_start: float | None = None,
        overrides: dict | None = None, spec: dict | None = None) -> dict:
    """One run of ``cell``; returns the result line's object
    (``overrides``: see :func:`cell_files`)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec if spec is not None else json.loads((ROOT / "BENCHMARK.json").read_text())
    entry, cfg, traffic = cell_files(cell, spec, overrides)
    info = device_info(device)
    off = fixed_mismatches(cfg, traffic)
    if off:
        raise SystemExit("the program does not hold what the configuration states: " + "; ".join(off))
    torch.set_num_threads(1)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    wl = Workload(cfg, traffic, seed, device)
    # warm-up: every pool entry, through the driver, twice
    driver.run(wl, lambda i, _t: i >= 2 * len(wl.pool))
    keeper = Keeper(seed, len(wl.pool), traffic.get("sample", 4))
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s!r}")
    window = driver.run(wl, lambda _i, t: t >= seconds, keeper)
    log(f"window: {window['requests']} requests in {window['window_s']!r} s, {window['dispatch_s']!r} s inside calls")
    trace = profiled(wl, driver, traffic["traced_requests"]) if traced and device == "cuda" else None
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    kept = keeper.kept()
    points = wl.points
    del wl, keeper
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check(cfg, traffic, seed, device, kept)
    limits = load_json("limits", f"{cell}.json")
    log(f"check: {checks['answers']} answers of {window['requests']} requests in "
        f"{time.perf_counter() - t_check:.2f} s")
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of the JAX package or JAX were loaded: {bad}")
    counted = resolve(traffic["counts"])(cfg, traffic)
    record = {"window": window, "trace": trace, "setup_s": setup_s, "points_per_request": points,
              "needed_s": roofline.least_seconds(*counted)}
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell_metrics(spec, cell, kind):
        value = metric_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": info.get("kind", device),
           "count": entry["chips"], "memory_peak_bytes": peak}
    if trace is not None:
        dev.update(busy_s=trace["busy_us"] * 1e-6, window_s=trace["window_us"] * 1e-6)
        log(f"roofline: {counted[0]:.0f} bytes, {counted[1]:.4g} f32 ops, {counted[2]:.4g} f64 ops a request: "
            f"least {record['needed_s'] * 1e6:.3f} us at the published peaks; power limit "
            f"{info.get('nvidia_smi')}")
    compared = {name: {"value": checks[name], "limit": limits[name]} for name in limits}
    result = {"correct": all(c["value"] <= c["limit"] for c in compared.values()),
              "attempted": window["requests"], "failed": 0, "metrics": metrics, "device": dev}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    result["checks"] = compared
    for name, c in compared.items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    return result

