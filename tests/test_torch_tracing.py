"""The program's spans and counters (:mod:`auvtpu_torch.utils.profiling`)
on the CPU: a span is the shared no-op with no profiler running; under
``utils.profiling.trace`` each call of a benchmarked entry point leaves
one root span with its children named and nested as the layers run; the
``fill`` counters count the cells a fill solves and the cells it returns
on every backend; each kernel module's ``LAUNCHES`` is its section of the
registry; and no span enters a graph that ``torch.export`` or
``torch.compile`` traces.  The ctypes ``:call`` spans run only on the card
(tests/test_torch_cuda.py)."""

from __future__ import annotations

import glob
import importlib
import inspect
import json
import re

import pytest
import torch

from auvtpu_torch import serve
from auvtpu_torch.config import Extent
from auvtpu_torch.entry import fit_fill, tiny_masked_grid
from auvtpu_torch.grid import RegularGrid, device_cache
from auvtpu_torch.kernels.valid_select import kriging_valid_t, packed_idw_t
from auvtpu_torch.ops import dense
from auvtpu_torch.ops.packs import build_pack, build_valid16_pack, window_offsets
from auvtpu_torch.synthetic import shelf_seamount
from auvtpu_torch.utils import profiling
from auvtpu_torch.utils.profiling import COUNTERS, OFF, span, spanned, trace

torch.set_num_threads(1)

H, W = 48, 64
SPAN = re.compile(r"^auvtpu_torch\.[A-Za-z_][\w.]*(:[\w-]+)?$")
P = "auvtpu_torch."


def _masked():
    return tiny_masked_grid(H, W, device="cpu")


def _valid():
    return RegularGrid.dense(shelf_seamount(H, W), Extent(0.0, W - 1.0, 0.0, H - 1.0), device="cpu")


def _queries(n: int = 300):
    g = torch.Generator().manual_seed(5)
    return torch.rand(n, generator=g) * (W - 1), torch.rand(n, generator=g) * (H - 1)


def _cells(grid):
    flat = torch.nonzero(grid.valid.reshape(-1) < 0.5).reshape(-1)
    return flat // W, flat % W


def _call_kriging_at_cells():
    g = _masked()
    rows, cols = _cells(g)
    return lambda: dense.kriging_at_cells(g, rows, cols, backend="fused")


def _call_kriging_valid_t():
    g = _valid()
    pack, (lons, lats) = build_valid16_pack(g), _queries()
    return lambda: kriging_valid_t(pack, g, lons, lats)


def _call_packed_idw_t():
    g = _valid()
    pack, (lons, lats) = build_pack(g, window_offsets(2), clamp=False)[0], _queries()
    return lambda: packed_idw_t(pack, g, lons, lats)


def _call_fit_fill():
    g = _masked()
    return lambda: fit_fill(g)


# each entry point's spans on the CPU, root first: {span: its children};
# the op of the dispatcher that a span's children end in
CALLS = {
    "kriging_at_cells": (_call_kriging_at_cells, {
        "ops.dense.kriging_at_cells": {"ops.dense.fill_kriging", "ops.dense.kriging_at_cells:gather"},
        "ops.dense.fill_kriging": {"kernels.window_fill.fill_kriging_fused"},
        "kernels.window_fill.fill_kriging_fused": set(),
        "ops.dense.kriging_at_cells:gather": set(),
    }, ("kernels.window_fill.fill_kriging_fused", "auvtpu_torch::kriging_fill")),
    "kriging_valid_t": (_call_kriging_valid_t, {
        "kernels.valid_select.kriging_valid_t": {"kernels.scattered_select.select_krige"},
        "kernels.scattered_select.select_krige": set(),
    }, ("kernels.scattered_select.select_krige", "auvtpu_torch::select_krige")),
    "packed_idw_t": (_call_packed_idw_t, {
        "kernels.valid_select.packed_idw_t": {"kernels.scattered_select.idw_select"},
        "kernels.scattered_select.idw_select": set(),
    }, ("kernels.scattered_select.idw_select", "auvtpu_torch::idw_select")),
    "fit_fill": (_call_fit_fill, {
        "entry.fit_fill": {"variogram.fit_variogram", "ops.dense.fill_kriging"},
        "variogram.fit_variogram": {"kernels.variogram.pair_sums", "kernels.variogram.fit_model"},
        "kernels.variogram.pair_sums": set(),
        "kernels.variogram.fit_model": set(),
        "ops.dense.fill_kriging": {"kernels.window_fill.fill_kriging_fused"},
        "kernels.window_fill.fill_kriging_fused": set(),
    }, ("kernels.window_fill.fill_kriging_fused", "auvtpu_torch::kriging_fill")),
}


def _events(out_dir) -> list[dict]:
    files = glob.glob(str(out_dir / "trace.*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and e.get("cat") in ("cpu_op",
                                                                                                "user_annotation")]


def _parents(events) -> list[tuple[dict, dict | None]]:
    """Each event with the innermost event that encloses it on its thread
    (None for none): events nest on one thread."""
    out, stack = [], []
    for e in sorted(events, key=lambda e: (e["tid"], float(e["ts"]), -float(e.get("dur", 0)))):
        s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        while stack and (stack[-1][1] != e["tid"] or stack[-1][2] < t or stack[-1][0] > s):
            stack.pop()
        out.append((e, stack[-1][3] if stack else None))
        stack.append((s, e["tid"], t, e))
    return out


def test_a_span_with_no_profiler_running_is_the_shared_noop():
    assert not torch._C._autograd._profiler_enabled()
    assert span("auvtpu_torch.x.y") is OFF and span("auvtpu_torch.x.y:part") is OFF
    with span("auvtpu_torch.x.y") as got:
        assert got is None


def test_spanned_keeps_the_signature_and_names_the_span_by_module():
    # the benchmark reads fill_kriging's and fit_variogram's defaults
    from auvtpu_torch.variogram import fit_variogram

    assert inspect.signature(dense.fill_kriging).parameters["max_radius"].default == 10
    assert inspect.signature(fit_variogram).parameters["max_lag"].default == 10

    @spanned
    def piece(x, *, y=2):
        return x + y

    assert piece(1) == 3 and piece.__name__ == "piece"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        piece(1, y=4)
    names = {e.key for e in prof.key_averages()}
    assert f"{__name__}.test_spanned_keeps_the_signature_and_names_the_span_by_module.<locals>.piece" in names


@pytest.mark.parametrize("entry", list(CALLS))
def test_each_call_leaves_one_root_span_with_its_layers_nested(entry, tmp_path):
    make, tree, (holder, op) = CALLS[entry]
    fn = make()
    fn()  # warm: the caches' misses are spans of their own
    with trace(str(tmp_path)):
        fn()
        fn()
    pairs = _parents(_events(tmp_path))
    spans = [(e, p) for e, p in pairs if e["name"].startswith(P) and not e["name"].startswith("auvtpu_torch::")]
    assert all(SPAN.match(e["name"]) and e["cat"] == "cpu_op" for e, _ in spans)
    roots = [e for e, p in spans if p is None or not p["name"].startswith(P)]
    assert [e["name"] for e in roots] == [P + next(iter(tree))] * 2
    got: dict[str, set] = {}
    for e, p in spans:
        got.setdefault(e["name"][len(P):], set())
        if p is not None and p["name"].startswith(P):
            got.setdefault(p["name"][len(P):], set()).add(e["name"][len(P):])
    assert got == tree
    # the dispatcher's op nests under the wrapper's span, twice
    assert sum(1 for e, p in pairs if e["name"] == op and p is not None and p["name"] == P + holder) == 2
    assert len(spans) == 2 * len(tree) and len(tree) <= 6


@pytest.mark.parametrize("backend", ["torch", "select", "fused"])
def test_fill_counters_count_cells_solved_and_returned(backend):
    g = _masked()
    rows, cols = _cells(g)
    profiling.reset("fill")
    out = dense.kriging_at_cells(g, rows, cols, backend=backend)
    assert dict(COUNTERS["fill"]) == {"cells_solved": H * W, "cells_returned": rows.numel()} == \
        {"cells_solved": H * W, "cells_returned": out.numel()}
    dense.fill_kriging(g, backend=backend, with_variance=True)
    assert COUNTERS["fill"]["cells_solved"] == 2 * H * W and COUNTERS["fill"]["cells_returned"] == rows.numel()
    assert dense.FILL is COUNTERS["fill"]


@pytest.mark.parametrize("module", ["window_fill", "scattered_select", "exact_select", "exact_prologue",
                                    "band_resample", "exact_epilogue", "variogram"])
def test_each_launch_count_is_its_registry_section(module):
    mod = importlib.import_module(f"auvtpu_torch.kernels.{module}")
    assert mod.LAUNCHES is COUNTERS[f"launches.{module}"] and mod.LAUNCHES
    name = next(iter(mod.LAUNCHES))
    mod.LAUNCHES[name] += 3
    mod.reset_launches()
    assert set(mod.LAUNCHES.values()) == {0}


def test_a_cache_miss_is_a_span_and_a_hit_is_none():
    calls = []

    @device_cache(maxsize=4)
    def made(n: int):
        calls.append(n)
        return torch.full((n,), 1.0)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        made(2)
        made(2)
        made(3)
    miss = f"{__name__}.test_a_cache_miss_is_a_span_and_a_hit_is_none.<locals>.made:miss"
    counts = {e.key: e.count for e in prof.key_averages()}
    assert calls == [2, 3] and counts[miss] == 2


def test_an_exported_program_holds_no_profiler_op(tmp_path):
    path = str(tmp_path / "k.pt2")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        serve.export_fill(path, (H, W), extent=(0.0, W - 1.0, 0.0, H - 1.0), max_radius=5, device="cpu")
    program = torch.export.load(path)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
    assert serve.read_meta(path)["ops"] == ["auvtpu_torch::kriging_fill"]


def test_a_compiled_caller_traces_no_span():
    def f(x):
        with span("auvtpu_torch.tests.f"):
            return x + 1

    compiled = torch.compile(f, fullgraph=True, backend="eager")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch.equal(compiled(torch.ones(3)), torch.full((3,), 2.0))
    assert torch.equal(compiled(torch.ones(3)), torch.full((3,), 2.0))
