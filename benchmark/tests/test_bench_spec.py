"""BENCHMARK.json against the benchmark's files: every cell, configuration,
traffic mix, driver, entry point, reference, count, limit and metric a run
needs is there and is found by its name; and the file keeps the contract's
shape.  CPU only."""

from __future__ import annotations

import copy
import importlib
import json
import re

import pytest

from benchmark import harness
from benchmark.yardstick.names import resolve, value

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51


def _calls(expr):
    """Every dotted path a traffic argument calls."""
    if isinstance(expr, dict):
        return ([expr["call"]] if "call" in expr else []) + [c for v in expr.values() for c in _calls(v)]
    if isinstance(expr, list):
        return [c for v in expr for c in _calls(v)]
    return []


def _cfg_keys(expr):
    """Every configuration key a traffic argument reads."""
    if isinstance(expr, dict):
        keys = expr.get("cfg", [])
        return (keys if isinstance(keys, list) else [keys]) + [k for v in expr.values() for k in _cfg_keys(v)]
    if isinstance(expr, list):
        return [k for v in expr for k in _cfg_keys(v)]
    return []


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve(cell):
    entry, cfg, traffic = harness.cell_files(cell, SPEC)
    assert entry["chips"] == 1
    importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    for path in (traffic["inputs"], traffic["counts"], traffic["reference"], cfg["terrain"]["generator"],
                 cfg["grid_class"], traffic["request"]["call"], *_calls(traffic.get("prepare", {})),
                 *_calls(traffic["request"])):
        assert callable(resolve(path)), path
    for path in (traffic["inputs"], traffic["counts"], cfg["terrain"]["generator"]):
        assert path.startswith("benchmark.yardstick."), path
    assert traffic["reference"].startswith("benchmark.reference."), "the reference is the benchmark's own"
    for key in _cfg_keys([traffic.get("prepare", {}), traffic["request"]]):
        value(cfg, key)
    limits = harness.load_json("limits", f"{cell}.json")
    assert set(limits) == {"max_gap_m", "nan_mismatch"} and limits["nan_mismatch"] == 0
    assert 0 < limits["max_gap_m"]


def test_configs_entries():
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json" and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_metrics_entries_and_readers():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert callable(harness.metric_reader(m["name"]))
    for m in SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert callable(harness.metric_reader(m["name"]))
        for cell in m["workloads"]:
            assert cell in CELLS and cell in e2e[m["moves"]].get("workloads", CELLS)
    for cell in CELLS:
        kinds = [harness.cell_metrics(SPEC, cell, k) for k in ("end_to_end", "per_layer")]
        assert len(kinds[0]) >= 2 and kinds[1]


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_holds_what_the_configuration_states(cell):
    """What the request does not hand the program, the program's defaults
    hold as the configuration states: the run checks the same in set-up."""
    _, cfg, traffic = harness.cell_files(cell, SPEC)
    assert harness.fixed_mismatches(cfg, traffic) == []
    for f in traffic.get("fixed", []):
        other = copy.deepcopy(cfg)
        *path, last = f["cfg"].split(".")
        node = other
        for part in path:
            node = node[part]
        node[last] = node[last] * 3 if isinstance(node[last], (int, float)) else node[last] + "_other"
        off = harness.fixed_mismatches(other, traffic)
        assert len(off) == 1 and f["cfg"] in off[0]


def test_names_resolve_modules_functions_and_class_fields():
    assert resolve("benchmark.yardstick.names.resolve") is resolve
    assert resolve("auvtpu_torch.config.KrigingConfig.pivot_tol") == 1e-12
    assert value({"a": {"b": 3}}, "a.b") == 3
    with pytest.raises(AttributeError):
        resolve("benchmark.yardstick.names.nothing_of_that_name")
