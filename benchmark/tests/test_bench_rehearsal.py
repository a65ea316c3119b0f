"""A rehearsal of every cell on the CPU at a tiny size, through the
program's plain versions: the whole run but the look for a card and the
profiler, then the same run with the timed path broken underneath, which
has to come out not correct; and the bfloat16 control, which has to fail
the cell's limits.  A rehearsal reports no number."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import control, harness

# the cells PERF.md holds back, whose files are kept: rehearsed as the others
HELD = [{"name": "gridb-fitfill-r0.10", "config": "gridb-kerguelen", "traffic": "fitfill-cells-r0.10", "chips": 1,
         "why": "fit-then-fill, held back"}]
BENCH_SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
SPEC = dict(BENCH_SPEC, workloads=BENCH_SPEC["workloads"] + HELD)
CELLS = [w["name"] for w in SPEC["workloads"]]
TINY = {"shape": [48, 64], "pool": 2, "batch": 2000}


def tiny(cell: str) -> dict:
    _, _, traffic = harness.cell_files(cell, SPEC)
    return {k: v for k, v in TINY.items() if k != "batch" or "batch" in traffic}


def rehearse(cell: str, seed: int = 2**31 + 77) -> dict:
    return harness.run(cell, seed, 0.3, False, device="cpu", overrides=tiny(cell), spec=SPEC)


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct(cell):
    r = rehearse(cell)
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks" and r["checks"]["max_gap_m"]["value"] == 0.0
    want = {m["name"] for m in harness.cell_metrics(SPEC, cell, "end_to_end")}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())


def _broken(fault):
    call = harness.Workload.call

    def broken(self, i):
        return fault(call(self, i).clone())

    return broken


def _alter_one(out):
    out[len(out) // 3] += 1.0
    return out


def _half_left_out(out):
    n = len(out) // 2
    out[n:] = out[:n].mean()
    return out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_alter_one, _half_left_out], ids=["answer_altered", "half_the_batch_left_out"])
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(harness.Workload, "call", _broken(fault))
    assert not rehearse(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell):
    limits = harness.load_json("limits", f"{cell}.json")
    got = control.control_reading(cell, 2**31 + 9, "cpu", tiny(cell), spec=SPEC)
    assert got["max_gap_m"] > 3 * limits["max_gap_m"] or got["nan_mismatch"] > limits["nan_mismatch"]
    sound = control.program_reading(cell, 2**31 + 9, 0.2, "cpu", tiny(cell), spec=SPEC)
    assert sound["max_gap_m"] <= limits["max_gap_m"] and sound["nan_mismatch"] == 0


def test_the_control_in_float32_reads_nothing():
    got = control.control_reading(CELLS[0], 3, "cpu", tiny(CELLS[0]), dtype=torch.float32)
    assert got["max_gap_m"] == 0.0  # the reference against itself


@pytest.mark.parametrize("cell", CELLS)
def test_the_configuration_reaches_program_and_reference(cell):
    """Another variogram in the configuration moves both sides alike: the
    program is handed the configuration's, not its own default (a cell
    that fits its variogram, or weights by distance, reads none)."""
    _, cfg, _ = harness.cell_files(cell, SPEC)
    over = dict(tiny(cell), variogram=dict(cfg["variogram"], nugget=5.0, range=2.5))
    r = harness.run(cell, 2**31 + 78, 0.3, False, device="cpu", overrides=over, spec=SPEC)
    assert r["correct"] and r["checks"]["max_gap_m"]["value"] == 0.0


def test_a_configuration_the_program_does_not_hold_is_refused():
    """A configuration that states what the program holds as its own default
    otherwise (the first ``fixed`` value changed) is refused in set-up, not
    run at the program's default."""
    cell = next(c for c in CELLS if harness.cell_files(c, SPEC)[2].get("fixed"))
    _, cfg, traffic = harness.cell_files(cell, SPEC)
    key = traffic["fixed"][0]["cfg"].split(".")[0]
    over = dict(tiny(cell), **{key: {**cfg[key], **{k: 99 for k in cfg[key]}} if isinstance(cfg[key], dict) else 99})
    with pytest.raises(SystemExit, match="does not hold what the configuration states"):
        harness.run(cell, 5, 0.3, False, device="cpu", overrides=over, spec=SPEC)
