"""The port's quickstart and checking modes, on the CPU, against the JAX
package where it has a counterpart: the public names the JAX package has
(``EngineConfig``, ``exponential_model``, ``learned_available``, the
re-exported offset tables), ``masking.random_mask_device`` (its own draws:
a torch generator cannot reproduce ``jax.random``'s), ``utils.debug_mode``
and the CLIs' ``--debug`` flags, ``utils.profiling.trace``, and
``cli.demo`` checked against ``GoldenGrid``."""

import dataclasses
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import auvtpu.config as jcfg
from auvtpu import variogram as jv
from auvtpu.golden import ring_offsets as j_ring_offsets
from auvtpu.ops.dense import sorted_offsets as j_sorted_offsets

import auvtpu_torch
from auvtpu_torch import golden, learned, masking, variogram
from auvtpu_torch.cli import bench_grid_a, bench_grid_b, demo
from auvtpu_torch.config import Extent
from auvtpu_torch.golden import GoldenGrid
from auvtpu_torch.grid import RegularGrid
from auvtpu_torch.io import write_grid_csv, write_reference_missing
from auvtpu_torch.ops import dense, fill_bilinear, fill_idw, fill_kriging, fill_window_mean, scattered_bilinear
from auvtpu_torch.synthetic import shelf_seamount, sinusoid
from auvtpu_torch.utils import debug_mode, enable_debug
from auvtpu_torch.utils.profiling import trace

torch.set_num_threads(1)


def test_public_names_match_the_jax_package():
    assert dataclasses.asdict(auvtpu_torch.EngineConfig()) == dataclasses.asdict(jcfg.EngineConfig())
    assert [f.name for f in dataclasses.fields(auvtpu_torch.EngineConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.EngineConfig)]
    assert learned.learned_available() is True
    for R in (2, 10):
        for a, b in zip(golden.ring_offsets(R), j_ring_offsets(R)):
            np.testing.assert_array_equal(a, b)
        for conv in ("reference", "centered"):
            for a, b in zip(dense.sorted_offsets(R, conv), j_sorted_offsets(R, conv)):
                np.testing.assert_array_equal(a, np.asarray(b))
    h = np.linspace(0.0, 30.0, 50).astype(np.float32)
    for params in ((1.0, 100.0, 10.0), (0.1, 2.0e6, 55.5), (0.0, 5.0, 0.0)):
        got = variogram.exponential_model(torch.from_numpy(h), params).numpy()
        want = np.asarray(jv.exponential_model(jnp.asarray(h), params))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got, variogram.variogram_model(torch.from_numpy(h), params).numpy())


@pytest.mark.parametrize("shape, frac", [((40, 50), 0.1), ((17, 23), 0.5), ((8, 8), 0.0)])
def test_random_mask_device_count_and_determinism(shape, frac):
    def draw(seed):
        return masking.random_mask_device(torch.Generator(device="cpu").manual_seed(seed), shape, frac)

    m = draw(11)
    assert m.shape == shape and m.dtype == torch.bool and m.device.type == "cpu"
    assert int(m.sum()) == int(shape[0] * shape[1] * frac)
    assert torch.equal(m, draw(11))
    if 0 < m.sum() < m.numel():
        assert not torch.equal(m, draw(12))


def _covered():
    return RegularGrid.dense(sinusoid(64, 80), Extent(0.0, 79.0, 0.0, 63.0), device="cpu")


def test_debug_mode_passes_a_covered_fill_and_raises_at_the_op():
    g = _covered()
    with debug_mode():
        planes = [fill_bilinear(g), fill_idw(g), fill_window_mean(g), fill_kriging(g)]
        scattered_bilinear(g, np.array([3.3, 5.5, 78.9]), np.array([2.2, 7.7, 0.1]))
    assert all(bool(torch.isfinite(p).all()) for p in planes)
    # +inf beside -inf: the IDW sums make inf - inf, a NaN from no NaN
    e = sinusoid(64, 80)
    e[10, 10], e[10, 11] = np.inf, -np.inf
    g2 = RegularGrid.dense(e, Extent(0.0, 79.0, 0.0, 63.0), device="cpu")
    with debug_mode(), pytest.raises(FloatingPointError, match="aten"):
        fill_idw(g2)
    with debug_mode(disable_jit=True, x64=True), pytest.raises(FloatingPointError, match="aten.log"):
        torch.log(torch.tensor(-1.0))
    # restored on exit; a NaN passed in is not made again
    assert torch.isnan(torch.log(torch.tensor(-1.0)))
    with debug_mode():
        assert torch.isnan(torch.tensor([float("nan"), 1.0]) * 2.0).any()
    with debug_mode(nans=False, disable_jit=True):
        assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_enable_debug_is_process_wide_until_left():
    mode = enable_debug(nans=True)
    try:
        with pytest.raises(FloatingPointError):
            torch.sqrt(torch.tensor(-4.0))
    finally:
        mode.__exit__(None, None, None)
    assert torch.isnan(torch.sqrt(torch.tensor(-4.0)))
    assert enable_debug(nans=False, disable_jit=False) is None


def test_bench_clis_take_the_debug_flags(tmp_path):
    reduced, rc, vals = masking.mask_grid(shelf_seamount(40, 50), 0.2, seed=4)
    write_grid_csv(str(tmp_path / "r.csv"), reduced)
    write_reference_missing(str(tmp_path / "m.csv"), rc, vals)
    args = ["--reduced-csv", str(tmp_path / "r.csv"), "--reference-csv", str(tmp_path / "m.csv"),
            "--min-lon", "0", "--max-lon", "49", "--min-lat", "0", "--max-lat", "39",
            "--results", str(tmp_path / "b.csv"), "--device", "cpu"]
    plain = bench_grid_b.main(args)
    checked = bench_grid_b.main(args + ["--debug"])
    eager = bench_grid_b.main(args + ["--debug-eager"])
    for m in plain:
        assert plain[m]["RMSE"] == checked[m]["RMSE"] == eager[m]["RMSE"]
    np.save(str(tmp_path / "g.npy"), shelf_seamount(40, 50))
    a = bench_grid_a.main(["--grid-csv", str(tmp_path / "g.npy"), "--batch-sizes", "300", "--device", "cpu",
                           "--results", str(tmp_path / "a.csv"), "--debug"])
    assert a is not None
    # the mode is left with the run
    assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_trace_writes_a_chrome_trace(tmp_path):
    g = _covered()
    with trace(str(tmp_path / "tr")) as prof:
        fill_idw(g)
    files = glob.glob(str(tmp_path / "tr" / "trace.*.json"))
    assert len(files) == 1 and prof is not None
    events = json.load(open(files[0]))["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    with trace(None) as off:
        fill_idw(g)
    assert off is None and not os.path.exists(str(tmp_path / "none"))


def test_demo_toy_example_and_benchmark_against_golden(capsys):
    got, gold = demo.toy_example("cpu")
    elev = np.arange(80, dtype=float).reshape(8, 10) * 3.0 - 1000.0
    want = GoldenGrid(elev, -180.0, -171.0, 20.0, 27.0).bilinear(np.array([-175.5, -172.25, -179.9]),
                                                                  np.array([23.5, 21.75, 26.2]))
    np.testing.assert_array_equal(gold, want)
    np.testing.assert_allclose(got, want, atol=1e-3)
    res = demo.benchmark(batches=(200, 1000), grid_shape=(60, 80), device="cpu")
    assert set(res) == {200, 1000} and all(r["ok"] for r in res.values())
    # against GoldenGrid inside benchmark: f32 coordinates on a 0.25 deg grid: the sinusoid moves ~1e-4 m a cell
    assert all(r["max_err"] < 1e-3 for r in res.values())
    demo.main(["--batches", "200", "1000", "--grid-shape", "60", "80", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "toy 10x8 grid" in out and out.count("validation PASSED") == 4 and "FAILED" not in out
    assert "TPU" not in out
