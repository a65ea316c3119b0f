"""The port's host-side copies (config, offset tables, masking, synthetic
surfaces, grid geometry) are bit-equal to the JAX package's, and the port
never imports jax or auvtpu."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import auvtpu.config as jcfg
from auvtpu.golden.engine import ring_offsets as j_ring_offsets
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid as j_mask_grid
from auvtpu.masking import select_random_points as j_select_random_points
from auvtpu.ops.dense import _CHUNK as J_CHUNK
from auvtpu.ops.dense import _padded_tables as j_padded_tables
from auvtpu.ops.dense import sorted_offsets as j_sorted_offsets
from auvtpu import synthetic as jsyn

import auvtpu_torch.config as tcfg
from auvtpu_torch import synthetic as tsyn
from auvtpu_torch import tables
from auvtpu_torch.grid import RegularGrid
from auvtpu_torch.masking import mask_grid, select_random_points

torch.set_num_threads(1)

PORT = pathlib.Path(__file__).resolve().parent.parent / "auvtpu_torch"


@pytest.mark.parametrize("radius", [1, 5, 10])
def test_ring_offsets_equal(radius):
    offs, segs = tables.ring_offsets(radius)
    j_offs, j_segs = j_ring_offsets(radius)
    np.testing.assert_array_equal(offs, j_offs)
    np.testing.assert_array_equal(segs, j_segs)
    assert offs.dtype == j_offs.dtype and segs.dtype == j_segs.dtype


@pytest.mark.parametrize("convention", ["reference", "centered"])
@pytest.mark.parametrize("radius", [1, 5, 10])
def test_sorted_offsets_equal(radius, convention):
    got = tables.sorted_offsets(radius, convention)
    want = j_sorted_offsets(radius, convention)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("convention", ["reference", "centered"])
@pytest.mark.parametrize("radius", [1, 5, 10])
def test_padded_tables_equal(radius, convention):
    assert tables.CHUNK == J_CHUNK
    got = tables.padded_tables(radius, convention)
    want = j_padded_tables(radius, convention)
    assert got[4] == want[4]
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_sorted_offsets_rejects_unknown_convention():
    with pytest.raises(ValueError):
        tables.sorted_offsets(3, "diagonal")


def test_config_equal():
    for name in ("VariogramConfig", "FallbackConfig", "KrigingConfig", "IDWConfig"):
        assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(getattr(jcfg, name)())
    assert dataclasses.astuple(tcfg.KERGUELEN_EXTENT) == dataclasses.astuple(jcfg.KERGUELEN_EXTENT)
    assert tcfg.KERGUELEN_EXTENT.steps(2053, 2441) == jcfg.KERGUELEN_EXTENT.steps(2053, 2441)
    assert tcfg.DEFAULT_REMOVAL_FRACTION == jcfg.DEFAULT_REMOVAL_FRACTION
    assert tcfg.DEFAULT_MASK_SEED == jcfg.DEFAULT_MASK_SEED
    assert tcfg.FallbackConfig().max_candidates == jcfg.FallbackConfig().max_candidates
    assert dataclasses.astuple(tcfg.GRID_A_EXTENT) == dataclasses.astuple(jcfg.GRID_A_EXTENT)
    assert tcfg.RESULTS_SCHEMA == jcfg.RESULTS_SCHEMA
    assert tuple(tcfg.GRID_A_BATCH_SIZES) == tuple(jcfg.GRID_A_BATCH_SIZES)
    assert tcfg.GRID_A_SHAPE == jcfg.GRID_A_SHAPE
    assert (tcfg.VALIDATION_POINTS, tcfg.VALIDATION_ATOL) == (jcfg.VALIDATION_POINTS, jcfg.VALIDATION_ATOL)
    assert tcfg.GEBCO_TILES.keys() == jcfg.GEBCO_TILES.keys()
    for name, tile in tcfg.GEBCO_TILES.items():
        jtile = jcfg.GEBCO_TILES[name]
        assert tile.keys() == jtile.keys()
        assert tile["path"] == jtile["path"] and tile.get("shape") == jtile.get("shape")
        assert dataclasses.astuple(tile["extent"]) == dataclasses.astuple(jtile["extent"])


@pytest.mark.parametrize("shape,frac,seed", [((64, 80), 0.1, 42), ((37, 53), 0.25, 3)])
def test_mask_grid_equal(shape, frac, seed):
    np.testing.assert_array_equal(
        select_random_points(shape, frac, seed), j_select_random_points(shape, frac, seed)
    )
    elev = tsyn.shelf_seamount(*shape)
    got = mask_grid(elev, frac, seed)
    want = j_mask_grid(elev, frac, seed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_synthetic_surfaces_equal():
    np.testing.assert_array_equal(tsyn.kerguelen_standin((64, 80)), jsyn.kerguelen_standin((64, 80)))
    np.testing.assert_array_equal(tsyn.shelf_seamount(96, 80), jsyn.shelf_seamount(96, 80))
    np.testing.assert_array_equal(
        tsyn.shelf_seamount(30, 40, amplitude=50.0, center_x=20.0),
        jsyn.shelf_seamount(30, 40, amplitude=50.0, center_x=20.0),
    )
    np.testing.assert_array_equal(tsyn.sinusoid(33, 47), jsyn.sinusoid(33, 47))


def test_step_tensors_are_made_once_and_keep_the_query_dtype():
    # the 0-d step tensors that query coordinates divide by: rounded to the
    # dtype, one pair per (dtype, device) and grid; lonlat_to_xy keeps a
    # float64 query in float64 and a float32 one bit-equal to JAX's
    g = RegularGrid.dense(tsyn.sinusoid(33, 47), tcfg.KERGUELEN_EXTENT, device="cpu")
    lon_step, lat_step = g.step_tensors()
    assert g.step_tensors()[0] is lon_step and lon_step.dtype == torch.float32 and lon_step.ndim == 0
    assert float(lon_step) == float(np.float32(g.lon_step)) and float(lat_step) == float(np.float32(g.lat_step))
    assert float(g.step_tensors(torch.float64)[1]) == g.lat_step
    lons = np.array([74.7, 80.0, 84.7])
    lats = np.array([-58.0, -55.1, -49.8])
    x64, y64 = g.lonlat_to_xy(torch.from_numpy(lons), torch.from_numpy(lats))
    assert x64.dtype == torch.float64
    np.testing.assert_array_equal(x64.numpy(), (lons - g.min_lon) / g.lon_step)
    np.testing.assert_array_equal(y64.numpy(), (lats - g.min_lat) / g.lat_step)
    jg = JGrid.dense(jsyn.sinusoid(33, 47), jcfg.KERGUELEN_EXTENT)
    for a, b in zip(g.lonlat_to_xy(torch.from_numpy(lons.astype(np.float32)), torch.from_numpy(lats.astype(np.float32))),
                    jg.lonlat_to_xy(lons.astype(np.float32), lats.astype(np.float32))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_grid_matches_jax_grid():
    elev, _, _ = mask_grid(tsyn.kerguelen_standin((64, 80)), 0.1)
    g = RegularGrid.from_nan_array(elev, tcfg.KERGUELEN_EXTENT, device="cpu")
    jg = JGrid.from_nan_array(elev, jcfg.KERGUELEN_EXTENT)
    np.testing.assert_array_equal(g.elev.numpy(), np.asarray(jg.elev))
    np.testing.assert_array_equal(g.valid.numpy(), np.asarray(jg.valid))
    assert g.elev.dtype == torch.float32 and g.shape == tuple(jg.shape)
    assert (g.lon_step, g.lat_step) == (jg.lon_step, jg.lat_step)
    assert dataclasses.astuple(g.extent) == dataclasses.astuple(jg.extent)
    np.testing.assert_array_equal(g.to_nan_array(), jg.to_nan_array())
    rows, cols = np.array([0, 5, 63]), np.array([0, 17, 79])
    for a, b in zip(g.index_to_lonlat(rows, cols), jg.index_to_lonlat(rows, cols)):
        np.testing.assert_array_equal(a, b)
    lons = np.array([74.7, 80.0, 84.7], np.float32)
    lats = np.array([-58.0, -55.1, -49.8], np.float32)
    for a, b in zip(g.lonlat_to_xy(torch.from_numpy(lons), torch.from_numpy(lats)), jg.lonlat_to_xy(lons, lats)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    d = RegularGrid.dense(tsyn.sinusoid(8, 9), tcfg.KERGUELEN_EXTENT, device="cpu")
    jd = JGrid.dense(jsyn.sinusoid(8, 9), jcfg.KERGUELEN_EXTENT)
    np.testing.assert_array_equal(d.elev.numpy(), np.asarray(jd.elev))
    np.testing.assert_array_equal(d.valid.numpy(), np.asarray(jd.valid))


_BANNED = {"jax", "jaxlib", "flax", "optax", "auvtpu"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_or_auvtpu():
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    names = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    for new in (
        "cli/bench_grid_b.py", "cli/stream_demo.py", "utils/timing.py", "streaming.py", "metrics.py", "io.py",
        "cli/bench_grid_a.py", "golden/engine.py", "golden/v2.py", "ops/window.py", "ops/packs.py",
        "ops/batch.py", "ops/two_tier.py", "kernels/valid_select.py", "kernels/scattered_select.py",
        "ops/band.py", "kernels/band_resample.py", "cli/mission.py", "ops/exact.py", "ops/exact_fast.py",
        "learned.py", "cli/learned_eval.py", "serve.py", "scattered.py", "cli/prototype.py", "kernels/library.py",
        "parallel/mesh.py", "parallel/launch.py", "parallel/spatial.py", "parallel/streaming.py",
        "parallel/mission.py", "parallel/multihost.py", "ops/tiled.py", "utils/debug.py", "utils/profiling.py",
        "cli/demo.py", "cli/gen_grid.py", "cli/subset.py", "cli/analyze.py", "cli/plots.py", "cli/figures.py",
        "cli/scripts.py", "kernels/variogram.py", "kernels/exact_select.py",
    ):
        assert new in names
    assert (PORT / "csrc" / "band_resample.cu").exists() and (PORT / "csrc" / "variogram.cu").exists()
    assert len(files) >= 60
    bad = {
        str(f.relative_to(PORT.parent)): sorted(set(_imported_roots(f)) & _BANNED)
        for f in files
    }
    assert not {k: v for k, v in bad.items() if v}, bad


def test_package_data_holds_every_source_the_kernels_include():
    # a non-editable install ships csrc/ through package data: every file a
    # .cu or .cuh includes by "name" (and every source kernels/build.py
    # hashes) must match one of its globs
    import fnmatch
    import re
    import tomllib

    conf = tomllib.loads((PORT.parent / "pyproject.toml").read_text())
    globs = conf["tool"]["setuptools"]["package-data"]["auvtpu_torch"]
    sources = sorted((PORT / "csrc").glob("*.cu")) + sorted((PORT / "csrc").glob("*.cuh"))
    included = {m for f in sources for m in re.findall(r'#include\s+"([^"]+)"', f.read_text())}
    assert included >= {"halo_tile.cuh", "exact_div.cuh"}
    for name in included | {f.name for f in sources}:
        assert (PORT / "csrc" / name).exists(), name
        assert any(fnmatch.fnmatch(f"csrc/{name}", g) for g in globs), (name, globs)
