"""The port's multi-process path (``auvtpu_torch.parallel.multihost``): two
processes join one gloo group through ``initialize()`` from torchrun's
environment variables and run the distributed fit+fill on the CPU.

Held three ways: the two ranks print the same ``MH`` line; against one
process, the same parameters and the same plane (its f64 nansum), bit for
bit (the bands' float64 pair sums, added and rounded once, are one
process's sums); against ``auvtpu.parallel.sharded_fit_fill`` on two
virtual devices (whose bands' float32 sums reassociate), gamma at the bin
lags at rtol 1e-3 (tests/test_torch_variogram.py) and the nansum at rtol
1e-4 (tests/test_multihost.py's bar).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from auvtpu_torch.config import Extent
from auvtpu_torch.grid import RegularGrid
from auvtpu_torch.masking import mask_grid
from auvtpu_torch.parallel.multihost import fit_fill_multihost, initialize
from auvtpu_torch.synthetic import shelf_seamount

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 40
LAG = dict(max_lag=5, n_bins=5)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _elev():
    elev, _, _ = mask_grid(shelf_seamount(H, W), 0.2, seed=7)
    return elev, Extent(0.0, float(W - 1), 0.0, float(H - 1))


@pytest.fixture(scope="module")
def two_ranks():
    """(the MH numbers, the transport line) of each of two torchrun-style
    processes."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, "-m", "auvtpu_torch.parallel.multihost", "--device", "cpu"],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=REPO, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=90)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
        assert p.returncode == 0, f"rank failed:\nSTDOUT:{out}\nSTDERR:{err[-3000:]}"
        mh = [ln for ln in out.splitlines() if ln.startswith("MH ")]
        assert mh, f"no MH line in {out!r}"
        outs.append(([float(v) for v in mh[-1].split()[1:]], [ln for ln in out.splitlines() if "transport" in ln]))
    return outs


def _gamma(params):
    from auvtpu_torch.variogram import _bin_table, variogram_model

    return variogram_model(torch.from_numpy(_bin_table(**LAG)[3]), tuple(float(p) for p in params)).numpy()


def test_both_ranks_print_the_same_line_over_gloo(two_ranks):
    (a, ta), (b, tb) = two_ranks
    assert a == b
    assert ta == ["rank 0 on cpu, transport gloo"] and tb == ["rank 1 on cpu, transport gloo"]


def test_one_process_initialize_is_a_no_op(monkeypatch):
    for key in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    assert initialize() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    assert initialize() is False


def test_launch_and_initialize_pick_the_transport_by_one_rule(monkeypatch):
    from auvtpu_torch.parallel import launch, mesh, multihost

    assert launch.transport_for is mesh.transport_for is multihost.transport_for
    for cards, want in ((0, "gloo"), (1, "gloo"), (2, "nccl"), (4, "nccl")):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        assert mesh.transport_for("cuda", 2) == want
        assert mesh.transport_for(None, 2) == want
        # a device with an index, or the CPU, puts every rank on one device
        assert mesh.transport_for("cuda:0", 2) == "gloo"
        assert mesh.transport_for("cpu", 2) == "gloo"
    # initialize reads the machine's rank count from torchrun's LOCAL_WORLD_SIZE
    seen = []
    monkeypatch.setattr(multihost.dist, "init_process_group", lambda backend, **kw: seen.append(backend))
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "0")
    for local, want in (("2", "nccl"), ("8", "gloo")):
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
        assert initialize() is True and seen[-1] == want
    assert initialize("cpu") is True and seen[-1] == "gloo"


def test_two_processes_against_one_process(two_ranks):
    from auvtpu_torch.ops import fill_kriging

    got = two_ranks[0][0]
    elev, ext = _elev()
    plane, vp = fit_fill_multihost(elev, ext, max_radius=5, device="cpu", **LAG)
    # the bands' float64 pair sums, added and rounded once, are one
    # process's: the same fit, and (the printed parameters are float32
    # exactly, 9 digits) the same plane
    np.testing.assert_array_equal(np.float32(got[:3]), np.float32([float(v) for v in vp]))
    # one process holds the whole plane as its one band
    assert plane.to_local().shape == plane.shape == (H, W)
    assert got[3] == float(torch.nansum(plane.full_tensor().double()))
    g = RegularGrid.from_nan_array(elev, ext, device="cpu")
    aligned = fill_kriging(g, max_radius=5, vparams=tuple(torch.tensor(v, dtype=torch.float32) for v in got[:3]))
    assert float(torch.nansum(aligned.double())) == got[3]


def test_two_processes_match_jax_sharded_fit_fill(two_ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from auvtpu.config import Extent as JExtent
    from auvtpu.grid import RegularGrid as JGrid
    from auvtpu.masking import mask_grid as j_mask_grid
    from auvtpu.parallel.spatial import sharded_fit_fill as j_sharded_fit_fill
    from auvtpu.synthetic import shelf_seamount as j_shelf

    got = two_ranks[0][0]
    elev, _, _ = j_mask_grid(j_shelf(H, W), 0.2, seed=7)
    jg = JGrid.from_nan_array(elev, JExtent(0.0, float(W - 1), 0.0, float(H - 1)))
    plane, vp = j_sharded_fit_fill(Mesh(np.asarray(jax.devices()[:2]), ("dp",)), jg, max_radius=5, **LAG)
    np.testing.assert_allclose(_gamma(got[:3]), _gamma(vp), rtol=1e-3)
    assert got[3] == pytest.approx(float(jnp.nansum(plane)), rel=1e-4)
