"""Where the time of the port's fills goes on one NVIDIA GPU.

Run from the root of a checkout:  python3 scripts/torch_fill_profile.py

At chip_smoke.py's workloads (the Kerguelen stand-in, 10 % masked for the
kriging fill, 20 % for the IDW/mean fills and the slot-index selection; a
4096x4096 streaming mosaic):

- CUDA-event medians of the pieces of each fused path: the NaN-padded plane
  the wrappers build, each kernel (B1, B2, B3 idw and mean, B4) launched
  alone on ready inputs, and its whole wrapper; the variogram fit split into
  the empirical variogram and the Gauss-Newton loop;
- a torch.profiler table of device time by kernel over a few calls of each
  backend of fill_kriging, of fit_fill, of the Grid B IDW and Kriging
  methods at r0.20 and of a streaming window refresh, with the host-clock time per
  call beside it (their ratio is the device's busy share).

Prints the card's name and power limit beside the numbers.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time  # noqa: E402

import chip_smoke as cs  # noqa: E402
from auvtpu_torch import entry  # noqa: E402
from auvtpu_torch.config import Extent  # noqa: E402
from auvtpu_torch.kernels import window_fill as wf  # noqa: E402
from auvtpu_torch.ops import fill_kriging, kriging_at_cells  # noqa: E402
from auvtpu_torch.streaming import StreamingInterpolator  # noqa: E402
from auvtpu_torch.variogram import empirical_variogram, fit_exponential  # noqa: E402


def streaming_mosaic(dev):
    """A 4096x4096 mosaic with the demo's coverage (~17 % of cells, in
    swaths of 60 rows every 40), filled by one ingest."""
    H = W = 4096
    rng = np.random.default_rng(42)
    rows = rng.integers(0, H, 3_500_000)
    rows = rows[(rows % 40) < 30]
    cols = rng.integers(0, W, rows.shape[0])
    vals = rng.normal(-2000.0, 50.0, rows.shape[0]).astype(np.float32)
    si = StreamingInterpolator((H, W), Extent(0.0, W - 1.0, 0.0, H - 1.0), window=(256, 256),
                               max_radius=5, swath_cap=1 << 16, stage_slots=64, device=dev)
    si.ingest(rows, cols, vals)
    si.flush()
    return si


def main() -> int:
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    grid, rows, cols, truth = cs.bench_workload(dev)
    R = 10
    H, W = grid.shape
    nanp = wf._nan_padded(grid, R)
    tab = wf._device_table(R, "reference", dev)
    par = wf._par(grid, None, "reference", 0, 0, None, dev)
    out = torch.empty((H, W), device=dev)
    sel_out = torch.empty((13, H, W), device=dev)
    lib = wf._lib()
    stream = wf._stream(dev)

    def b1_kernel():
        lib.auvtpu_kriging_fill(nanp.data_ptr(), tab.data_ptr(), tab.shape[0], H, W, R,
                                par.data_ptr(), 0, 0, 0, out.data_ptr(), stream)

    def b2_kernel():
        lib.auvtpu_topk_full(nanp.data_ptr(), tab.data_ptr(), tab.shape[0], H, W, R, 4,
                             sel_out.data_ptr(), stream)

    grid2, rows2, cols2, _ = cs.bench_workload(dev, 0.20)
    nanp2 = wf._nan_padded(grid2, R)
    wtab = wf._device_weights(R, 2.0, "reference", dev)
    idx_out = torch.empty((5, H, W), device=dev)

    def b3_kernel(kind, k):
        lib.auvtpu_fill(nanp2.data_ptr(), tab.data_ptr(), wtab.data_ptr(), tab.shape[0], H, W, R,
                        kind, k, 1e-12, out.data_ptr(), stream)

    def b4_kernel():
        lib.auvtpu_topk_idx(nanp2.data_ptr(), tab.data_ptr(), tab.shape[0], H, W, R, 4,
                            idx_out.data_ptr(), stream)

    lags, gamma, counts = empirical_variogram(grid)
    step = 0.5 * (abs(grid.lat_step) + abs(grid.lon_step))
    pieces = {
        "NaN-padded plane (wrapper)": lambda: wf._nan_padded(grid, R),
        "B1 kernel alone": b1_kernel,
        "B1 wrapper (fused fill)": lambda: wf.fill_kriging_fused(grid),
        "B2 kernel alone": b2_kernel,
        "B2 wrapper": lambda: wf.topk_full(grid),
        "B3 idw k=8 kernel alone": lambda: b3_kernel(0, 8),
        "B3 idw k=8 wrapper": lambda: wf.fill_idw_fused(grid2, k=8),
        "B3 mean k=4 kernel alone": lambda: b3_kernel(1, 4),
        "B3 mean k=4 wrapper": lambda: wf.fill_mean_fused(grid2, k=4),
        "B4 k=4 kernel alone": b4_kernel,
        "B4 k=4 wrapper": lambda: wf.topk_idx(grid2, k=4),
        "empirical variogram": lambda: empirical_variogram(grid),
        "Gauss-Newton fit (25 it)": lambda: fit_exponential(lags * step, gamma, counts, iters=25),
    }
    for label, fn in pieces.items():
        print(f"{label:28s} {cs.time_ms(fn):9.4f} ms  [{card}]")

    si = streaming_mosaic(dev)
    flat2 = rows2 * W + cols2

    def refresh():
        tile, _ = si.window_fill(2048, 2048)
        return tile.cpu()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, fn, reps in (
        ("fused", lambda: fill_kriging(grid, backend="fused"), 3),
        ("select", lambda: fill_kriging(grid, backend="select"), 3),
        ("torch", lambda: fill_kriging(grid, backend="torch"), 3),
        ("fit_fill", lambda: entry.fit_fill(grid), 3),
        ("Grid B IDW r0.20 (B3 + gather)", lambda: wf.fill_idw_fused(grid2, k=8).reshape(-1)[flat2], 3),
        ("Grid B Kriging r0.20 (B1 + gather)", lambda: kriging_at_cells(grid2, rows2, cols2), 3),
        ("window refresh 256x256 idw, result on the host", refresh, 20),
    ):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        # kernel rows only: an aten op row repeats its kernels' device time
        dev_total = sum(
            e.self_device_time_total for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
        ) / (reps * 1e3)
        print(f"\n== {label}: device time {dev_total:.4f} ms per call (profiler, {reps} calls), "
              f"host clock {wall:.4f} ms per call (unprofiled) [{card}]")
        print(ka.table(sort_by="self_device_time_total", row_limit=8, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
