"""The practical floor for B11's memory access pattern on one NVIDIA GPU:
one random pack row a query read, one float written
(``scripts/row_gather_probe.cu``).

Run from the root of a checkout:

    python3 scripts/row_gather_probe.py

On the Grid A grid (3200x4000, chip_smoke.py's dense shelf_seamount), at
chip_smoke.py's 1M and 5M uniform Grid A queries: the valid16 pack (64-byte
rows, P=16) and the radius-2 pack (128-byte rows, P=32), each with the row's
cell read as an int32 index (mode 0) and computed from the query's (lon,
lat) by the query prologue of ``csrc/query_prologue.cuh`` (mode 1, B11's
reads exactly; mode 2, the same with each load asking L2 for its whole
128-byte line, which ``scripts/b12_variant_probe.py`` times).  Each is timed by its device duration in the profiler's
kernel records (``chip_smoke.device_ms``, back to back), beside its byte
bound at 3.35 TB/s (each input byte read once, each output written once).
Prints one line a case and one JSON line, with the card's name and power
limit.  ``chip_smoke.py`` calls :func:`floor_ms` for its B11 line.
"""

import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from auvtpu_torch.kernels import build as kbuild  # noqa: E402

SRC = os.path.join(ROOT, "scripts", "row_gather_probe.cu")
HBM_BYTES_PER_S = 3.35e12


def _lib():
    """Build (once for these sources and flags) and load the probe."""
    h = hashlib.sha256()
    for path in (SRC, os.path.join(kbuild.CSRC, "query_prologue.cuh")):
        h.update(open(path, "rb").read())
    h.update(" ".join(kbuild.NVCC_FLAGS).encode())
    out = kbuild.BUILD_DIR / f"librow_gather-{h.hexdigest()[:16]}.so"
    if not out.exists():
        kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", str(tmp), SRC], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.row_gather.argtypes = [P, I, I, P, P, P, ctypes.POINTER(ctypes.c_float), I, I, I, P, P]
    lib.row_gather.restype = I
    return lib


_LIB = []


def gather(pack, P: int, mode: int, cell, lons, lats, grid):
    """One probe launch: (n,) f32, the sum of each query's row."""
    if not _LIB:
        _LIB.append(_lib())
    n = int(lons.numel())
    out = torch.empty(n, dtype=torch.float32, device=pack.device)
    inv_lon, inv_lat = grid.inv_steps(torch.float32)
    geo = (ctypes.c_float * 6)(grid.min_lon, grid.max_lon, grid.min_lat, grid.max_lat, inv_lon, inv_lat)
    err = _LIB[0].row_gather(pack.data_ptr(), P, mode, cell.data_ptr(), lons.data_ptr(), lats.data_ptr(), geo,
                             grid.num_lon, grid.num_lat, n, out.data_ptr(),
                             torch.cuda.current_stream(pack.device).cuda_stream)
    if err:
        raise RuntimeError(f"row_gather launch failed ({err})")
    return out


def bytes_a_query(P: int, mode: int) -> int:
    return (4 if mode == 0 else 8) + 4 * P + 4


def floor_ms(cs, pack, P: int, mode: int, cell, lons, lats, grid) -> float:
    """The probe's device duration (``chip_smoke.device_ms``), after one
    check that the lon/lat mode reads the rows the index mode reads."""
    if mode:
        a = gather(pack, P, 0, cell, lons, lats, grid)
        b = gather(pack, P, mode, cell, lons, lats, grid)
        if not torch.equal(a, b):
            raise AssertionError("row_gather: the in-kernel prologue reads other rows than the torch prologue's cells")
    return cs.device_ms(lambda: gather(pack, P, mode, cell, lons, lats, grid), "row_gather_kernel")


def main() -> int:
    if not torch.cuda.is_available():
        print("row_gather_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from auvtpu_torch.config import GRID_A_EXTENT, GRID_A_SHAPE
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.kernels import scattered_select as ss
    from auvtpu_torch.ops import packs as tp
    from auvtpu_torch.synthetic import shelf_seamount

    card = cs.card_line()
    dev = torch.device("cuda", 0)
    g = RegularGrid.dense(shelf_seamount(*GRID_A_SHAPE), GRID_A_EXTENT, device=dev)
    packs = {16: tp.build_valid16_pack(g), 32: tp.build_pack(g, tp.window_offsets(2), clamp=False)[0]}
    res = {"card": card, "floors": []}
    for n, seed in ((1_000_000, 7), (5_000_000, 9)):
        lons, lats = cs.scattered_queries(GRID_A_EXTENT, *GRID_A_SHAPE, n, seed, dev)
        cell = ss.prologue(g, lons, lats)[5].to(torch.int32).contiguous()
        for P, pack in packs.items():
            for mode in (0, 1):
                t = floor_ms(cs, pack, P, mode, cell, lons, lats, g)
                b = n * bytes_a_query(P, mode) / HBM_BYTES_PER_S * 1e3
                res["floors"].append({"n": n, "row_bytes": 4 * P, "reads": ("index", "lonlat")[mode], "ms": t,
                                      "bound_ms": b})
                print(f"row gather n={n} {4 * P}-byte rows, {('index', 'lon/lat')[mode]:7s}: {t:.4f} ms, "
                      f"byte bound {b:.4f} ms ({b / t:.0%})  [{card}]", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
