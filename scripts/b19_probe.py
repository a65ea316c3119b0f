"""B19 (``kriging_cells_kernel``: kriging at a list of cells) against B1's
whole plane and a gather, on one NVIDIA GPU, in one process: the sweep over
the traffic callers send, B1 against another version of its source, and
B19's rejected designs.

Run from the root of a checkout:

    python3 scripts/b19_probe.py [--parent DIR] [--variants] [--reps N]

The inputs are chip_smoke.py's: the Kerguelen stand-in (2053x2441) masked
with seed 42, radius 10, exponential, gj.

- **Sweep**, what every caller of ``ops.dense.kriging_at_cells`` sends: the
  tile masked at 5, 10, 20, 30, 50, 70 and 90 % removal, its masked cells
  listed (in the mask's order).  For each: B19 bit-equal to B1's plane at
  the cells (it stops otherwise); B19 alone (the device duration of its
  kernel in the profiler's records, ``chip_smoke.device_ms``); the
  device-busy time of one ``kriging_at_cells_fused`` call and of B1's plane
  and the gather (``fill_kriging_fused`` then ``ops.dense.plane_at_cells``,
  the plane-then-gather form), by ``chip_smoke.device_busy_ms``; and the
  wall time a call of each when 50 calls are dispatched back to back and
  then synchronised (whichever of host and card sets the pace).  The
  crossover is the first removal at which B19's call takes at least the
  plane and the gather's device-busy time.
- **B1** (with ``--parent DIR``, a version unpacked by ``git archive
  <commit> auvtpu_torch/csrc | tar -x -C DIR`` into a directory .gitignore
  lists): B1 alone from DIR's ``window_fill.cu`` and this checkout's, in
  the order other, this, this, other, and whether the static SASS of their
  ``kriging_fill_kernel`` builds is the same (``scripts/sass_tools.py``).
- **Variants** (``--variants``): copies of ``csrc/window_fill.cu`` patched
  as text (the probe stops if a patch no longer matches): ``batch8`` and
  ``batch16`` (table rows a batch of the scan; the checkout: 4),
  ``threads128`` (blocks of 128 threads; the checkout: 256) and
  ``both_loads`` (the scan reads each row's validity and elevation
  together and keeps the found values; the checkout: validity alone, the
  four found elevations after).  Each bit-equal to the
  checkout's B19, then timed alone at the mask's cells and at 100 %.

Every library is built with the checkout's nvcc flags, all at once.
Prints a line a reading and one JSON line (also written to ``--out``,
by default ``results_local/b19_probe.json``), with the card's name and
power limit.
"""

import argparse
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from auvtpu_torch.kernels import build as kbuild  # noqa: E402
from auvtpu_torch.kernels import window_fill as wf  # noqa: E402
from auvtpu_torch.ops.dense import plane_at_cells  # noqa: E402

REMOVALS = (0.05, 0.10, 0.20, 0.30, 0.50, 0.70, 0.90)
VALUES_AFTER = """  int cnt = scan_cell<false>(elev, pe, valid, pv, ctab, m, H, W, r, c, slots, vz);
  bool nan_value = false;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (s < cnt) {
      const int2 o = ctab[(slots >> (16 * s)) & 0xffffu];
      vz[s] = __ldg(elev + (size_t)(r + o.y) * pe + (c + o.x));
      nan_value = nan_value || isnan(vz[s]);
    }
  }
  if (nan_value) cnt = scan_cell<true>(elev, pe, valid, pv, ctab, m, H, W, r, c, slots, vz);
"""
BOTH_LOADS = """  const int cnt = scan_cell<true>(elev, pe, valid, pv, ctab, m, H, W, r, c, slots, vz);
"""
PATCHES = {
    "both_loads": [(VALUES_AFTER, BOTH_LOADS)],
    "batch8": [("constexpr int CB = 4;", "constexpr int CB = 8;")],
    "batch16": [("constexpr int CB = 4;", "constexpr int CB = 16;")],
    "threads128": [("constexpr int CT = 256;", "constexpr int CT = 128;")],
}


def say(msg: str) -> None:
    print(f"[b19] {msg}", flush=True)


def patched(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"b19_probe: {old!r} is {src.count(old)} times in window_fill.cu, want 1")
        src = src.replace(old, new)
    return src


def build_all(parent: str | None, variants: bool) -> dict:
    """{name: library path}: the checkout's build, each variant's and the
    parent's, every nvcc started at once."""
    src = (kbuild.CSRC / "window_fill.cu").read_text()
    h = hashlib.sha256(src.encode())
    out_dir = kbuild.BUILD_DIR / f"b19_probe-{h.hexdigest()[:12]}"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    if variants:
        for name, edits in PATCHES.items():
            csrc = out_dir / name
            shutil.copytree(kbuild.CSRC, csrc, dirs_exist_ok=True)
            (csrc / "window_fill.cu").write_text(patched(src, edits))
            jobs[name] = csrc / "window_fill.cu"
    if parent:
        jobs["parent"] = os.path.join(parent, "auvtpu_torch", "csrc", "window_fill.cu")
    procs = {}
    for name, cu in jobs.items():
        lib = out_dir / f"libwindow_fill_{name}.so"
        cmd = [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths = {"this": kbuild.build("window_fill")}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed building {name}:\n{log}")
        paths[name] = lib
    return paths


def load(path):
    real = wf._lib()
    lib = ctypes.CDLL(str(path))
    for fn in ("auvtpu_kriging_fill", "auvtpu_kriging_cells"):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
            getattr(lib, fn).restype = getattr(real, fn).restype
    return lib


def wall_ms(fn, calls: int = 50) -> float:
    """Wall ms a call of ``fn`` with ``calls`` dispatched back to back and
    then synchronised (the median of three such runs)."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3 / calls)
    return sorted(runs)[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another version's checkout root (its auvtpu_torch/csrc)")
    ap.add_argument("--variants", action="store_true", help="time B19's rejected designs")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default=os.path.join(ROOT, "results_local", "b19_probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b19_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = cs.card_line()
    dev = torch.device("cuda")
    paths = build_all(args.parent, args.variants)
    libs = {name: load(p) for name, p in paths.items()}
    grid, rows, cols, _ = cs.bench_workload(dev)
    H, W = grid.shape
    out = {"card": card, "shape": [H, W], "masked": rows.numel()}
    say(f"{H}x{W} stand-in, {rows.numel()} masked cells; libraries {sorted(paths)}  [{card}]")

    plane = wf.fill_kriging_fused(grid)
    every = torch.randperm(H * W, generator=torch.Generator().manual_seed(11)).to(dev)
    cases = {"mask": (rows, cols), "100%": (every // W, every % W)}  # the variants' cells

    sweep = {}
    for removal in REMOVALS:
        name = f"r{removal:.2f}"
        g, r, c, _ = cs.bench_workload(dev, removal)
        want = plane_at_cells(wf.fill_kriging_fused(g), r, c)
        cs.same_planes(wf.kriging_at_cells_fused(g, r, c), want, f"B19 vs B1, {name}")
        row = {
            "cells": r.numel(),
            "b19_alone_ms": cs.device_ms(cs.b19_launcher(g, r, c), "kriging_cells_kernel", reps=args.reps),
            "b19_busy_ms": cs.device_busy_ms(lambda: wf.kriging_at_cells_fused(g, r, c), reps=5),
            "dense_busy_ms": cs.device_busy_ms(lambda: plane_at_cells(wf.fill_kriging_fused(g), r, c), reps=5),
            "b19_wall_ms": wall_ms(lambda: wf.kriging_at_cells_fused(g, r, c)),
            "dense_wall_ms": wall_ms(lambda: plane_at_cells(wf.fill_kriging_fused(g), r, c)),
        }
        sweep[name] = row
        say(f"{name} {row['cells']:8d} masked cells: B19 alone {row['b19_alone_ms']:.4f} ms, call busy "
            f"{row['b19_busy_ms']:.4f}, wall {row['b19_wall_ms']:.4f}; B1 + gather busy {row['dense_busy_ms']:.4f}, "
            f"wall {row['dense_wall_ms']:.4f}  [{card}]")
        del g, r, c, want
    out["sweep"] = sweep
    cross = next((k for k, row in sweep.items() if row["b19_busy_ms"] >= row["dense_busy_ms"]), None)
    out["crossover"] = cross
    say(f"crossover (B19's call busy >= B1 + gather): {cross or 'none up to 90 % removal'}")

    b1 = {}
    for name in ("parent", "this", "this", "parent") if "parent" in libs else ("this",):
        t = cs.device_ms(cs.b1_launcher(grid, lib=libs[name]), "kriging_fill_kernel", reps=args.reps)
        b1.setdefault(name, []).append(t)
        say(f"B1 alone, {name}: {t:.4f} ms  [{card}]")
    out["b1_alone_ms"] = b1
    if "parent" in libs:
        sass = cs.load_script("sass_tools")
        fp = {n: sass.sass_digest(sass.sass_fingerprint(paths[n], "kriging_fill_kernel")) for n in ("this", "parent")}
        out["b1_sass"] = fp
        ratio = sum(b1["this"]) / sum(b1["parent"])
        say(f"B1 this / parent {ratio:.4f}; SASS this {fp['this']}, parent {fp['parent']}: "
            + ("the same" if fp["this"] == fp["parent"] else "differ"))

    var = {}
    for name in ["this"] + [n for n in PATCHES if n in libs] + (["this"] if len(libs) > 2 else []):
        for case in ("mask", "100%"):
            r, c = cases[case]
            launch = cs.b19_launcher(grid, r, c, lib=libs[name])
            launch()
            if name != "this":
                cs.same_planes(launch.out, wf.kriging_at_cells_fused(grid, r, c), f"variant {name} vs B19, {case}")
            t = cs.device_ms(launch, "kriging_cells_kernel", reps=args.reps)
            var.setdefault(name, {}).setdefault(case, []).append(t)
            say(f"variant {name:17s} {case:5s}: alone {t:.4f} ms  [{card}]")
    out["variants"] = var
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
