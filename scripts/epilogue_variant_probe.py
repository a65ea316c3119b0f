"""Exact mode's epilogues, B17 (``krige_kernel``) and B18
(``patch_kernel``), in the candidate designs, each held bit-equal to its
plain version and timed alone, in one process on one NVIDIA GPU.

Run from the root of a checkout:

    python3 scripts/epilogue_variant_probe.py [--parent DIR]

The designs:

- ``this``: the checkout's ``csrc/exact_epilogue.cu``, timed first and last;
- ``krige_ieee``: B17 with every quotient an IEEE division (no shared
  reciprocal);
- ``krige_branch``: each quotient outside the guard an IEEE division in
  place (the checkout: the whole solve again with IEEE divisions where any
  quotient left the guard);
- ``scalar_operands``: the (n, 4) operands read as four scalar loads (the
  checkout: 16-byte vectors where aligned);
- ``krige_threads128``, ``krige_128x7``: B17 in blocks of 128 threads (the
  checkout: 256), the second with ``__launch_bounds__``' minimum of 7
  resident blocks an SM; ``krige_min4``: 256 threads, a minimum of 4 (each
  minimum caps the registers);
- ``scalar_rows``: B18's patch rows as four scalar loads (the checkout: two
  16-byte (f64) or 8-byte (f32) pairs where the row is unclamped and the
  plane aligned, or a scalar, a pair and a scalar);
- ``bilinear_pairs``: a row's two bilinear corners as one pair where they
  are adjacent and the pair aligned (the checkout: scalar loads);
- ``index32``: the cubic's patch in int32 flat indices (the checkout:
  int64; the probe's planes have fewer than 2**31 cells);
- ``centre4_first``, ``anchor_first``: the cubic at cells tests the four
  centre cells together first, or the anchor's cell (the checkout: the
  centre cell nearest the query's coordinate, then the sixteen);
- ``scattered_interleaved``: the scattered cubic reads each row's validity
  and values together (the checkout: the validity rows, then the values);
- ``rows_all``: the validity of all four patch rows read (the checkout:
  no row after the first that holds an invalid cell);
- ``parent`` (with ``--parent DIR``, a version unpacked with ``git archive
  <commit> auvtpu_torch/csrc | tar -x -C DIR`` with the same C interface,
  e.g. commit 7ba201d's): every quotient an IEEE division, the cubic at
  cells gathering its whole patch and running both passes for every
  query, scalar loads.

Each variant is a copy of ``csrc/`` with ``exact_epilogue.cu`` patched as
text (the probe stops if a patch no longer matches the source), built with
the checkout's nvcc flags, all builds at once, one nvcc each.  The inputs
are chip_smoke.py's phase 19: the f64 stand-in (2053x2441, 10 % masked with
seed 42: 501,137 query cells), its strict selection at the round anchor
(B17) and floor anchors (B18 at cells), as many valid cells (B18's whole
patches), 1e5 stand-in queries with NaN, ±inf and out-of-grid ones (B18
scattered, and B17's fallback mean of those whose patch is not whole) and
1e5 Grid A queries (B18 scattered).  For each variant and case: the
outputs against the plain version's, bit for bit (it stops otherwise); the
device duration of one call's kernel in the profiler's records
(``chip_smoke.device_ms``, back to back; NaN where the tracer kept none)
and the CUDA-event time of 50 launches back to back, a launch (the two
agree where the tracer keeps its records); each build's registers, local
bytes and resident blocks an SM; and the static count of FP64-pipe
instructions in B17's f64 builds (``scripts/sass_tools.py``).  Prints one
line a case and one JSON line, with the card's name and power limit.
"""

import argparse
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from auvtpu_torch.kernels import build as kbuild  # noqa: E402
from auvtpu_torch.kernels import exact_epilogue as ee  # noqa: E402

REDO = """    res = krige_one<true>(p, m, v, exact);
    if (!exact) res = krige_one<false>(p, m, v, exact);
"""
GUARD = """    exact = exact && d.ok && (exponent_of(a) - 123u <= 1800u || zero);
    return zero ? q0 : q;
"""
GUARD_BRANCH = """    if (d.ok && exponent_of(a) - 123u <= 1800u) return q;
    if (d.ok && zero) return q0;
    return a / d.d;
"""
NEAREST_FIRST = """  const bool right = tx >= 0.5, up = p.y[n] - (double)yi >= 0.5;
  const bool whole = is_valid(__ldg(p.valid + ((up ? rows[2] : rows[1]) + (right ? ii[2] : ii[1])))) &&
                     patch_whole(p.valid, rows, ii);
"""
CENTRE_FOUR = """  const T c0 = __ldg(p.valid + (rows[1] + ii[1])), c1 = __ldg(p.valid + (rows[1] + ii[2]));
  const T c2 = __ldg(p.valid + (rows[2] + ii[1])), c3 = __ldg(p.valid + (rows[2] + ii[2]));
  const bool whole = is_valid(c0) && is_valid(c1) && is_valid(c2) && is_valid(c3) && patch_whole(p.valid, rows, ii);
"""
ANCHOR_FIRST = """  const bool whole = is_valid(__ldg(p.valid + (rows[1] + ii[1]))) && patch_whole(p.valid, rows, ii);
"""
PHASED = """  whole = patch_whole(p.valid, rows, ii);
  return smooth_of<T, T>(p, n, rows, ii, p.x[n] - (double)xi);
"""
INTERLEAVED = """  const double tx = p.x[n] - (double)xi;
  whole = true;
  double col[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    T v[4], q[4];
    row4(p.valid, rows[r], ii, v);
    row4(p.elev, rows[r], ii, q);
    whole = whole && is_valid(v[0]) && is_valid(v[1]) && is_valid(v[2]) && is_valid(v[3]);
    col[r] = catmull_rom<T>(q[0], q[1], q[2], q[3], tx);
  }
  return catmull_rom<double>(col[0], col[1], col[2], col[3], p.y[n] - (double)yi);
"""
ROWS_STOP = """    if (whole) {
      T v[4];
      row4(valid, rows[r], ii, v);
      whole = is_valid(v[0]) && is_valid(v[1]) && is_valid(v[2]) && is_valid(v[3]);
    }
"""
ROWS_ALL = """    T v[4];
    row4(valid, rows[r], ii, v);
    whole = whole && is_valid(v[0]) && is_valid(v[1]) && is_valid(v[2]) && is_valid(v[3]);
"""
BILINEAR_SCALARS = """  bool m[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) m[a] = is_valid(__ldg(p.valid + idx[a]));
  Z z[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) z[a] = m[a] ? (Z)__ldg(p.elev + idx[a]) : (Z)0;
"""
BILINEAR_PAIRS = """  T c[4];
  corners2(p.valid, idx[0], idx[1], true, true, c[0], c[1]);
  corners2(p.valid, idx[2], idx[3], true, true, c[2], c[3]);
  bool m[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) m[a] = is_valid(c[a]);
  corners2(p.elev, idx[0], idx[1], m[0], m[1], c[0], c[1]);
  corners2(p.elev, idx[2], idx[3], m[2], m[3], c[2], c[3]);
  Z z[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) z[a] = m[a] ? (Z)c[a] : (Z)0;
"""
BILINEAR_HEAD = "template <typename T, bool CELLS>\n__device__ double bilinear_one("
CORNERS2 = """// a row's two bilinear corners i0 and i1: one pair where they are adjacent
// (the corner is not clamped), i0 even and the plane aligned to a pair,
// else two scalars, each only where `want`
template <typename T>
__device__ __forceinline__ void corners2(const T* p, long long i0, long long i1, bool want0, bool want1, T& a, T& b) {
  if (i1 == i0 + 1 && (i0 & 1) == 0 && pair_aligned(p)) {
    const Pair<T> v = __ldg(reinterpret_cast<const Pair<T>*>(p + i0));
    a = v.x, b = v.y;
  } else {
    a = want0 ? __ldg(p + i0) : (T)0;
    b = want1 ? __ldg(p + i1) : (T)0;
  }
}

"""
PATCHES = {
    # B17
    "krige_ieee": [(REDO, "    res = krige_one<false>(p, m, v, exact);\n")],
    "krige_branch": [(GUARD, GUARD_BRANCH), (REDO, "    res = krige_one<true>(p, m, v, exact);\n")],
    "scalar_operands": [("return ((uintptr_t)p & 15) == 0;", "return false;")],
    "krige_threads128": [("constexpr int kKrigeThreads = 256;", "constexpr int kKrigeThreads = 128;")],
    "krige_128x7": [("constexpr int kKrigeThreads = 256;", "constexpr int kKrigeThreads = 128;"),
                    ("__launch_bounds__(kKrigeThreads) krige_kernel(",
                     "__launch_bounds__(kKrigeThreads, 7) krige_kernel(")],
    "krige_min4": [("__launch_bounds__(kKrigeThreads) krige_kernel(", "__launch_bounds__(kKrigeThreads, 4) krige_kernel(")],
    # B18
    "scalar_rows": [("if (ii[3] == ii[0] + 3 && pair_aligned(p)) {", "if (false) {")],
    "bilinear_pairs": [(BILINEAR_SCALARS, BILINEAR_PAIRS), (BILINEAR_HEAD, CORNERS2 + BILINEAR_HEAD)],
    "index32": [("using Flat = long long;", "using Flat = int;")],
    "centre4_first": [(NEAREST_FIRST, CENTRE_FOUR)],
    "anchor_first": [(NEAREST_FIRST, ANCHOR_FIRST)],
    "scattered_interleaved": [(PHASED, INTERLEAVED)],
    "rows_all": [(ROWS_STOP, ROWS_ALL)],
}
# the FP64-pipe instructions counted in B17's SASS
B17_F64_BUILDS = ("krige_kernel<double, int, false>", "krige_kernel<double, long, false>")


def patched(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"epilogue_variant_probe: {old!r} is {src.count(old)} times in exact_epilogue.cu, "
                                 f"want 1")
        src = src.replace(old, new)
    return src


def build_variants(parent: str | None) -> dict:
    """{name: (library path, build log)} of every variant (the checkout's
    own build included), every nvcc started at once."""
    src = (kbuild.CSRC / "exact_epilogue.cu").read_text()
    parent_src = open(os.path.join(parent, "auvtpu_torch", "csrc", "exact_epilogue.cu")).read() if parent else None
    h = hashlib.sha256((src + (parent_src or "")).encode())
    out_dir = kbuild.BUILD_DIR / f"epilogue_variants-{h.hexdigest()[:12]}"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {name: patched(src, edits) for name, edits in PATCHES.items()}
    if parent:
        sources["parent"] = parent_src
    procs, paths = {}, {}
    this = kbuild.build("exact_epilogue")
    paths["this"] = (this, this.with_suffix(".log").read_text())
    for name, text in sources.items():
        csrc = out_dir / name
        shutil.copytree(kbuild.CSRC, csrc, dirs_exist_ok=True)
        (csrc / "exact_epilogue.cu").write_text(text)
        lib = out_dir / f"libexact_epilogue_{name}.so"
        cmd = [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", str(lib), str(csrc / "exact_epilogue.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed building variant {name}:\n{log}")
        paths[name] = (lib, log)
    return paths


def load(path, real):
    lib = ctypes.CDLL(str(path))
    for fn in ("auvtpu_exact_krige", "auvtpu_exact_patch", "auvtpu_exact_epilogue_attributes"):
        getattr(lib, fn).argtypes = getattr(real, fn).argtypes
        getattr(lib, fn).restype = getattr(real, fn).restype
    return lib


def ptr(t):
    return t.data_ptr() if t is not None else None


def launchers(lib, cases_in: dict) -> dict:
    """{case: (launch, outputs)}: each case's launch straight through the
    library into outputs allocated once."""
    st = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    out = {}
    for case, (kind, args) in cases_in.items():
        if kind == "krige":
            found, sel_val, gi, gj, lon, lat, scal = args
            n = found.shape[0]
            res = torch.empty(n, dtype=torch.float64, device=found.device)
            head = (int(sel_val.dtype == torch.float64), int(gi.dtype == torch.int64), 0, n, ptr(found),
                    ptr(sel_val), ptr(gi), ptr(gj), ptr(lon), ptr(lat), *scal, None, ptr(res))

            def launch(head=head):
                if lib.auvtpu_exact_krige(*head, st):
                    raise RuntimeError("B17 launch failed")
            out[case] = (launch, res)
        elif kind == "mean":
            found, sel_val, idx, base = args
            res = base.clone()
            head = (int(sel_val.dtype == torch.float64), 0, 1, found.shape[0], ptr(found), ptr(sel_val), None, None,
                    None, None, *([0.0] * 8), ptr(idx), ptr(res))

            def launch(head=head):
                if lib.auvtpu_exact_krige(*head, st):
                    raise RuntimeError("B17 mean launch failed")
            out[case] = (launch, res)
        else:
            g, kind_, cells, ci, cj, x, y, found, sel_val, oob = args
            H, W = g.shape
            n = ci.shape[0]
            res = torch.empty(n, dtype=torch.float64, device=ci.device)
            need = torch.empty(n, dtype=torch.bool, device=ci.device) if kind_ == 1 and not cells else None
            head = (int(g.elev.dtype == torch.float64), kind_, int(cells), H, W, n, ptr(g.elev), ptr(g.valid),
                    ptr(ci), ptr(cj), ptr(x), ptr(y), ptr(found), ptr(sel_val), ptr(oob), ptr(res), ptr(need))

            def launch(head=head):
                if lib.auvtpu_exact_patch(*head, st):
                    raise RuntimeError("B18 launch failed")
            out[case] = (launch, (res, need) if need is not None else res)
    return out


def events_ms(launch, calls: int = 50, reps: int = 7) -> float:
    """Median over ``reps`` of the CUDA-event time of ``calls`` launches
    back to back, a launch: the device time where a launch outlasts the
    host's ctypes call (B17's MEAN build does not)."""
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            launch()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a version unpacked with git archive, with this checkout's C interface")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("epilogue_variant_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from auvtpu_torch.config import GRID_A_EXTENT, GRID_A_SHAPE, KERGUELEN_EXTENT
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.kernels.exact_prologue import GEO, GRID, KEYS
    from auvtpu_torch.masking import mask_grid
    from auvtpu_torch.ops import exact as texact
    from auvtpu_torch.synthetic import kerguelen_standin, shelf_seamount

    sass = cs.load_script("sass_tools")
    card = cs.card_line()
    paths = build_variants(args.parent)
    real = ee._lib()
    dev = torch.device("cuda", 0)
    reduced, rc, _ = mask_grid(kerguelen_standin(cs.SHAPE), cs.REMOVAL)
    g = RegularGrid.from_nan_array(reduced, KERGUELEN_EXTENT, dtype=torch.float64, device=dev)
    rows, cols = (torch.as_tensor(rc[:, i].astype(np.int64), device=dev) for i in (0, 1))
    # as many valid cells, drawn with a seed: B18's whole patches
    vr, vc = np.nonzero(~np.isnan(reduced))
    pick = np.random.default_rng(25).choice(len(vr), len(rc), replace=False)
    vrows, vcols = (torch.as_tensor(a[pick].astype(np.int64), device=dev) for a in (vr, vc))
    q_r = texact.query_tensors(g, rows, cols, anchor="round", fields=KEYS | GEO)
    sel_r = texact._select_cells(g, q_r, None, 10, 16384)
    scal = ee.scalars_of(g)
    q_f = texact.query_tensors(g, rows, cols, anchor="floor", fields=KEYS | GRID)
    sel_f = texact._select_cells(g, q_f, None, 10, 16384)
    q_v = texact.query_tensors(g, vrows, vcols, anchor="floor", fields=KEYS | GRID)
    sel_v = texact._select_cells(g, q_v, None, 10, 16384)
    lo_k, la_k = (t.cpu().numpy().astype(np.float64) for t in cs.scattered_queries(KERGUELEN_EXTENT, *cs.SHAPE,
                                                                                    100_000, 24, dev))
    lo_k[::13], la_k[::17], lo_k[::29], la_k[::31] = np.nan, np.inf, -np.inf, np.nan
    lo_k[5::41] = KERGUELEN_EXTENT.max_lon + 1e-3
    q_s = texact.scattered_tensors(g, torch.as_tensor(lo_k, device=dev), torch.as_tensor(la_k, device=dev), "floor")
    need_s = ee.patch_ref(g.elev, g.valid, q_s.ci, q_s.cj, q_s.x, q_s.y, None, None, q_s.oob, 1, False, 16384)[1]
    idx_s = torch.nonzero(need_s)[:, 0]
    sel_s = texact._select_scattered(g, *(a[idx_s] for a in (q_s.ci, q_s.cj, q_s.x, q_s.y)), 10, 16384)
    base_s = torch.zeros(len(lo_k), dtype=torch.float64, device=dev)
    gA = RegularGrid.from_nan_array(shelf_seamount(*GRID_A_SHAPE), GRID_A_EXTENT, dtype=torch.float64, device=dev)
    lo_a, la_a = cs.scattered_queries(GRID_A_EXTENT, GRID_A_SHAPE[0], GRID_A_SHAPE[1], 100_000, 19, dev)
    q_a = texact.scattered_tensors(gA, lo_a.double(), la_a.double(), "floor")
    gi64, gj64 = (t.long() for t in sel_r[2:])
    cases_in = {
        "B17 solve, stand-in cells": ("krige", (*sel_r, q_r.qlon, q_r.qlat, scal)),
        "B17 solve, int64 cells": ("krige", (*sel_r[:2], gi64, gj64, q_r.qlon, q_r.qlat, scal)),
        "B17 mean, stand-in scattered": ("mean", (*sel_s[:2], idx_s, base_s)),
        "B18 cubic cells, masked": ("patch", (g, 1, True, q_f.ci, q_f.cj, q_f.x, q_f.y, *sel_f[:2], None)),
        "B18 cubic cells, valid": ("patch", (g, 1, True, q_v.ci, q_v.cj, q_v.x, q_v.y, *sel_v[:2], None)),
        "B18 bilinear cells, masked": ("patch", (g, 0, True, q_f.ci, q_f.cj, q_f.x, q_f.y, None, None, None)),
        "B18 bilinear cells, valid": ("patch", (g, 0, True, q_v.ci, q_v.cj, q_v.x, q_v.y, None, None, None)),
        "B18 cubic scattered, stand-in": ("patch", (g, 1, False, q_s.ci, q_s.cj, q_s.x, q_s.y, None, None, q_s.oob)),
        "B18 bilinear scattered, stand-in": ("patch", (g, 0, False, q_s.ci, q_s.cj, q_s.x, q_s.y, None, None, None)),
        "B18 cubic scattered, Grid A": ("patch", (gA, 1, False, q_a.ci, q_a.cj, q_a.x, q_a.y, None, None, q_a.oob)),
        "B18 bilinear scattered, Grid A": ("patch", (gA, 0, False, q_a.ci, q_a.cj, q_a.x, q_a.y, None, None, None)),
    }
    want = {}
    for case, (kind, a) in cases_in.items():
        if kind == "krige":
            want[case] = ee.krige_ref(*a)
        elif kind == "mean":
            w = a[3].clone()
            ee.mean_into_ref(a[0], a[1], a[2], w)
            want[case] = w
        else:
            gg, kind_, cells, *ops = a
            r, need = ee.patch_ref(gg.elev, gg.valid, *ops, kind_, cells, 16384)
            want[case] = (r, need) if kind_ == 1 and not cells else r
    whole = int(ee.cubic_smooth_ref(g.elev, g.valid, q_v.ci, q_v.cj, q_v.x, q_v.y)[1].sum())
    print(f"stand-in: {len(rc)} masked and {len(pick)} valid query cells; B17 solves "
          f"{int((sel_r[0] >= 4).sum())}; whole patches at the valid cells {whole}; "
          f"{len(idx_s)} of {len(lo_k)} stand-in queries fall back  [{card}]", flush=True)
    order = ["this", *PATCHES, *(["parent"] if args.parent else []), "this"]
    res = {"card": card, "variants": {}}
    for name in order:
        path, log = paths[name]
        lib = load(path, real)
        row = res["variants"].setdefault(name, {"cases": {}})
        if name != "parent":
            row["attributes"] = {k: (v["registers"], v["local_bytes"], v["blocks_per_sm"], v["threads"],
                                     v.get("spill_bytes")) for k, v in ee.attributes(lib, log).items()}
        row["B17 f64 SASS"] = {b: sass.fp64_instructions(str(path), b) for b in B17_F64_BUILDS}
        for case, (launch, outs) in launchers(lib, cases_in).items():
            launch()
            torch.cuda.synchronize()
            cs.exact_equal(outs, want[case], f"variant {name}: {case}")
            try:
                t = cs.device_ms(launch, "krige_kernel" if case.startswith("B17") else "patch_kernel")
            except RuntimeError as err:  # the tracer kept no record of this kernel
                print(f"{name:17s} {case:34s} no device records: {err}", flush=True)
                t = float("nan")
            te = events_ms(launch)
            row["cases"].setdefault(case, []).append(t)
            row.setdefault("events", {}).setdefault(case, []).append(te)
            print(f"{name:17s} {case:34s} {t:.4f} ms alone, {te:.4f} ms a launch by events, bit-equal to plain  "
                  f"[{card}]", flush=True)
        print(f"{name:17s} B17 f64 builds' FP64-pipe SASS instructions (static): {row['B17 f64 SASS']}", flush=True)
        for build, a in row.get("attributes", {}).items():
            print(f"{name:17s} {build:44s} {a[0]} registers, {a[1]} local bytes, {a[2]} blocks/SM of {a[3]}, "
                  f"{a[4]} spill bytes", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
