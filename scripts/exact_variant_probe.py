"""Exact mode's B13 (``dense_kernel``) and B14 (``ring_kernel``) in the
candidate designs, each held bit-equal to its plain version and timed
alone, in one process on one NVIDIA GPU.

Run from the root of a checkout:

    python3 scripts/exact_variant_probe.py [--parent DIR] [--radii 3,16]

The designs:

- ``this``: the checkout's ``csrc/exact_select.cu`` (B14's eight entries
  in registers, B13's keys read with the query where every query is
  aligned; radius 10 runs builds of its own, any other the builds that
  take the radius at run time), each case walking the validity bit plane
  (built first) and reading the validity plane itself, timed first and
  last;
- ``dense_runtime``, ``ring_runtime``: the same with B13's or B14's
  radius-10 launches sent to the builds that take the radius at run time
  (what those builds cost at radius 10, in the same process);
- ``prefetch``: the same with an L1 prefetch (``prefetch.global.L1``) of
  the elevation next to the anchor in the rows above and below it, where
  the picks of a walk that stops in ring 1 lie, issued before the walk;
- ``threads128``: the same with 128 threads a block (the checkout: 256);
- ``ring_min4``, ``dense_min5``: ``__launch_bounds__``' minimum of resident
  blocks an SM for B14 (4) or B13 (5), which caps the registers a thread;
- ``parent`` (with ``--parent DIR``, a version unpacked with ``git archive
  <commit> auvtpu_torch/csrc | tar -x -C DIR``, whose C interface is
  commit 8e214ae's): the kernels built for radius 10 alone (``kR``), the
  radius not an argument.

Every design runs at radius 10, the callers' default; ``this`` also at
each radius of ``--radii`` (default 3 and 16: one piece a pass, and the
top and bottom passes in two pieces from ring 16 on), its cases named
with the radius.

Each variant is a copy of ``csrc/`` with ``exact_select.cu`` patched as
text (the probe stops if a patch no longer matches the source), built with
the checkout's nvcc flags, all builds at once, one nvcc each.  The inputs
are chip_smoke.py's phase 19: the f64 stand-in (2053x2441, 10 % masked with
seed 42: 501,137 query cells), its two-tier operands and strict anchors
(round), and 1e5 Grid A queries (f64 distances).  The cases: B13 with the
solve and select-only on the aligned path and on the residue planes (the
planes made beforehand, outside the time), B14 at the round anchor, with
the solve, and scattered; each walking the bit plane ("bits") and reading
the validity plane ("valid"), which the wrappers choose between by the
queries' number against the grid's cells (``BIT_PLANE_CELLS``).  For each variant and case: the outputs against
the plain version's, bit for bit (it stops otherwise); the device duration
of one call's kernels in the profiler's records (``chip_smoke.device_ms``,
back to back; the bit plane's build included, and apart); and each
build's registers, local bytes and resident blocks an SM.  Prints one line
a case and one JSON line, with the card's name and power limit.
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
from auvtpu_torch.kernels import exact_select as es  # noqa: E402

PREFETCH = """
// the lines of row gj that hold columns gi - 1 and gi + 1 of elev, into L1
template <typename T>
__device__ __forceinline__ void prefetch_pair(const T* elev, int H, int W, int gj, int gi) {
  if ((unsigned)gj >= (unsigned)H || gi < -1 || gi > W) return;
  const T* r = elev + (long long)gj * W;
  asm volatile("prefetch.global.L1 [%0];" ::"l"(r + max(gi - 1, 0)));
  asm volatile("prefetch.global.L1 [%0];" ::"l"(r + min(gi + 1, W - 1)));
}
"""
DENSE_WALK = "  auto held = [&]() { return count >= 4; };\n"
RING_WALK = "    if constexpr (BITS)\n      ring_walk<RC>(BitPlane{a.bits, a.H, a.W}, (int)ci, (int)cj, rmax, take, held);"
PATCHES = {
    "prefetch": [("constexpr int kThreads = 256;\n", "constexpr int kThreads = 256;\n" + PREFETCH),
                 (DENSE_WALK, DENSE_WALK + "  prefetch_pair(a.elev, a.H, W, row - 1, col);\n"
                              "  prefetch_pair(a.elev, a.H, W, row + 1, col);\n"),
                 (RING_WALK, "    prefetch_pair(a.elev, a.H, a.W, (int)cj - 1, (int)ci);\n"
                             "    prefetch_pair(a.elev, a.H, a.W, (int)cj + 1, (int)ci);\n" + RING_WALK)],
    "dense_runtime": [("  if (a.R == kBuiltRadius)\n    dense_at<", "  if (false)\n    dense_at<")],
    "ring_runtime": [("  if (a.R == kBuiltRadius)\n    ring_at<", "  if (false)\n    ring_at<")],
    "threads128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "ring_min4": [("__global__ void __launch_bounds__(kThreads) ring_kernel(",
                   "__global__ void __launch_bounds__(kThreads, 4) ring_kernel(")],
    "dense_min5": [("__global__ void __launch_bounds__(kThreads) dense_kernel(",
                    "__global__ void __launch_bounds__(kThreads, 5) dense_kernel(")],
}
P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# commit 8e214ae's interface: no radius (the kernels' kR = 10)
PARENT_DENSE = [I, P, P, I, I, P, I, P, I, P, P, D, P, P, P, P, P, P, P, P]
PARENT_RING = [I, P, P, I, I, P, P, I, I, P, P, P, P, P, P, P, D, P, P, P, P, P, P, P]


def patched(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"exact_variant_probe: {old!r} is {src.count(old)} times in exact_select.cu, want 1")
        src = src.replace(old, new)
    return src


def build_variants(parent: str | None) -> dict:
    """{name: library path} of every variant (the checkout's own build
    included), every nvcc started at once."""
    src = (kbuild.CSRC / "exact_select.cu").read_text()
    h = hashlib.sha256(src.encode())
    if parent:
        h.update(open(os.path.join(parent, "auvtpu_torch", "csrc", "exact_select.cu"), "rb").read())
    out_dir = kbuild.BUILD_DIR / f"exact_variants-{h.hexdigest()[:12]}"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {name: patched(src, edits) for name, edits in PATCHES.items()}
    if parent:
        sources["parent"] = open(os.path.join(parent, "auvtpu_torch", "csrc", "exact_select.cu")).read()
    procs, paths = {}, {"this": kbuild.build("exact_select")}
    for name, text in sources.items():
        csrc = out_dir / name
        shutil.copytree(kbuild.CSRC, csrc, dirs_exist_ok=True)
        (csrc / "exact_select.cu").write_text(text)
        paths[name] = out_dir / f"libexact_select_{name}.so"
        cmd = [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", str(paths[name]), str(csrc / "exact_select.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed building variant {name}:\n{log}")
    return paths


def load(path, name: str, real):
    lib = ctypes.CDLL(str(path))
    for fn in ("auvtpu_exact_dense", "auvtpu_exact_ring", "auvtpu_exact_attributes"):
        getattr(lib, fn).argtypes = getattr(real, fn).argtypes
        getattr(lib, fn).restype = getattr(real, fn).restype
    if name == "parent":
        lib.auvtpu_exact_dense.argtypes, lib.auvtpu_exact_ring.argtypes = PARENT_DENSE, PARENT_RING
    return lib


def attributes(lib) -> dict:
    out = (ctypes.c_int * 3)()
    res = {}
    for which, name in enumerate(es.BUILDS):
        if lib.auvtpu_exact_attributes(which, out) == 0:
            res[name] = tuple(out)
    return res


def ptr(t):
    return t.data_ptr() if t is not None else None


def launchers(lib, parent: bool, g, dense_in, planes, ring_in, ring_qc, sc_grid, sc_in, tabs, R: int = 10):
    """{case: a function making (launch, outputs)}: each case's launch at
    radius ``R`` (the parent's: 10) straight through the library into
    outputs allocated once."""
    from auvtpu_torch.config import KrigingConfig

    tol = KrigingConfig().pivot_tol
    st = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def bits(grid, walk: str):
        H, W = grid.shape
        return torch.empty((H * W + 31) // 32, dtype=torch.int32, device=grid.device) if walk == "bits" else None

    def dense(aligned: bool, solve: bool, walk: str):
        keys, flat_q = dense_in
        n = flat_q.shape[0]
        H, W = g.shape
        tie = torch.empty(n, dtype=torch.bool, device=g.device)
        if solve:
            outs = (torch.empty(n, dtype=torch.float64, device=g.device), tie)
            optr = (None, ptr(tie), None, None, None, ptr(outs[0]))
        else:
            outs = (torch.empty(n, dtype=torch.int32, device=g.device), tie,
                    torch.empty((4, n), dtype=g.elev.dtype, device=g.device),
                    torch.empty((4, n), dtype=torch.int64, device=g.device),
                    torch.empty((4, n), dtype=torch.int64, device=g.device))
            optr = (ptr(outs[0]), ptr(tie), ptr(outs[2]), ptr(outs[3]), ptr(outs[4]), None)
        tb = tabs if solve else (None, None)
        res = keys if aligned else planes
        b = bits(g, walk)
        f64 = int(g.elev.dtype == torch.float64)

        head = (f64, ptr(g.elev), ptr(g.valid), H, W) + (() if parent else (R,))

        def launch():
            err = lib.auvtpu_exact_dense(*head, ptr(res), int(aligned), ptr(flat_q), n, *map(ptr, tb), tol, *optr,
                                         ptr(b), st)
            if err:
                raise RuntimeError(f"B13 launch failed ({err})")
        return launch, outs

    def ring(walk: str, grid, ci, cj, k0, k1, variant, qc=None):
        n = ci.shape[0]
        H, W = grid.shape
        if qc is not None:
            outs = torch.empty(n, dtype=torch.float64, device=grid.device)
            optr, tb = (None, None, None, None, ptr(outs)), tabs
        else:
            outs = (torch.empty(n, dtype=torch.int32, device=grid.device),
                    torch.empty((n, 4), dtype=grid.elev.dtype, device=grid.device),
                    torch.empty((n, 4), dtype=torch.int32, device=grid.device),
                    torch.empty((n, 4), dtype=torch.int32, device=grid.device))
            optr, tb = (*map(ptr, outs), None), (None, None)
        qcol, qrow = qc if qc is not None else (None, None)
        b = bits(grid, walk)
        f64 = int(grid.elev.dtype == torch.float64)
        head = ((f64, ptr(grid.elev), ptr(grid.valid), H, W) + (() if parent else (R,)) +
                (ptr(ci), ptr(cj), n, int(variant is None), ptr(variant), ptr(k0), ptr(k1), ptr(qcol), ptr(qrow),
                 *map(ptr, tb), tol, *optr))

        def launch():
            err = lib.auvtpu_exact_ring(*head, ptr(b), st)
            if err:
                raise RuntimeError(f"B14 launch failed ({err})")
        return launch, outs

    def cases(walk: str) -> dict:
        at = "" if R == 10 else f"R={R} "
        return {f"{at}B13 solve aligned, {walk}": lambda: dense(True, True, walk),
                f"{at}B13 select aligned, {walk}": lambda: dense(True, False, walk),
                f"{at}B13 solve planes, {walk}": lambda: dense(False, True, walk),
                f"{at}B13 select planes, {walk}": lambda: dense(False, False, walk),
                f"{at}B14 round, {walk}": lambda: ring(walk, g, *ring_in),
                f"{at}B14 solve, {walk}": lambda: ring(walk, g, *ring_in, qc=ring_qc),
                f"{at}B14 scattered, {walk}": lambda: ring(walk, sc_grid, *sc_in, None)}

    return {**cases("bits"), **cases("valid")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a version unpacked with git archive (commit 8e214ae's C interface)")
    ap.add_argument("--radii", default="3,16", help="the radii besides 10 at which this checkout's build runs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("exact_variant_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from auvtpu_torch.config import GRID_A_EXTENT, GRID_A_SHAPE, KERGUELEN_EXTENT
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.masking import mask_grid
    from auvtpu_torch.ops import exact as texact
    from auvtpu_torch.ops import exact_fast as tfast
    from auvtpu_torch.synthetic import kerguelen_standin, shelf_seamount

    card = cs.card_line()
    paths = build_variants(args.parent)
    real = es._lib()
    dev = torch.device("cuda", 0)
    reduced, rc, _ = mask_grid(kerguelen_standin(cs.SHAPE), cs.REMOVAL)
    g = RegularGrid.from_nan_array(reduced, KERGUELEN_EXTENT, dtype=torch.float64, device=dev)
    rows, cols = rc[:, 0].astype(np.int64), rc[:, 1].astype(np.int64)
    q = texact.prepare_exact_queries(g, rows, cols)
    flat_a, keys, flat_q = tfast._round_queries(g, rows, cols)[1]
    if flat_a is not None:
        raise AssertionError("the stand-in's queries are all aligned")
    H, W = g.shape
    planes = torch.zeros((2, H * W), dtype=torch.float32, device=dev)
    planes[:, flat_q] = keys
    radii = [int(r) for r in args.radii.split(",") if r]
    tabs = {R: tfast._reference_tables(g, R) for R in (10, *radii)}
    ci, cj, variant, ex, ey = texact._cell_keys(g, q, None)
    ring_in = (ci, cj, ex, ey, variant)
    ring_qc = (texact._on(g, cols), texact._on(g, rows))
    gA = RegularGrid.from_nan_array(shelf_seamount(*GRID_A_SHAPE), GRID_A_EXTENT, dtype=torch.float64, device=dev)
    lo, la = (t.cpu().numpy().astype(np.float64) for t in cs.scattered_queries(
        GRID_A_EXTENT, GRID_A_SHAPE[0], GRID_A_SHAPE[1], 100_000, 19, dev))
    _, _, xa, ya, cia, cja, _ = texact._prepare_scattered(gA, lo, la, "round")
    sc_in = [texact._on(gA, a, t) for a, t in ((cia, torch.int64), (cja, torch.int64), (xa, torch.float64),
                                                (ya, torch.float64))]
    want = {}
    for R in (10, *radii):
        at = "" if R == 10 else f"R={R} "
        want.update({
            f"{at}B13 solve": es.dense_krige_ref(g.elev, g.valid, None, keys, flat_q, *tabs[R], R),
            f"{at}B13 select": es.dense_select_ref(g.elev, g.valid, None, keys, flat_q, R),
            f"{at}B14 round": es.ring_select_ref(g.elev, g.valid, ci, cj, ex, ey, variant, R, 16384),
            f"{at}B14 solve": es.ring_krige_ref(g.elev, g.valid, ci, cj, variant, ex, ey, *ring_qc, *tabs[R], R, 16384),
            f"{at}B14 scattered": es.ring_select_ref(gA.elev, gA.valid, *sc_in, None, R, 16384),
        })
    order = ["this", *PATCHES, *(["parent"] if args.parent else []), "this"]
    res = {"card": card, "variants": {}}
    for name in order:
        lib = load(paths[name], name, real)
        row = res["variants"].setdefault(name, {"cases": {}})
        row["attributes (registers, local bytes, blocks/SM)"] = attributes(lib)
        cases = {}
        for R in (10, *(radii if name == "this" else ())):
            cases.update(launchers(lib, name == "parent", g, (keys, flat_q), planes, ring_in, ring_qc, gA, sc_in,
                                   tabs[R], R))
        for case, make in cases.items():
            launch, outs = make()
            launch()
            torch.cuda.synchronize()
            ref = want[case.split(",")[0].replace(" aligned", "").replace(" planes", "")]
            cs.exact_equal(outs, ref, f"variant {name}: {case}")
            t = cs.device_ms(launch, None)
            t_bits = cs.device_ms(launch, "bits_kernel") if case.endswith("bits") else 0.0
            row["cases"].setdefault(case, []).append((t, t_bits))
            print(f"{name:10s} {case:26s} {t:.4f} ms alone (bit plane {t_bits:.4f} of it), bit-equal to plain  "
                  f"[{card}]", flush=True)
        for build, a in row.get("attributes (registers, local bytes, blocks/SM)", {}).items():
            print(f"{name:10s} {build:44s} {a[0]} registers, {a[1]} local bytes, {a[2]} blocks/SM", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
