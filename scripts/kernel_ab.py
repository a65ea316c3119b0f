"""B1, B2, B3, B5, B6, B7, B8, B9 and B10 of this checkout against another
version of their sources, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 scripts/kernel_ab.py --parent DIR

where DIR holds the other version (``git archive <commit> auvtpu_torch/csrc
| tar -x -C DIR``, into a directory .gitignore lists).  Its
``csrc/window_fill.cu``, ``csrc/scattered_select.cu``,
``csrc/band_resample.cu`` and ``csrc/variogram.cu`` (the ones the kernels
named by ``--only`` need) are built with the same nvcc flags and called
through their C interfaces.  The script knows four interfaces and reads
which one the other version has from its sources: this checkout's; commit
c5e5ecf's (B2 on a NaN-padded plane, B7 as mode 2 of
``auvtpu_scattered_select``, which then took a mode); commit 91269b4's (also
B1 on a NaN-padded plane with its parameters in a device tensor, B6 as mode
1 of ``auvtpu_scattered_select``, which then also took an eps); and commit
9ff8bad's and before (also B3 on a NaN-padded plane, B8 on band-frame
coordinates padded to whole chunks, as that version's wrappers fed them).
Any other interface stops it before a launch.

The inputs are chip_smoke.py's: the Kerguelen stand-in r0.10 (B1,
exponential, gj, R=10; B2 k=4 R=10) and r0.20 (B3 idw k=8 and mean k=4 at R=10; a
256x256 window view as the streaming refresh reads it, B3 idw k=8 at R=5,
B1 at R=5 and R=10); 1M queries on Grid A (B5 valid16 k=4, B6 radius 2 k=8, B7 radius
2 k=4); the 5M-ping band weave on the B1-filled band of the stand-in r0.10
(B8 with hat weights and the default window, at chunks 2048 and 512); B9
on the stand-in r0.10 in chip_smoke's three layouts (the whole grid, a
1024-row band, a 1024x1024 2-D block) with the lag and the (sector, lag)
bins, and B10 for the four models on that grid's variogram (25 steps, the
package's stop), float32 inputs as the fit takes them and float64.  B9's
and B10's outputs (B10's per-step flags too) are held bit-equal to the
other version's before they are timed.  Each kernel is timed by its device
duration in the profiler's kernel records (CUPTI), so no host time enters:
back to back (inputs warm in the L2) and cold (a 128 MB write before each
launch), in the order other, this, this, other.  B2's call is timed too,
by the device duration of all its records: a NaN-padded plane's launches
are part of the call in a version whose wrapper builds one.  Then the
static SASS instruction mix (``cuobjdump -sass``) of the timed kernels of
both versions, by class, and for B9's and B10's kernels each innermost
loop's instructions, ``F2F.F64.F32`` conversions, shared loads (LDS) and
float64 adds.  Prints the card's name and power limit beside the numbers.
"""

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from auvtpu_torch.config import GRID_A_EXTENT, GRID_A_SHAPE, IDWConfig  # noqa: E402
from auvtpu_torch.grid import RegularGrid  # noqa: E402
from auvtpu_torch.kernels import band_resample as kb  # noqa: E402
from auvtpu_torch.kernels import build as kbuild  # noqa: E402
from auvtpu_torch.kernels import scattered_select as ss  # noqa: E402
from auvtpu_torch.kernels import variogram as kv  # noqa: E402
from auvtpu_torch.kernels import window_fill as wf  # noqa: E402
from auvtpu_torch.ops import band as tband  # noqa: E402
from auvtpu_torch.ops import packs as tp  # noqa: E402
from auvtpu_torch.synthetic import shelf_seamount  # noqa: E402
from auvtpu_torch.variogram import _bin_table, _sector_bin_table, empirical_variogram  # noqa: E402
from sass_tools import sass_functions  # noqa: E402

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the earlier interfaces: {C function: {commit: (parameter list, ctypes argument types)}}
EARLIER = {
    "auvtpu_fill": {"9ff8bad": (
        "const void* nanp, const void* tab, const void* wtab, int m, int H, int W, int R, int kind, "
        "int k, float eps, void* out, void* stream", [P, P, P, I, I, I, I, I, I, F, P, P])},
    "auvtpu_band_resample": {"9ff8bad": (
        "const void* planes, const void* vmasks, const void* origins, int K, int R, int C, const void* x, "
        "const void* y, int n, int chunk, int wh, int ww, int ar, int ac, int lim_r, int lim_c, int masked, "
        "int pick, int hat, float thresh, void* z, void* ok, void* stream",
        [P, P, P, I, I, I, P, P, I, I, I, I, I, I, I, I, I, I, I, F, P, P, P])},
    "auvtpu_kriging_fill": {"91269b4": (
        "const void* nanp, const void* tab, int m, int H, int W, int R, const void* par, int model, int solver, "
        "int with_variance, void* out, void* stream", [P, P, I, I, I, I, P, I, I, I, P, P])},
    "auvtpu_scattered_select": {
        "c5e5ecf": (
            "const void* pack, int P, const void* cell, const void* fxy, const void* tab, int n, int k, int mode, "
            "int emit_d2, float half, int has_resolve, float resolve_thresh, void* out, void* stream",
            [P, I, P, P, P, I, I, I, I, F, I, F, P, P]),
        "91269b4": (
            "const void* pack, int P, const void* cell, const void* fxy, const void* tab, int n, int k, int mode, "
            "int emit_d2, float half, int has_resolve, float resolve_thresh, float eps, void* out, void* stream",
            [P, I, P, P, P, I, I, I, I, F, I, F, F, P, P])},
    "auvtpu_idw_select": {"700e4e5": (
        "const void* pack, int P, int M, const void* cell, const void* fxy, const float* taps, int n, int k, "
        "int has_resolve, float resolve_thresh, float eps, void* out, void* stream",
        [P, I, I, P, P, P, I, I, I, F, F, P, P])},
    "auvtpu_topk_full": {"c5e5ecf": (
        "const void* nanp, const void* tab, int m, int H, int W, int R, int k, void* out, void* stream",
        [P, P, I, I, I, I, I, P, P])},
}
THIS_LIB = {"window_fill": wf._lib, "scattered_select": ss._lib, "band_resample": kb._lib, "variogram": kv._lib}
# the kernels each source holds
KERNELS_OF = {"window_fill": {"B1", "B2", "B3"}, "scattered_select": {"B5", "B6", "B7"}, "band_resample": {"B8"},
              "variogram": {"B9", "B10"}}


def signature(src: str, fn: str) -> str | None:
    """The parameter list of ``fn`` in the C source ``src``, whitespace
    normalised; None where the source has no such function."""
    m = re.search(rf"\bint {fn}\(([^)]*)\)", open(src).read())
    return None if m is None else " ".join(m.group(1).split())


def build_other(parent: str, name: str) -> tuple[ctypes.CDLL, str]:
    """The other version's library of ``csrc/<name>.cu`` and its path."""
    src = os.path.join(parent, "auvtpu_torch", "csrc", f"{name}.cu")
    out = os.path.join(kbuild.BUILD_DIR, f"other_{name}.so")
    os.makedirs(kbuild.BUILD_DIR, exist_ok=True)
    subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", out, src], check=True, capture_output=True)
    return ctypes.CDLL(out), out


def interface(parent: str, name: str, lib: ctypes.CDLL, fn: str) -> str | None:
    """Which interface the other version's ``fn`` has: "this", a commit of
    EARLIER, or None where it has no ``fn``; sets its argument types.  Stops
    on any other interface."""
    sig = signature(os.path.join(parent, "auvtpu_torch", "csrc", f"{name}.cu"), fn)
    if sig is None:
        return None
    if sig == signature(os.path.join(kbuild.CSRC, f"{name}.cu"), fn):
        getattr(lib, fn).argtypes = getattr(THIS_LIB[name](), fn).argtypes
        return "this"
    for commit, (known, argtypes) in EARLIER.get(fn, {}).items():
        if sig == known:
            getattr(lib, fn).argtypes = argtypes
            return commit
    raise SystemExit(f"{parent}: {fn}({sig}) is neither this checkout's interface nor a known earlier one")


def b1_earlier(lib, grid, R: int, stream):
    """B1 of 91269b4: the NaN-padded plane and the 11 parameters on the
    device, made once here (that version's wrapper made them each call)."""
    H, W = grid.shape
    tab = wf._device_table(R, "reference", grid.device)
    nanp = torch.full((H + 2 * R, W + 2 * R), float("nan"), device=grid.device)
    nanp[R:R + H, R:R + W] = torch.where(grid.valid > 0.5, grid.elev, float("nan"))
    par = torch.tensor([1.0, 100.0, 10.0, grid.min_lon, grid.min_lat, grid.lon_step, grid.lat_step, 0.5, 1e-12,
                        0.0, 0.0], dtype=torch.float32, device=grid.device)
    out = torch.empty((H, W), device=grid.device)

    def launch():
        lib.auvtpu_kriging_fill(nanp.data_ptr(), tab.data_ptr(), tab.shape[0], H, W, R, par.data_ptr(), 0, 0, 0,
                                out.data_ptr(), stream)

    return launch


def b6_cells_launcher(lib, pack, P: int, cell, fx, fy, tab, k: int, stream):
    """B6 of 700e4e5 and before, which took the torch prologue's cell
    index and (fx, fy) and wrote the sums (2, n); output allocated once."""
    n = cell.numel()
    cell32 = cell.to(torch.int32).contiguous()
    fxy = torch.stack([fx, fy]).contiguous()
    M, taps = ss._idw_taps(tab, P, 0.5)
    out = torch.empty((2, n), dtype=torch.float32, device=pack.device)
    tp_ = taps.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def launch():
        err = lib.auvtpu_idw_select(pack.data_ptr(), P, M, cell32.data_ptr(), fxy.data_ptr(), tp_, n, k, 0, 0.0,
                                    1e-12, out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"B6 launch failed ({err})")

    launch.keep = (taps, cell32, fxy)
    return launch


def select_launcher(lib, ifc: str, pack, P: int, cell, fx, fy, tab, mode: int, k: int, stream):
    """B5 (mode 0) through auvtpu_scattered_select, or, for the earlier
    interfaces, B7 (mode 2) and, for 91269b4, B6 (mode 1) too; output
    allocated once."""
    n = cell.numel()
    rows = {0: 1 + 2 * k, 1: 2, 2: 1 + 3 * k}[mode]
    out = torch.empty(rows * n, device=pack.device)
    cell32, fxy = cell.to(torch.int32).contiguous(), torch.stack([fx, fy]).contiguous()
    mode_ = [] if ifc == "this" else [mode]
    eps = [IDWConfig(k=k).eps] if ifc == "91269b4" else []

    def launch():
        lib.auvtpu_scattered_select(pack.data_ptr(), P, cell32.data_ptr(), fxy.data_ptr(), tab.data_ptr(), n, k,
                                    *mode_, 0, 0.5, 0, 0.0, *eps, out.data_ptr(), stream)

    return launch


def b2_earlier(lib, grid, R: int, stream):
    """B2 of c5e5ecf: (the kernel on a NaN-padded plane made once here, the
    call: that version's wrapper, the padded plane made, then the kernel)."""
    H, W = grid.shape
    tab = wf._device_table(R, "reference", grid.device)
    out = torch.empty((13, H, W), device=grid.device)
    nanp = wf._nan_padded(grid, R)

    def launch(nanp=nanp):
        lib.auvtpu_topk_full(nanp.data_ptr(), tab.data_ptr(), tab.shape[0], H, W, R, 4, out.data_ptr(), stream)

    return launch, lambda: launch(wf._nan_padded(grid, R))


def same_bits(a, b) -> bool:
    """Equal bit for bit (NaN included)."""
    if a.dtype.is_floating_point:
        ints = {8: torch.int64, 4: torch.int32}[a.element_size()]
        a, b = a.view(ints), b.view(ints)
    return torch.equal(a, b)


SASS_CLASSES = {
    "compare/select": ("FSETP", "ISETP", "FSEL", "SEL", "FMNMX", "IMNMX", "VIMNMX", "PLOP3", "PSETP", "FCHK"),
    "FFMA/FADD/FMUL": ("FFMA", "FADD", "FMUL"),
    "MUFU": ("MUFU",),
    "loads/stores": ("LDG", "LDS", "LDC", "LDL", "STG", "STS", "STL", "ULDC"),
    "branch/call": ("BRA", "CALL", "RET", "BSSY", "BSYNC", "EXIT"),
}


def sass_mix(lib_path: str, matches: list[str]) -> dict:
    """{demangled kernel name: {class: static instruction count}} of the
    kernels of :func:`sass_functions`."""
    out = {}
    for name, block in sass_functions(lib_path, matches):
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", block)
        counts = collections.Counter(op for op in ops)
        mix = {cls: sum(v for op, v in counts.items() if op in names) for cls, names in SASS_CLASSES.items()}
        mix["total"] = sum(counts.values())
        out[name] = mix
    return out


def loop_mix(lib_path: str, matches: list[str]) -> dict:
    """{demangled kernel name: [(instructions, F2F.F64.F32, LDS, DADD) of
    each innermost loop]}: a loop is the span from a backward branch's
    target to the branch, innermost where it holds no other such span."""
    out = {}
    for name, block in sass_functions(lib_path, matches):
        ins = [(int(a, 16), op) for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        loops = []
        for addr, op in ins:
            m = re.search(r"\bBRA\b[^;]*?0x([0-9a-f]+)", op)
            if m and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))
        inner = [(t, a) for t, a in loops if not any(t <= t2 and a2 <= a and (t2, a2) != (t, a) for t2, a2 in loops)]
        out[name] = []
        for t, a in inner:
            body = [op for addr, op in ins if t <= addr <= a]
            out[name].append((len(body), sum("F2F.F64.F32" in op for op in body),
                              sum(bool(re.search(r"\bLDS\b", op)) for op in body),
                              sum(bool(re.search(r"\bDADD\b", op)) for op in body)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="root of the other version's checkout")
    ap.add_argument("--only", default="B1,B2,B3,B5,B6,B7,B8,B9,B10", help="the kernels to time, e.g. B2,B7")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    other = {name: build_other(args.parent, name) for name, ks in KERNELS_OF.items() if ks & only}
    lib_wf, lib_ss, lib_kb, lib_kv = (other.get(n, (None,))[0] for n in KERNELS_OF)
    ifc = {}
    for name, lib, fns in (("window_fill", lib_wf, (("B1", "auvtpu_kriging_fill"), ("B2", "auvtpu_topk_full"),
                                                     ("B3", "auvtpu_fill"))),
                           ("scattered_select", lib_ss, (("B5", "auvtpu_scattered_select"),
                                                         ("B6", "auvtpu_idw_select"),
                                                         ("B7", "auvtpu_window_select"))),
                           ("band_resample", lib_kb, (("B8", "auvtpu_band_resample"),)),
                           ("variogram", lib_kv, (("B9", "auvtpu_pair_sums"), ("B10", "auvtpu_fit_model")))):
        if lib is not None:
            ifc.update({k: interface(args.parent, name, lib, fn) for k, fn in fns})
    if lib_ss is not None and ifc["B6"] is None and ifc["B5"] != "91269b4":
        raise SystemExit("the other version has neither auvtpu_idw_select nor 91269b4's B6 mode")
    if lib_ss is not None and ifc["B7"] is None and ifc["B5"] == "this":
        raise SystemExit("the other version has neither auvtpu_window_select nor an earlier B7 mode")
    if lib_wf is not None and (ifc["B1"] is None or ifc["B2"] is None):
        raise SystemExit("the other version has no auvtpu_kriging_fill or no auvtpu_topk_full")
    if lib_kv is not None and (ifc["B9"] != "this" or ifc["B10"] != "this"):
        raise SystemExit("the other version's B9 or B10 has another interface than this checkout's")
    print("other version's interfaces: " + ", ".join(f"{k} {v or 'a mode of B5'}" for k, v in ifc.items()),
          flush=True)
    stream = wf._stream(dev)
    cases = []

    # B1 on the stand-in r0.10 (the fused fill's workload) and on a 256x256
    # window view of the r0.20 stand-in at R=5 and R=10, as the streaming
    # refresh reads the mosaic (the launcher takes 4 cells a thread on the
    # first, 1 on the window)
    grid, *_ = cs.bench_workload(dev, 0.10)
    grid2, *_ = cs.bench_workload(dev, 0.20)
    win = RegularGrid(grid2.elev[700:956, 300:556], grid2.valid[700:956, 300:556], 0.0, 255.0, 0.0, 255.0)
    for label, g, R in (("stand-in r0.10", grid, 10), ("256x256 window view R=5", win, 5),
                        ("256x256 window view R=10", win, 10)) if "B1" in only else ():
        old_b1 = cs.b1_launcher(g, R, lib=lib_wf) if ifc["B1"] == "this" else b1_earlier(lib_wf, g, R, stream)
        cases.append((f"{label} B1 exponential gj", old_b1, "kriging_fill_kernel", cs.b1_launcher(g, R),
                      "kriging_fill_kernel"))

    # B2 on the stand-in r0.10, k=4 R=10 (the select backend's workload):
    # the kernel alone, and the call with what it launches besides
    calls = []
    if "B2" in only:
        if ifc["B2"] == "this":
            old_b2, old_call = cs.b2_launcher(grid, lib=lib_wf), None
        else:
            old_b2, old_call = b2_earlier(lib_wf, grid, 10, stream)
        cases.append(("stand-in r0.10 B2 k=4 R=10", old_b2, "topk_", cs.b2_launcher(grid), "topk_tile_kernel"))
        if old_call is not None:
            calls.append(("stand-in r0.10 B2 k=4 R=10 call (all device records)", old_call,
                          lambda: wf.topk_full(grid, k=4, max_radius=10)))

    # B3 on the stand-in r0.20 and on the 256x256 window view at R=5
    for label, g, R, kind, k in (("stand-in r0.20 idw k=8 R=10", grid2, 10, 0, 8),
                                 ("stand-in r0.20 mean k=4 R=10", grid2, 10, 1, 4),
                                 ("256x256 window view idw k=8 R=5", win, 5, 0, 8)) if "B3" in only else ():
        if ifc["B3"] == "9ff8bad":
            h, w = g.shape
            tab = wf._device_table(R, "reference", dev)
            wtab = wf._device_weights(R, 2.0, "reference", dev)
            out = torch.empty((h, w), device=dev)
            nanp = wf._nan_padded(g, R)  # that version's wrapper built it before each launch

            def old(R=R, kind=kind, k=k, tab=tab, wtab=wtab, out=out, h=h, w=w, nanp=nanp):
                lib_wf.auvtpu_fill(nanp.data_ptr(), tab.data_ptr(), wtab.data_ptr(), tab.shape[0], h, w, R, kind, k,
                                   1e-12, out.data_ptr(), stream)

            cases.append((label, old, "fill_kernel", cs.b3_launcher(g, kind, k, R), "fill_tile_kernel"))
        else:
            cases.append((label, cs.b3_launcher(g, kind, k, R, lib=lib_wf), "fill_tile_kernel",
                          cs.b3_launcher(g, kind, k, R), "fill_tile_kernel"))
    del grid2, win

    # B9 on the stand-in r0.10 in chip_smoke's three layouts, both bin
    # tables, and B10 for the four models on its variogram: outputs bit-equal
    # to the other version's, then timed
    if "B9" in only:
        H, W = grid.shape
        layouts = {"whole grid": (grid.elev, grid.valid, H, W, 0),
                   "row band": (grid.elev[600:1634], grid.valid[600:1634], 1024, W, 0),
                   "2-D block": (grid.elev[600:1634, 500:1544], grid.valid[600:1634, 500:1544], 1024, 1024, 10)}
        for bins_name, (dys, dxs, bins, n_out) in (("lag", _bin_table(10, 10)[:3] + (10,)),
                                                   ("sector x lag", _sector_bin_table(10, 10, 4)[:3] + (40,))):
            for lay, lay_args in layouts.items():
                old_fn, old_out = cs.b9_launcher(*lay_args, dys, dxs, bins, n_out, lib=lib_kv)
                new_fn, new_out = cs.b9_launcher(*lay_args, dys, dxs, bins, n_out)
                old_fn()
                new_fn()
                torch.cuda.synchronize()
                if not same_bits(old_out, new_out):
                    raise SystemExit(f"B9 {lay}, {bins_name} bins: this version's sums {new_out.tolist()} are not the "
                                     f"other's {old_out.tolist()} bit for bit")
                print(f"B9 {lay}, {bins_name} bins: (2, {n_out}) float64 output bit-equal to the other version's",
                      flush=True)
                cases.append((f"stand-in r0.10 B9 {lay}, {bins_name} bins", old_fn, "pair_sums_", new_fn,
                              "pair_sums_"))
    if "B10" in only:
        lags, gam, cnt = empirical_variogram(grid)
        lags = lags * (0.5 * (abs(grid.lat_step) + abs(grid.lon_step)))
        for model_i, model in enumerate(("exponential", "linear", "spherical", "gaussian")):
            for dt in (torch.float32, torch.float64):
                fit_in = (lags.to(dt), gam.to(dt), cnt.to(dt))
                old_fn, o_p, o_f = cs.b10_launcher(*fit_in, model=model_i, lib=lib_kv)
                new_fn, n_p, n_f = cs.b10_launcher(*fit_in, model=model_i)
                old_fn()
                new_fn()
                torch.cuda.synchronize()
                if not (same_bits(o_p, n_p) and torch.equal(o_f, n_f)):
                    raise SystemExit(f"B10 {model} {dt}: parameters {n_p.tolist()} and flags {n_f.tolist()} against "
                                     f"the other version's {o_p.tolist()}, {o_f.tolist()}")
                steps = next((i + 1 for i, (k, f) in enumerate(n_f.tolist()) if not k or f), 25)
                print(f"B10 {model} {str(dt)[6:]}: parameters {n_p.tolist()} and the 25 steps' flags bit-equal to the "
                      f"other version's; the walk ends at step {steps}", flush=True)
                if dt == torch.float32:
                    cases.append((f"stand-in r0.10 B10 {model} 25 steps", old_fn, "fit_model_kernel", new_fn,
                                  "fit_model_kernel"))

    # B5, B6, B7 at 1M Grid A queries (chip_smoke phase 15)
    if only & KERNELS_OF["scattered_select"]:
        gA = RegularGrid.dense(shelf_seamount(*GRID_A_SHAPE), GRID_A_EXTENT, device=dev)
        qA = cs.scattered_queries(GRID_A_EXTENT, *GRID_A_SHAPE, cs.N_SCATTER, 7, dev)
        _, _, _, _, _, cellA, fxA, fyA = ss.prologue(gA, *qA)
        p16 = tp.build_valid16_pack(gA)
        winA, _ = tp.build_pack(gA, tp.window_offsets(2), clamp=False)
        tab16 = ss.table(tp.VALID16_OFFSETS, 16, 2, "dy", dev)
        tab32 = ss.table(tp.window_offsets(2), 32, 2, "dy", dev)
        tab32n = ss.table(tp.window_offsets(2), 32, 2, "dx", dev)
    if "B5" in only:
        cases.append(("Grid A 1M B5 valid16 k=4",
                      select_launcher(lib_ss, ifc["B5"], p16, 16, cellA, fxA, fyA, tab16, 0, 4, stream), "select_kernel",
                      select_launcher(ss._lib(), "this", p16, 16, cellA, fxA, fyA, tab16, 0, 4, stream),
                      "select_kernel"))
    if "B6" in only:
        # since the commit after 700e4e5 B6 takes the queries (the prologue
        # in the kernel); before, the torch prologue's planes
        old_b6 = (cs.b6_launcher(winA, 32, tab32, gA, *qA, 8, lib=lib_ss) if ifc["B6"] == "this"
                  else b6_cells_launcher(lib_ss, winA, 32, cellA, fxA, fyA, tab32, 8, stream) if ifc["B6"] == "700e4e5"
                  else select_launcher(lib_ss, ifc["B5"], winA, 32, cellA, fxA, fyA, tab32, 1, 8, stream))
        cases.append(("Grid A 1M B6 radius 2 k=8", old_b6, "select_kernel",
                      cs.b6_launcher(winA, 32, tab32, gA, *qA, 8), "idw_select_kernel"))
    for k in (4, 8) if "B7" in only else ():
        old_b7 = (cs.b7_launcher(winA, 32, cellA, fxA, fyA, tab32n, k, lib=lib_ss) if ifc["B7"] == "this"
                  else select_launcher(lib_ss, ifc["B5"], winA, 32, cellA, fxA, fyA, tab32n, 2, k, stream))
        cases.append((f"Grid A 1M B7 radius 2 k={k}", old_b7, "select_kernel",
                      cs.b7_launcher(winA, 32, cellA, fxA, fyA, tab32n, k), "window_select_kernel"))

    # B8 on the 5M band weave
    if "B8" in only:
        tracks = cs.band_tracks(grid, cs.N_BAND)
        rb = tband.BandRouter(grid)
        band = rb.prepare(*tracks["band"])
        rs = rb._resampler
        b_args, b_kw = cs.b8_call(rs, *tracks["band"])
        # the band-frame coordinates, padded to whole chunks of 2048 (and so of 512)
        _, x, y, _ = tband.BandResampler(grid, band, chunk=2048, win_rows=rs.wr, win_cols=rs.wc,
                                         lerp_mode=rs.lerp_mode).coords(*tracks["band"])
        x, y = x.contiguous(), y.contiguous()
        K, R_, C_ = 1, *band.shape
        geo = kb.geometry(R_, C_, rs.wr, rs.wc, False)
        zo = torch.empty(x.numel(), device=dev)
        oko = torch.empty(x.numel(), dtype=torch.bool, device=dev)
        org = torch.zeros((1, 2), device=dev)
        for chunk in (2048, 512):
            kw = dict(b_kw, chunk=chunk)
            if ifc["B8"] == "9ff8bad":
                def old(chunk=chunk, kw=kw):
                    lib_kb.auvtpu_band_resample(band.plane.data_ptr(), None, org.data_ptr(), K, R_, C_, x.data_ptr(),
                                                y.data_ptr(), x.numel(), chunk, *geo, 0, 0, int(kw["hat"]),
                                                kb.WSUM_THRESH, zo.data_ptr(), oko.data_ptr(), stream)
            else:
                old = cs.b8_launcher(b_args, kw, lib=lib_kb)
            cases.append((f"band weave {cs.N_BAND} pings chunk {chunk}", old, "band_resample_",
                          cs.b8_launcher(b_args, kw), "band_resample_"))

    for label, old, old_name, new, new_name in cases:
        for cold in (False, True):
            t = [cs.device_ms(old, old_name, cold=cold), cs.device_ms(new, new_name, cold=cold),
                 cs.device_ms(new, new_name, cold=cold), cs.device_ms(old, old_name, cold=cold)]
            print(f"{label:56s} {'cold' if cold else 'back to back':12s} other {t[0]:.4f} / {t[3]:.4f} ms, "
                  f"this {t[1]:.4f} / {t[2]:.4f} ms  [{card}]", flush=True)

    for label, old, new in calls:
        t = [cs.device_ms(old, None), cs.device_ms(new, None), cs.device_ms(new, None), cs.device_ms(old, None)]
        print(f"{label:56s} {'back to back':12s} other {t[0]:.4f} / {t[3]:.4f} ms, "
              f"this {t[1]:.4f} / {t[2]:.4f} ms  [{card}]", flush=True)
        print(f"{'':56s} other's records {cs.device_kernels(old)}; this {cs.device_kernels(new)}", flush=True)

    # the static SASS mix of the timed kernels (the instantiations above)
    matches = ["kriging_fill_kernel<0, 0, false", "select_kernel<32, 1>", "select_kernel<16, 0>", "select_kernel<16>",
               "select_kernel<32, 2>", "idw_select_kernel<25, 32, true>", "window_select_kernel<25, 4, true>",
               "window_select_kernel<25, 8, true>", "fill_tile_kernel<0, 4>", "topk_full_kernel<4, false>",
               "topk_tile_kernel<4, 8>"]
    matches += ["pair_sums_tile_kernel<float>", "pair_sums_finish_kernel", "fit_model_kernel"]
    names = [n for n in ("window_fill", "scattered_select", "variogram") if n in other]
    for who, paths in (("other", [other[n][1] for n in names]),
                       ("this", [str(kbuild.library_path(n)) for n in names])):
        for path in paths:
            for name, mix in sass_mix(path, matches).items():
                print(f"SASS {who:5s} {name[:90]:90s} " + ", ".join(f"{c} {v}" for c, v in mix.items()), flush=True)
            if "variogram" in os.path.basename(path):
                for name, loops in loop_mix(path, ["pair_sums_tile_kernel<float>", "fit_model_kernel"]).items():
                    print(f"SASS {who:5s} {name[:60]:60s} innermost loops (instructions, F2F.F64.F32, LDS, DADD): "
                          f"{loops}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
