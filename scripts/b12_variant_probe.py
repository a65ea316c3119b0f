"""B12 (``window_krige_kernel``) built in its design variants, each held
bit-equal to the plain version before it is timed, with the split of its
time into gather, selection and solve, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 scripts/b12_variant_probe.py [--parent DIR] [--only NAMES]

``--parent DIR`` also builds the ``scattered_select.cu`` of an earlier
``auvtpu_torch/csrc`` as ``parent`` (``git archive <commit>
auvtpu_torch/csrc | tar -x -C DIR``, DIR a git-ignored directory; DIR may
also be the csrc directory itself), with its C interface.  ``this`` is the
checkout's own build.  The variants are ``scripts/b12_variants.cu`` (the
checkout's source with the variant kernel beside it, exponential model)
built with nvcc's ``-D`` (all builds at once, one nvcc each, the
checkout's flags):

- ``direct``: ``B12_STAGES=0``, the rows loaded straight into registers,
  the design before the staging (no minimum of resident blocks);
- ``direct_min6``, ``direct_min8``: the same with ``B12_MIN_BLOCKS_R2`` 6
  or 8, the launch bounds' minimum of resident blocks of 128 threads an SM
  for the radius-2 builds (a cap on their registers);
- ``single``, ``single_bulk``: ``B12_STAGES=1``, the rows of a warp's 32
  queries copied into shared memory, then selected and solved, a chunk at a
  time: by 16-byte cp.async pieces, or (``B12_COPY=1``) one
  ``cp.async.bulk`` a row completing on an mbarrier;
- ``double_min1``, ``double_min5``: the shipped pipeline (a persistent
  grid, the next chunk's rows copied while this one is solved) with a
  radius-2 minimum of 1 or 5 (the checkout's is 4); ``double_r3min2``: the
  radius-3 minimum 2 (the checkout's is 1);
- ``double_hint``: the cp.async pieces asking L2 for the whole 128-byte
  line (``B12_L2_HINT=1``); ``double_bulk``: the bulk copies.

The inputs are chip_smoke.py's: the Grid A grid (3200x4000), its radius-2
window pack (P = 32, M = 25) at 1M and 5M uniform Grid A queries (seeds 7
and 9), the same pack 4 bytes off (a copy: not 16-byte aligned) at 1M,
and its radius-1 (P = 16, M = 9) and radius-3 (P = 64, M = 49) packs at
1M; the exponential model.  Each variant is first held bit-equal to ``window_krige_ref`` on the
queries and chip_smoke.py's NaN, inf, out-of-grid, node and half-node ones
(it stops otherwise), then timed by its device duration in the profiler's
kernel records (``chip_smoke.device_ms``, back to back), the checkout's
build timed first and last.  Each line gives the build's registers, spill
bytes, resident blocks an SM and shared memory
(``window_krige_attributes``; the parent's build has no such entry) and its
static SASS instruction count (``scripts/sass_tools.py``).

The split, at 1M and 5M radius-2 queries: the row-gather floor
(``scripts/row_gather_probe.py``, P = 32, the cell from (lon, lat) by
``query_prologue.cuh``: the same rows, one float written) and B12 cut
short after its selection (``scripts/b12_split_probe.cu``: the prologue,
the row, the d2 and the four tournaments), so that selection = cut short -
gather and solve = ``direct`` - cut short; the floor also with each load
asking L2 for its whole line (``.L2::128B``), and at 1M against the span of
the pack its rows lie in (the queries' latitudes squeezed into 1/64 .. 1
of the grid).  Prints one line a case and one JSON line, with the card's
name and power limit.
"""

import argparse
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from auvtpu_torch.kernels import build as kbuild  # noqa: E402
from auvtpu_torch.kernels import scattered_select as ss  # noqa: E402

MIN1 = "-DB12_MIN_BLOCKS_R2=1"
VARIANTS = {
    "direct": ("-DB12_STAGES=0", MIN1),
    "direct_min6": ("-DB12_STAGES=0", "-DB12_MIN_BLOCKS_R2=6"),
    "direct_min8": ("-DB12_STAGES=0", "-DB12_MIN_BLOCKS_R2=8"),
    "single": ("-DB12_STAGES=1", MIN1),
    "single_bulk": ("-DB12_STAGES=1", "-DB12_COPY=1", MIN1),
    "double_min1": (MIN1,),
    "double_min5": ("-DB12_MIN_BLOCKS_R2=5",),
    "double_r3min2": ("-DB12_MIN_BLOCKS_R3=2",),
    "double_hint": ("-DB12_L2_HINT=1",),
    "double_bulk": ("-DB12_COPY=1",),
}
SPLIT_SRC = os.path.join(ROOT, "scripts", "b12_split_probe.cu")
VARIANT_SRC = os.path.join(ROOT, "scripts", "b12_variants.cu")
C_FNS = ("auvtpu_window_krige", "auvtpu_window_krige_attributes", "auvtpu_scattered_error_string")


def build_all(variants: dict, parent: str | None) -> dict:
    """{name: library path}: this checkout's build, each variant, the split
    probe and the parent's build, every nvcc started at once."""
    h = hashlib.sha256()
    for p in sorted(kbuild.CSRC.glob("*.cu*")) + [SPLIT_SRC, VARIANT_SRC]:
        h.update(open(p, "rb").read())
    h.update(" ".join(kbuild.NVCC_FLAGS).encode())
    out_dir = kbuild.BUILD_DIR / f"b12_variants-{h.hexdigest()[:12]}"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {name: (list(flags), VARIANT_SRC) for name, flags in variants.items()}
    jobs["split"] = ([], SPLIT_SRC)
    if parent:
        src = os.path.join(out_dir, "parent_csrc")
        nested = os.path.join(parent, "auvtpu_torch", "csrc")
        shutil.copytree(nested if os.path.isdir(nested) else parent, src, dirs_exist_ok=True)
        jobs["parent"] = ([], os.path.join(src, "scattered_select.cu"))
    procs, paths = {}, {"this": kbuild.build("scattered_select")}
    for name, (flags, src) in jobs.items():
        paths[name] = out_dir / f"lib{name}.so"
        if paths[name].exists():
            continue
        cmd = [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, *flags, "-o", str(paths[name]), src]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:  # a variant that does not build is reported and left out
            print(f"nvcc failed building {name}; left out:\n{log}", flush=True)
            del paths[name]
    return paths


def use(lib_path, real):
    """Make the wrappers launch the library at ``lib_path``; ``real`` is the
    checkout's build, for its argument types."""
    lib = ctypes.CDLL(str(lib_path))
    for fn in C_FNS:
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
            getattr(lib, fn).restype = getattr(real, fn).restype
    ss._lib = lambda: lib
    return lib


def attributes(lib, M: int) -> dict | None:
    if not hasattr(lib, "auvtpu_window_krige_attributes"):
        return None
    return ss.window_krige_attributes(M)


def select_only(lib, pack, g, lons, lats, taps, geo):
    """One launch of the split probe: B12 cut short after its selection."""
    n = int(lons.numel())
    out = torch.empty(n, dtype=torch.float32, device=pack.device)
    err = lib.b12_select_only(pack.data_ptr(), lons.data_ptr(), lats.data_ptr(), taps, n, g.num_lon, g.num_lat, geo,
                              out.data_ptr(), torch.cuda.current_stream(pack.device).cuda_stream)
    if err:
        raise RuntimeError(f"b12_select_only launch failed ({err})")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier auvtpu_torch/csrc, built as the variant 'parent'")
    ap.add_argument("--only", help="comma-separated variants (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b12_variant_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from auvtpu_torch.config import GRID_A_EXTENT, GRID_A_SHAPE
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.ops import packs as tp
    from auvtpu_torch.synthetic import shelf_seamount

    sass = cs.load_script("sass_tools")
    gather = cs.load_script("row_gather_probe")
    card = cs.card_line()
    variants = {k: v for k, v in VARIANTS.items() if not args.only or k in args.only.split(",")}
    paths = build_all(variants, args.parent)
    variants = {k: v for k, v in variants.items() if k in paths}
    par = ["parent"] if "parent" in paths else []
    names = ["this", *par, *variants, *par, "this"]
    real_lib = ss._lib
    real = real_lib()
    dev = torch.device("cuda", 0)
    g = RegularGrid.dense(shelf_seamount(*GRID_A_SHAPE), GRID_A_EXTENT, device=dev)
    packs = {r: tp.build_pack(g, tp.window_offsets(r), clamp=False)[0] for r in (1, 2, 3)}
    shifted = torch.cat([packs[2].new_zeros(1), packs[2]])[1:]  # 4 bytes off: not 16-byte aligned
    odd = [torch.cat(t) for t in zip(cs.odd_queries(GRID_A_EXTENT, *GRID_A_SHAPE, dev),
                                     cs.line_queries(GRID_A_EXTENT, *GRID_A_SHAPE, dev))]
    cases = {}
    for n, seed in ((1_000_000, 7), (5_000_000, 9)):
        q = cs.scattered_queries(GRID_A_EXTENT, *GRID_A_SHAPE, n, seed, dev)
        cases[f"radius2 {n}"] = (2, packs[2], q)
        if n == 1_000_000:
            cases[f"radius2 {n} unaligned"] = (2, shifted, q)
            cases[f"radius1 {n}"] = (1, packs[1], q)
            cases[f"radius3 {n}"] = (3, packs[3], q)
    want = {}
    for case, (r, pk, q) in cases.items():
        qc = [torch.cat([a, b]) for a, b in zip(q, odd)]
        want[case] = (qc, ss.window_krige_ref(pk, tp.pack_width(len(tp.window_offsets(r))),
                                               tp.window_offsets(r), r, g, *qc))
    torch.cuda.synchronize()
    res = {"card": card, "variants": {}, "split": {}}
    for name in names:
        lib = use(paths[name], real)
        row = res["variants"].setdefault(name, {"flags": VARIANTS.get(name, ("parent",) if name == "parent" else ()),
                                                "cases": {}})
        kernel = "b12_variant_kernel" if name in VARIANTS else "window_krige_kernel"
        for case, (r, pk, q) in cases.items():
            offs = tp.window_offsets(r)
            P, M = tp.pack_width(len(offs)), len(offs)
            qc, ref = want[case]
            got = ss.window_krige(pk, P, offs, r, g, *qc)
            torch.cuda.synchronize()
            if not torch.equal(torch.nan_to_num(got, nan=-7.0), torch.nan_to_num(ref, nan=-7.0)):
                raise AssertionError(f"variant {name}: {case} differs from window_krige_ref "
                                     f"({int((got != ref).sum())} values)")
            t = cs.device_ms(lambda: ss.window_krige(pk, P, offs, r, g, *q), kernel)
            at = attributes(lib, M)
            n_sass = sass.sass_instructions(str(paths[name]), f"{kernel}<{M}, {P}" + ("" if name in VARIANTS else ", 0"))
            row["cases"].setdefault(case, []).append(t)
            row[f"M={M}"] = {**(at or {}), "sass_instructions": n_sass}
            res_ = (f"{at['registers']} registers, {at['spill_bytes']} spill bytes, {at['blocks_per_sm']} blocks/SM, "
                    f"{at['shared_bytes']} B shared" if at else "resources not reported")
            print(f"{name:13s} {case:26s} {t:.4f} ms  bit-equal to plain  M={M}: {res_}, {n_sass} SASS "
                  f"instructions  [{card}]", flush=True)
    # the split, on the design before the staging
    ss._lib = real_lib
    split = ctypes.CDLL(str(paths["split"]))
    P_ = ctypes.c_void_p
    split.b12_select_only.argtypes = [P_, P_, P_, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.POINTER(ctypes.c_float), P_, P_]
    split.b12_select_only.restype = ctypes.c_int
    offs2 = tp.window_offsets(2)
    taps_t = ss._window_krige_taps(ss._offs_key(offs2), 32, 2)
    taps = (ctypes.c_float * taps_t.numel())(*taps_t.tolist())
    geo = (ctypes.c_float * 10)(*ss._krige_geo(g, "reference").f32.tolist())
    for case, (r, pk, q) in cases.items():
        if r != 2 or pk is shifted:
            continue
        cell = ss.prologue(g, *q)[5].to(torch.int32).contiguous()
        t_gather = gather.floor_ms(cs, packs[2], 32, 1, cell, *q, g)
        t_hint = gather.floor_ms(cs, packs[2], 32, 2, cell, *q, g)
        t_select = cs.device_ms(lambda: select_only(split, packs[2], g, *q, taps, geo), "b12_select_only_kernel")
        t_direct = res["variants"].get("direct", {}).get("cases", {}).get(case, [None])[0]
        n_q = q[0].numel()
        byte_bound = n_q * (8 + 32 * 4 + 4) / gather.HBM_BYTES_PER_S * 1e3
        res["split"][case] = {"gather_ms": t_gather, "gather_l2_128b_ms": t_hint, "select_only_ms": t_select,
                              "direct_ms": t_direct, "byte_bound_ms": byte_bound}
        solve = f"{t_direct - t_select:.4f}" if t_direct is not None else "not measured (no 'direct' variant)"
        print(f"split {case}: row gather {t_gather:.4f} ms ({t_hint:.4f} with the L2::128B hint), selection "
              f"{t_select - t_gather:.4f} ms (cut short after it: {t_select:.4f}), solve {solve} ms; byte bound "
              f"{byte_bound:.4f} ms  [{card}]", flush=True)
    # the row gather's time against the span of the rows it reads: the 1M
    # queries' latitudes squeezed into a band of the grid, the same number
    # of random rows over 1/64 .. 1 of the 1.64 GB pack
    lons1, lats1 = cases["radius2 1000000"][2]
    res["span"] = []
    for frac in (1 / 64, 1 / 16, 1 / 4, 1.0):
        lat_f = (GRID_A_EXTENT.min_lat + (lats1.double() - GRID_A_EXTENT.min_lat) * frac).float()
        cell = ss.prologue(g, lons1, lat_f)[5].to(torch.int32).contiguous()
        t = gather.floor_ms(cs, packs[2], 32, 1, cell, lons1, lat_f, g)
        mb = frac * packs[2].numel() * 4 / 2**20
        res["span"].append({"fraction": frac, "span_mib": mb, "ms": t})
        print(f"row gather 1M radius-2 rows over {frac:.4g} of the grid ({mb:.0f} MiB of pack): {t:.4f} ms  "
              f"[{card}]", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
