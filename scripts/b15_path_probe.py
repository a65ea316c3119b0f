"""B15 (``window_idw_kernel``) in its designs, each held bit-equal to the
plain version before it is timed, the powers it matches bit for bit, and
B12 beside it, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 scripts/b15_path_probe.py [--parent DIR] [--sass-dir DIR]

The builds, all started at once, one nvcc each, with the checkout's flags:

- ``this``: the checkout's ``csrc/scattered_select.cu``.  At radius 2 and
  3 on an aligned pack a persistent grid of warps stages each warp's 32
  rows in shared memory by cp.async, the next chunk's in flight while this
  one is served; the row stays there, the prologue runs once a query, the
  k 4 and 8 builds' passes run on 32-bit keys (the exact tournament where
  the keys cannot vouch), each winner's value one shared load.  Radius 1
  and a pack 4 bytes off take the rows straight into registers, one query
  a thread.

Each of the next is the checkout's source with one line of its B15
section patched as text (the probe stops if the line is not there once):

- ``registers``: ``kIdwStaged`` false: the first design, rows straight
  into registers in every build.
- ``staged_all``: ``kIdwStaged`` true, radius 1 staged too.
- ``stages3``: ``kIdwStages = 3``, three chunks a warp in shared memory
  (four blocks an SM where two stages hold six).
- ``exact_passes``: no ``keyed_topk``: the k 4 and 8 builds' passes as
  the exact tournament with its knock-out, unrolled, where ``this`` takes
  them on 32-bit keys (one subtract a tap and one unsigned min a match a
  pass, no knock-out) and falls back to the tournament where the keys
  cannot vouch for the order; the weights after the passes in both.
- ``in_pass``: every staged build on the general build's path, the
  tournament in a loop, each pass's weight and sums in the pass.

And:

- ``staged_vals``: ``scripts/b15_variants.cu``, the first staged design (B12's
  row loop: the row unstaged into registers beside d2, the tournament
  carrying the value, the prologue computed twice).
- ``parent`` (``--parent DIR``): the ``scattered_select.cu`` of an earlier
  ``auvtpu_torch/csrc`` (``git archive <commit> auvtpu_torch/csrc | tar -x
  -C DIR``, DIR a git-ignored directory), for B12 across the change.

The inputs are chip_smoke.py's: the Grid A grid (3200x4000), its window
packs of radius 1-3, 1M and 5M uniform Grid A queries (seeds 7 and 9)
after chip_smoke.py's NaN, inf, 1e30, out-of-grid, node and half-node
queries, and the radius-2 pack 4 bytes off (a copy: not 16-byte aligned).

1. The checkout's build against ``window_idw_ref``: radius 1-3, aligned
   and unaligned, k 1, 4, 8 and P, powers 2, 1 and 3, at 1M; k 8 at 5M.
   Then the powers of torch's special cases and a few others at radius 2,
   k 8: bit-equal or not, the values that differ and their largest
   relative difference.  It exits 1 where power 2 or 1 is not bit-equal.
2. The designs at radius 2, k 8 and 4, power 2, at 1M and 5M, each
   bit-checked, then timed by the device duration of its kernel records
   (``chip_smoke.device_ms``), in the order registers, this, the others,
   this, registers; each build's registers, spill bytes, resident blocks,
   shared memory and stages (``window_idw_attributes``), its kernel's
   static SASS count, that of its innermost loops that hold a tournament's
   VIMNMX (``scripts/sass_tools.py``; a build whose passes are unrolled
   counts its chunk loop), its commonest opcodes and its min instructions;
   with ``--sass-dir DIR`` the kernel's SASS is written to
   ``DIR/b15_sass_<build>.txt``.
3. Radius 1 and 3: ``registers`` against ``staged_all`` at k 8 and 4, 1M,
   bit-checked and timed, registers, staged, staged, registers (``this``
   stages radius 3, which was faster staged, and not radius 1, which was
   not).
4. B12 (``window_krige_kernel``), this build and the parent's, bit-equal
   to ``window_krige_ref``, timed this, parent, parent, this at radius 2,
   1M and 5M.
5. ``packed_idw_fused`` at 1M radius 2 (k 8, power 2) by CUDA events
   against the composition it replaces, ``idw_from_select`` after
   ``window_select_fused``: old, new, new, old.

Prints one line a case and one JSON line, with the card's name and power
limit.
"""

import argparse
import collections
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

VARIANT_SRC = os.path.join(ROOT, "scripts", "b15_variants.cu")
# the shipped source with one line of its B15 section patched: (line, patched)
STAGED = "constexpr bool kIdwStaged = M > 16;"
PATCHES = {"registers": (STAGED, "constexpr bool kIdwStaged = false;"),
           "staged_all": (STAGED, "constexpr bool kIdwStaged = true;"),
           "stages3": ("constexpr int kIdwStages = 2;", "constexpr int kIdwStages = 3;"),
           "exact_passes": ("    if (fx == fx && fy == fy) found = keyed_topk<M, K>(row, taps, fx, fy, mk, ik);\n", ""),
           "in_pass": ("  if constexpr (K > 0) {\n    float mk[K];", "  if constexpr (K < 0) {\n    float mk[K];")}
DESIGNS = ("registers", "this", "exact_passes", "in_pass", "stages3", "staged_vals", "staged_all", "this", "registers")

C_FNS = ("auvtpu_window_idw", "auvtpu_window_idw_attributes", "auvtpu_window_krige",
         "auvtpu_window_krige_attributes", "auvtpu_scattered_error_string")
POWERS = (2.0, 1.0, 3.0, 0.0, 4.0, 6.0, -1.0, -2.0, -4.0, 0.5, 2.5, 1.5)


def kernel_of(name: str) -> str:
    """The name of a build's B15 kernel in the profiler's records."""
    return "b15_staged_kernel" if name == "staged_vals" else "window_idw_kernel"


def build_all(parent: str | None) -> dict:
    """{name: library path}: the checkout's build, the variants and the
    parent's build, every nvcc started at once."""
    h = hashlib.sha256()
    for p in [*sorted(kbuild.CSRC.glob("*.cu*")), VARIANT_SRC]:
        h.update(open(p, "rb").read())
    h.update(" ".join(kbuild.NVCC_FLAGS).encode())
    out_dir = kbuild.BUILD_DIR / f"b15_paths-{h.hexdigest()[:12]}"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (kbuild.CSRC / "scattered_select.cu").read_text()
    jobs = {"staged_vals": VARIANT_SRC}
    for name, (old, new) in PATCHES.items():
        if src.count(old) != 1:
            raise AssertionError(f"b15_path_probe: {old!r} is {src.count(old)} times in scattered_select.cu, want 1")
        csrc = out_dir / name
        shutil.copytree(kbuild.CSRC, csrc, dirs_exist_ok=True)
        (csrc / "scattered_select.cu").write_text(src.replace(old, new))
        jobs[name] = str(csrc / "scattered_select.cu")
    if parent:
        dst = os.path.join(out_dir, "parent_csrc")
        nested = os.path.join(parent, "auvtpu_torch", "csrc")
        shutil.copytree(nested if os.path.isdir(nested) else parent, dst, dirs_exist_ok=True)
        jobs["parent"] = os.path.join(dst, "scattered_select.cu")
    procs, paths = {}, {}
    for name, src_ in jobs.items():
        paths[name] = out_dir / f"lib{name}.so"
        if paths[name].exists():
            continue
        cmd = [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", str(paths[name]), src_]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    paths["this"] = kbuild.build("scattered_select")
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed building {name}:\n{log}")
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


def differ(got, want) -> tuple[int, float]:
    """(values that differ, NaN placement included; the largest relative
    difference where both are numbers)."""
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    ok = ~nan_w & ~nan_g
    a, b = got[ok], want[ok]
    n = int((nan_g != nan_w).sum()) + int((a.view(torch.int32) != b.view(torch.int32)).sum())
    rel = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()) if a.numel() else 0.0
    return n, rel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier auvtpu_torch/csrc, built as 'parent' (B12 across the change)")
    ap.add_argument("--sass-dir", help="a directory to write each build's B15 SASS into")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b15_path_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from auvtpu_torch.config import GRID_A_EXTENT, GRID_A_SHAPE, IDWConfig
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.ops import packs as tp
    from auvtpu_torch.synthetic import shelf_seamount

    sass = cs.load_script("sass_tools")
    card = cs.card_line()
    paths = build_all(args.parent)
    real_lib = ss._lib
    real = real_lib()
    dev = torch.device("cuda", 0)
    g = RegularGrid.dense(shelf_seamount(*GRID_A_SHAPE), GRID_A_EXTENT, device=dev)
    packs = {r: tp.build_pack(g, tp.window_offsets(r), clamp=False)[0] for r in (1, 2, 3)}
    shifted = torch.cat([packs[2].new_zeros(1), packs[2]])[1:]  # 4 bytes off: not 16-byte aligned
    odd = [torch.cat(t) for t in zip(cs.odd_queries(GRID_A_EXTENT, *GRID_A_SHAPE, dev),
                                     cs.line_queries(GRID_A_EXTENT, *GRID_A_SHAPE, dev))]
    q1 = cs.scattered_queries(GRID_A_EXTENT, *GRID_A_SHAPE, 1_000_000, 7, dev)
    q5 = cs.scattered_queries(GRID_A_EXTENT, *GRID_A_SHAPE, 5_000_000, 9, dev)
    q1o, q5o = ([torch.cat([a, b]) for a, b in zip(q, odd)] for q in (q1, q5))
    res = {"card": card, "checks": [], "powers": {}, "paths": {}, "radii": {}, "b12": {}, "events": {}}
    bad = []

    def idw(pk, r, q, **kw):
        offs = tp.window_offsets(r)
        return ss.window_idw(pk, tp.pack_width(len(offs)), offs, r, g, *q, **kw)

    def idw_ref(pk, r, q, **kw):
        offs = tp.window_offsets(r)
        return ss.window_idw_ref(pk, tp.pack_width(len(offs)), offs, r, g, *q, **kw)

    # 1. the checkout's build against the plain version
    use(paths["this"], real)
    cases = [(f"radius {r}", r, packs[r]) for r in (1, 2, 3)] + [("radius 2 unaligned", 2, shifted)]
    for label, r, pk in cases:
        P = tp.pack_width(len(tp.window_offsets(r)))
        for k in (1, 4, 8, P):
            for power in (2.0, 1.0, 3.0):
                n_, rel = differ(idw(pk, r, q1o, k=k, power=power), idw_ref(pk, r, q1o, k=k, power=power))
                res["checks"].append({"case": label, "n": q1o[0].numel(), "k": k, "power": power, "differ": n_,
                                      "rel": rel})
                if n_ and power in (2.0, 1.0):
                    bad.append((label, k, power, n_))
                print(f"check {label} 1M k={k} power {power:g}: {'bit-equal' if not n_ else f'{n_} differ, rel {rel:.3g}'}",
                      flush=True)
    n_, rel = differ(idw(packs[2], 2, q5o, k=8), idw_ref(packs[2], 2, q5o, k=8))
    res["checks"].append({"case": "radius 2", "n": q5o[0].numel(), "k": 8, "power": 2.0, "differ": n_, "rel": rel})
    bad += [("radius 2 5M", 8, 2.0, n_)] if n_ else []
    print(f"check radius 2 5M k=8 power 2: {'bit-equal' if not n_ else f'{n_} differ'}", flush=True)
    for power in POWERS:
        n_, rel = differ(idw(packs[2], 2, q1o, k=8, power=power), idw_ref(packs[2], 2, q1o, k=8, power=power))
        mode = ss._pow_mode(power)[0]
        res["powers"][str(power)] = {"mode": mode, "differ": n_, "rel": rel}
        print(f"power {power:g} (mode {mode}) radius 2 1M k=8: "
              f"{'bit-equal' if not n_ else f'{n_} of {q1o[0].numel()} differ, max relative {rel:.3g}'}", flush=True)
    torch.cuda.synchronize()

    # 2. the designs at radius 2
    for name in DESIGNS:
        lib = use(paths[name], real)
        row = res["paths"].setdefault(name, {"cases": {}})
        for k in (8, 4):
            for tag, q, qo in (("1M", q1, q1o), ("5M", q5, q5o)):
                n_, _ = differ(idw(packs[2], 2, qo, k=k), idw_ref(packs[2], 2, qo, k=k))
                if n_:
                    raise AssertionError(f"{name}: radius 2 {tag} k={k} differs from window_idw_ref ({n_} values)")
                t = cs.device_ms(lambda: idw(packs[2], 2, q, k=k), kernel_of(name))
                row["cases"].setdefault(f"k={k} {tag}", []).append(t)
                print(f"{name:11s} radius 2 k={k} {tag}: {t:.4f} ms, bit-equal to plain  [{card}]", flush=True)
        if "resources" not in row:
            at = {f"M={M} k={k}": ss.window_idw_attributes(M, k) for M in (9, 25, 49) for k in (8, 4, 3)}
            row["resources"] = at
            fn = f"{kernel_of(name)}<25, 32, 8>"
            row["sass_instructions"] = sass.sass_instructions(str(paths[name]), fn)
            row["pass_loops"] = sass.loop_instructions(str(paths[name]), fn, "VIMNMX")
            (_, text), = sass.sass_functions(str(paths[name]), [fn])
            ops = collections.Counter(sass._OPCODE.findall(text))
            row["opcodes"] = dict(ops.most_common(12))
            # the tournaments' min instructions (DPX: VIMNMX, VIMNMX3, the
            # fused add-and-min VIADDMNMX of the keyed passes)
            row["min_opcodes"] = {op: n for op, n in ops.items() if "MNMX" in op}
            if args.sass_dir:
                os.makedirs(args.sass_dir, exist_ok=True)
                with open(os.path.join(args.sass_dir, f"b15_sass_{name}.txt"), "w") as f:
                    f.write(text)
            print(f"{name}: {json.dumps(at)}; {fn}: {row['sass_instructions']} SASS instructions, pass loops "
                  f"{row['pass_loops']}, opcodes {row['opcodes']}, min instructions {row['min_opcodes']}",
                  flush=True)
        del lib

    # 3. radius 1 and 3 staged, against their rows in registers
    for name in ("registers", "staged_all", "staged_all", "registers"):
        use(paths[name], real)
        row = res["radii"].setdefault(name, {})
        for r in (1, 3):
            for k in (8, 4):
                n_, _ = differ(idw(packs[r], r, q1o, k=k), idw_ref(packs[r], r, q1o, k=k))
                if n_:
                    raise AssertionError(f"{name}: radius {r} k={k} differs from window_idw_ref ({n_} values)")
                t = cs.device_ms(lambda: idw(packs[r], r, q1, k=k), "window_idw_kernel")
                row.setdefault(f"radius {r} k={k} 1M", []).append(t)
                print(f"{name:11s} radius {r} k={k} 1M: {t:.4f} ms, bit-equal to plain  [{card}]", flush=True)

    # 4. B12 across the change, against the parent's build
    offs2 = tp.window_offsets(2)
    for name in ("this", "parent", "parent", "this") if "parent" in paths else ("this",):
        use(paths[name], real)
        for tag, q, qo in (("1M", q1, q1o), ("5M", q5, q5o)):
            got = ss.window_krige(packs[2], 32, offs2, 2, g, *qo)
            n_, _ = differ(got, ss.window_krige_ref(packs[2], 32, offs2, 2, g, *qo))
            if n_:
                raise AssertionError(f"B12 {name}: radius 2 {tag} differs from window_krige_ref ({n_} values)")
            t = cs.device_ms(lambda: ss.window_krige(packs[2], 32, offs2, 2, g, *q), "window_krige_kernel")
            res["b12"].setdefault(name, {}).setdefault(tag, []).append(t)
            print(f"B12 {name:6s} radius 2 {tag}: {t:.4f} ms, bit-equal to plain  [{card}]", flush=True)

    # 5. packed_idw_fused's events against the composition it replaces
    # (B7 too: the checkout's library as the wrappers load it)
    ss._lib = real_lib
    eps = IDWConfig(k=8).eps
    calls = {"new": lambda: ss.packed_idw_fused(packs[2], g, *q1, k=8),
             "old": lambda: tp.idw_from_select(ss.window_select_fused(packs[2], g, *q1, k=8), power=2.0, eps=eps)}
    for name in ("old", "new", "new", "old"):
        t = cs.time_ms(calls[name])
        res["events"].setdefault(name, []).append(t)
        print(f"packed_idw_fused {name} at 1M radius 2 k=8: events {t:.4f} ms  [{card}]", flush=True)

    print(json.dumps(res), flush=True)
    if bad:
        print(f"b15_path_probe: power 2 or 1 not bit-equal: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
