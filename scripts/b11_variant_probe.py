"""B11 (``select_krige_kernel``) built in the variants that put more pack
rows in flight, each held bit-equal to this checkout's build and timed, on
one NVIDIA GPU.

Run from the root of a checkout:

    python3 scripts/b11_variant_probe.py

Each variant is a copy of ``csrc/`` with ``scattered_select.cu`` patched as
text (the probe stops if a patch no longer matches the source), built with
the checkout's nvcc flags, all builds at once, one nvcc each:

- ``minB``: ``__launch_bounds__``'s minimum of resident blocks an SM for
  the builds of at most 16 taps set to B (the checkout asks for 8), which
  caps the registers a thread;
- ``qpt2_minB``: two queries a thread, kSelThreads apart, both rows loaded
  before either tournament (radius 3's 49 taps keep one), with minimum B.

The inputs are chip_smoke.py's: the Grid A grid (3200x4000), its valid16
pack and radius-2 pack, 1M and 5M uniform Grid A queries.  For each
variant and case: the build's registers, spill bytes and resident blocks an
SM (``krige_attributes``), its static SASS instruction count, the output
bit-equal to the checkout's build (it stops otherwise), and its device
duration in the profiler's kernel records (``chip_smoke.device_ms``, back
to back), the checkout's own build timed first and last.  Prints one line a
case and one JSON line, with the card's name and power limit.
"""

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

BOUNDS = "__launch_bounds__(kSelThreads, M <= 16 ? 8 : 1)"
GRID = ("const dim3 g((unsigned)((n + kSelThreads - 1) / kSelThreads));\n"
        "  void* args[] = {&pack, &lons, &lats, &tv, &par, &n, &out};")
KERNEL_HEAD = "template <int M, int P, int MODEL>\n__global__ void " + BOUNDS + "\nselect_krige_kernel("
# the two-query kernel, in place of the checkout's (its head up to the end
# of its body); {bounds} is the variant's __launch_bounds__
TWO_QUERIES = """template <int M, int P, int MODEL>
__global__ void {bounds}
select_krige_kernel(const float* __restrict__ pack, const float* __restrict__ lons,
                    const float* __restrict__ lats, const __grid_constant__ KrigeTaps<M> taps,
                    const KrigeParams par, int n, float* __restrict__ out) {{
  static_assert(M <= P, "a pack row holds its taps");
  constexpr int Q = M <= 25 ? 2 : 1;
  const int q0 = blockIdx.x * (kSelThreads * Q) + threadIdx.x;
  float lon[Q], lat[Q];
  QueryCell qc[Q];
  float val[Q][M];
#pragma unroll
  for (int j = 0; j < Q; ++j) {{
    const int q = q0 + j * kSelThreads;
    if (q < n) {{
      lon[j] = __ldg(lons + q);
      lat[j] = __ldg(lats + q);
      qc[j] = query_cell(lon[j], lat[j], par.geo);
      load_row<M, true>(pack + (size_t)(qc[j].cj * par.geo.W + qc[j].ci) * P, val[j]);
    }}
  }}
#pragma unroll
  for (int j = 0; j < Q; ++j) {{
    const int q = q0 + j * kSelThreads;
    if (q < n) krige_query<M, MODEL>(val[j], qc[j], lon[j], lat[j], taps, par, n, q, out);
  }}
}}
"""
TWO_QUERY_GRID = ("constexpr int Q = M <= 25 ? 2 : 1;\n"
                  "  const dim3 g((unsigned)((n + kSelThreads * Q - 1) / (kSelThreads * Q)));\n"
                  "  void* args[] = {&pack, &lons, &lats, &tv, &par, &n, &out};")


def replace_once(text: str, old: str, new: str, what: str) -> str:
    if text.count(old) != 1:
        raise AssertionError(f"b11_variant_probe: {what} is {text.count(old)} times in scattered_select.cu, want 1")
    return text.replace(old, new)


def patched(src: str, min_blocks: int, qpt: int) -> str:
    """scattered_select.cu with B11's minimum of resident blocks and its
    queries a thread set."""
    bounds = f"__launch_bounds__(kSelThreads, M <= 16 ? {min_blocks} : 1)"
    if qpt == 1:
        return replace_once(src, BOUNDS, bounds, "B11's launch bounds")
    a = src.index(KERNEL_HEAD)
    b = src.index("\n}\n", a) + 3
    src = src[:a] + TWO_QUERIES.format(bounds=bounds) + src[b:]
    return replace_once(src, GRID, TWO_QUERY_GRID, "B11's grid")


def build_variants(variants: dict) -> dict:
    """{name: library path} of {name: (min_blocks, qpt)}, every build
    started at once."""
    src = (kbuild.CSRC / "scattered_select.cu").read_text()
    h = hashlib.sha256()
    for p in sorted(kbuild.CSRC.glob("*.cu*")):
        h.update(p.read_bytes())
    out_dir = kbuild.BUILD_DIR / f"b11_variants-{h.hexdigest()[:12]}"
    procs, paths = {}, {}
    for name, (min_blocks, qpt) in variants.items():
        csrc = out_dir / name
        paths[name] = out_dir / f"libscattered_select_{name}.so"
        if paths[name].exists():
            continue
        shutil.copytree(kbuild.CSRC, csrc, dirs_exist_ok=True)
        (csrc / "scattered_select.cu").write_text(patched(src, min_blocks, qpt))
        cmd = [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", str(paths[name]), str(csrc / "scattered_select.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed building variant {name}:\n{log}")
    return paths


def use(lib_path, real):
    """Make the wrappers launch the library at ``lib_path``; ``real`` is the
    checkout's build, for its argument types."""
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("auvtpu_select_krige", "auvtpu_select_krige_attributes", "auvtpu_scattered_error_string"):
        getattr(lib, fn).argtypes = getattr(real, fn).argtypes
        getattr(lib, fn).restype = getattr(real, fn).restype
    ss._lib = lambda: lib


def main() -> int:
    if not torch.cuda.is_available():
        print("b11_variant_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from auvtpu_torch.config import GRID_A_EXTENT, GRID_A_SHAPE
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.ops import packs as tp
    from auvtpu_torch.synthetic import shelf_seamount

    sass = cs.load_script("sass_tools")
    card = cs.card_line()
    variants = {f"min{b}": (b, 1) for b in (1, 4, 6)}
    variants.update({f"qpt2_min{b}": (b, 2) for b in (1, 4, 6, 8)})
    paths = {"this": kbuild.build("scattered_select"), **build_variants(variants)}
    real_lib = ss._lib
    real = real_lib()
    dev = torch.device("cuda", 0)
    g = RegularGrid.dense(shelf_seamount(*GRID_A_SHAPE), GRID_A_EXTENT, device=dev)
    p16 = tp.build_valid16_pack(g)
    win = tp.build_pack(g, tp.window_offsets(2), clamp=False)[0]
    cases = {}
    for n, seed in ((1_000_000, 7), (5_000_000, 9)):
        q = cs.scattered_queries(GRID_A_EXTENT, *GRID_A_SHAPE, n, seed, dev)
        cases[f"valid16 {n}"] = (p16, 16, tp.VALID16_OFFSETS, q, {}, 16)
        if n == 1_000_000:
            cases[f"radius2 resolved {n}"] = (win, 32, tp.window_offsets(2), q, dict(resolve_thresh=4.0), 25)
    want, res = {}, {"card": card, "variants": {}}
    for name in ["this", *variants, "this"]:
        use(paths[name], real)
        row = res["variants"].setdefault(name, {"min_blocks, qpt": variants.get(name, (8, 1)), "cases": {}})
        for case, (pack, P, offs, q, kw, M) in cases.items():
            out = ss.select_krige(pack, P, offs, 2, g, *q, **kw)
            torch.cuda.synchronize()
            if name == "this" and case not in want:
                want[case] = out.clone()
            elif not torch.equal(torch.nan_to_num(out, nan=-7.0), torch.nan_to_num(want[case], nan=-7.0)):
                raise AssertionError(f"variant {name}: {case} differs from the checkout's build")
            t = cs.device_ms(lambda: ss.select_krige(pack, P, offs, 2, g, *q, **kw), "select_krige_kernel")
            attrs = ss.krige_attributes(M)
            n_sass = sass.sass_instructions(str(paths[name]), f"select_krige_kernel<{M}, {P}, 0>")
            row["cases"].setdefault(case, []).append(t)
            row[f"M={M}"] = {**attrs, "sass_instructions": n_sass}
            print(f"{name:10s} {case:24s} {t:.4f} ms  M={M}: {attrs['registers']} registers, "
                  f"{attrs['spill_bytes']} spill bytes, {attrs['blocks_per_sm']} blocks/SM, "
                  f"{n_sass} SASS instructions  [{card}]", flush=True)
    ss._lib = real_lib
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
