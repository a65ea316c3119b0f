"""B3 and B8 of this checkout against another version of their sources, on
one NVIDIA GPU.

Run from the root of a checkout:

    python3 scripts/kernel_ab.py --parent DIR

where DIR holds the other version (``git archive <commit> auvtpu_torch/csrc
| tar -x -C DIR``, into a directory .gitignore lists).  Its
``csrc/window_fill.cu`` and ``csrc/band_resample.cu`` are built with the
same nvcc flags and called through their C interfaces.  The script knows
two interfaces and reads which one the other version has from its sources:
this checkout's, and the earlier one of commit 9ff8bad and before (B3 on a
NaN-padded plane, B8 on band-frame coordinates padded to whole chunks, as
that version's wrappers fed them).  Any other interface stops it before a
launch.

The inputs are chip_smoke.py's: the Kerguelen stand-in r0.20 (B3 idw k=8
and mean k=4 at R=10, a 256x256 window view at R=5 as the streaming refresh
reads it) and the 5M-ping band weave on the B1-filled band of the stand-in
r0.10 (B8 with hat weights and the default window, at chunks 2048 and 512).
Each kernel is timed by its device duration in the profiler's kernel
records (CUPTI), so no host time enters: back to back (inputs warm in the
L2) and cold (a 128 MB write before each launch), in the order other,
this, this, other.  Prints the card's name and power limit beside the
numbers.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from auvtpu_torch.grid import RegularGrid  # noqa: E402
from auvtpu_torch.kernels import band_resample as kb  # noqa: E402
from auvtpu_torch.kernels import build as kbuild  # noqa: E402
from auvtpu_torch.kernels import window_fill as wf  # noqa: E402
from auvtpu_torch.ops import band as tband  # noqa: E402

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the earlier interface: the parameter lists of auvtpu_fill and
# auvtpu_band_resample at commit 9ff8bad, and their ctypes argument types
EARLIER = {
    "auvtpu_fill": ("const void* nanp, const void* tab, const void* wtab, int m, int H, int W, int R, int kind, "
                    "int k, float eps, void* out, void* stream", [P, P, P, I, I, I, I, I, I, F, P, P]),
    "auvtpu_band_resample": (
        "const void* planes, const void* vmasks, const void* origins, int K, int R, int C, const void* x, "
        "const void* y, int n, int chunk, int wh, int ww, int ar, int ac, int lim_r, int lim_c, int masked, "
        "int pick, int hat, float thresh, void* z, void* ok, void* stream",
        [P, P, P, I, I, I, P, P, I, I, I, I, I, I, I, I, I, I, I, F, P, P, P]),
}


def signature(src: str, fn: str) -> str:
    """The parameter list of ``fn`` in the C source ``src``, whitespace
    normalised."""
    m = re.search(rf"\bint {fn}\(([^)]*)\)", open(src).read())
    if m is None:
        raise SystemExit(f"{src}: no 'int {fn}(...)'")
    return " ".join(m.group(1).split())


def build_other(parent: str, name: str, fn: str) -> tuple[ctypes.CDLL, bool]:
    """The other version's library and whether it has the earlier interface
    (False: this checkout's)."""
    src = os.path.join(parent, "auvtpu_torch", "csrc", f"{name}.cu")
    sig = signature(src, fn)
    earlier = sig == EARLIER[fn][0]
    if not earlier and sig != signature(os.path.join(kbuild.CSRC, f"{name}.cu"), fn):
        raise SystemExit(f"{src}: {fn}({sig}) is neither this checkout's interface nor the earlier one")
    out = os.path.join(kbuild.BUILD_DIR, f"other_{name}.so")
    os.makedirs(kbuild.BUILD_DIR, exist_ok=True)
    subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", out, src], check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    getattr(lib, fn).argtypes = EARLIER[fn][1] if earlier else getattr(kb._lib() if name == "band_resample"
                                                                       else wf._lib(), fn).argtypes
    return lib, earlier


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="root of the other version's checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    old_wf, wf_earlier = build_other(args.parent, "window_fill", "auvtpu_fill")
    old_kb, kb_earlier = build_other(args.parent, "band_resample", "auvtpu_band_resample")
    stream = wf._stream(dev)
    print(f"other version's interfaces: B3 {'earlier' if wf_earlier else 'this'}, "
          f"B8 {'earlier' if kb_earlier else 'this'}", flush=True)

    # B3 on the stand-in r0.20 and on a 256x256 window view at R=5
    grid2, *_ = cs.bench_workload(dev, 0.20)
    win = RegularGrid(grid2.elev[700:956, 300:556], grid2.valid[700:956, 300:556], 0.0, 255.0, 0.0, 255.0)
    cases = []
    for label, g, R, kind, k in (("stand-in r0.20 idw k=8 R=10", grid2, 10, 0, 8),
                                 ("stand-in r0.20 mean k=4 R=10", grid2, 10, 1, 4),
                                 ("256x256 window view idw k=8 R=5", win, 5, 0, 8)):
        if wf_earlier:
            h, w = g.shape
            tab = wf._device_table(R, "reference", dev)
            wtab = wf._device_weights(R, 2.0, "reference", dev)
            out = torch.empty((h, w), device=dev)
            nanp = wf._nan_padded(g, R)  # that version's wrapper built it before each launch

            def old(R=R, kind=kind, k=k, tab=tab, wtab=wtab, out=out, h=h, w=w, nanp=nanp):
                old_wf.auvtpu_fill(nanp.data_ptr(), tab.data_ptr(), wtab.data_ptr(), tab.shape[0], h, w, R, kind, k,
                                   1e-12, out.data_ptr(), stream)

            cases.append((label, old, "fill_kernel", cs.b3_launcher(g, kind, k, R), "fill_tile_kernel"))
        else:
            cases.append((label, cs.b3_launcher(g, kind, k, R, lib=old_wf), "fill_tile_kernel",
                          cs.b3_launcher(g, kind, k, R), "fill_tile_kernel"))

    # B8 on the 5M band weave
    grid, *_ = cs.bench_workload(dev, 0.10)
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
        if kb_earlier:
            def old(chunk=chunk):
                old_kb.auvtpu_band_resample(band.plane.data_ptr(), None, org.data_ptr(), K, R_, C_, x.data_ptr(),
                                            y.data_ptr(), x.numel(), chunk, *geo, 0, 0, int(kw["hat"]),
                                            kb.WSUM_THRESH, zo.data_ptr(), oko.data_ptr(), stream)
        else:
            old = cs.b8_launcher(b_args, kw, lib=old_kb)
        cases.append((f"band weave {cs.N_BAND} pings chunk {chunk}", old, "band_resample_",
                      cs.b8_launcher(b_args, kw), "band_resample_"))

    for label, old, old_name, new, new_name in cases:
        for cold in (False, True):
            t = [cs.device_ms(old, old_name, cold=cold), cs.device_ms(new, new_name, cold=cold),
                 cs.device_ms(new, new_name, cold=cold), cs.device_ms(old, old_name, cold=cold)]
            print(f"{label:36s} {'cold' if cold else 'back to back':12s} other {t[0]:.4f} / {t[3]:.4f} ms, "
                  f"this {t[1]:.4f} / {t[2]:.4f} ms  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
