"""Wrapper of exact mode's query preparation kernel B16
(``csrc/exact_prologue.cu``) and its plain version (the counterpart of the
JAX package's host numpy :func:`auvtpu.ops.exact.prepare_exact_queries`
and ``_prepare_scattered``).

B16 (``prologue_kernel``), one thread a query, in float64: the reference
harness's index -> geo -> grid round-trip of cell-aligned queries (int32 or
int64 columns and rows) or the normalisation of raw coordinates (float64
longitudes and latitudes); the out-of-grid flag; the round (kriging) or
floor (bilinear, bicubic) anchors; for cell-aligned queries the scaled
residue keys, the anchor variant, the two-tier path's aligned mask and the
query cell; and two counts on the device: the queries whose keys are not
exact in float32 (the host raises where any is) and, with the aligned
mask, the queries not aligned.  ``fields`` (:data:`KEYS`, :data:`GEO`,
:data:`GRID`, :data:`ALIGNED`, :data:`FLAT`) chooses what is written; the
anchors, the flag and the counts always are.

:func:`prologue` goes through the custom op ``auvtpu_torch::exact_prologue``
(:mod:`.library`): on CPU tensors the op runs :func:`prologue_ref`, the same
function as torch float64 ops; on CUDA tensors :func:`prologue_launch`
launches the kernel or raises.  Each launch adds one to
``LAUNCHES["exact_prologue"]``.
"""

from __future__ import annotations

import ctypes
import re
from functools import lru_cache
from types import SimpleNamespace

import torch

from ..utils.profiling import counters, reset
from . import library

LAUNCHES = counters("launches.exact_prologue", ("exact_prologue",))
KEYS, GEO, GRID, ALIGNED, FLAT = 1, 2, 4, 8, 16
CELL_FIELDS = KEYS | GEO | GRID | ALIGNED | FLAT
_F64 = torch.float64
_IN_TYPES = {torch.int32: 0, torch.int64: 1, torch.float64: 2}


def reset_launches() -> None:
    reset("launches.exact_prologue")


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import load

    lib = load("exact_prologue")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.auvtpu_exact_prologue.argtypes = [I, I, P, P, I, I, I, D, D, D, D, D, D, D, I, P, P, P, P, P, P, P, P, P, P]
    lib.auvtpu_exact_prologue.restype = I
    lib.auvtpu_exact_prologue_attributes.argtypes = [I, ctypes.POINTER(I)]
    lib.auvtpu_exact_prologue_attributes.restype = I
    lib.auvtpu_exact_prologue_error_string.argtypes = [I]
    lib.auvtpu_exact_prologue_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the kernel now rather than at the first launch."""
    _lib()


# every build the wrapper launches, in auvtpu_exact_prologue_attributes' order
BUILDS = tuple(f"prologue_kernel<{t}, {'round' if r else 'floor'}>"
               for t in ("int32", "int64", "double") for r in (True, False))
_MANGLED = re.compile(r"prologue_kernelI([ild])Lb([01])E")


def attributes() -> dict:
    """{build: {registers, local_bytes, blocks_per_sm, spill_bytes}} of
    every build on the current card (at 256 threads a block), spills from
    ptxas's report in the build log."""
    from .build import library_path

    out = (ctypes.c_int * 3)()
    res = {}
    for which, name in enumerate(BUILDS):
        _raise_on("exact_prologue_attributes", _lib().auvtpu_exact_prologue_attributes(which, out))
        res[name] = dict(zip(("registers", "local_bytes", "blocks_per_sm"), out))
    log = library_path("exact_prologue").with_suffix(".log").read_text()
    types = {"i": "int32", "l": "int64", "d": "double"}
    for m in re.finditer(r"Function properties for (\S+)\n\s*\d+ bytes stack frame, (\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads", log):
        k = _MANGLED.search(m.group(1))
        if k is not None:
            name = f"prologue_kernel<{types[k.group(1)]}, {'round' if k.group(2) == '1' else 'floor'}>"
            res[name]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
    return res


def geo_of(grid) -> list:
    """The grid's scalars B16 takes by value: the extent and the steps as
    the JAX package computes them on the host, (max - min) / (n - 1) in
    float64."""
    H, W = grid.shape
    return [grid.min_lon, grid.max_lon, grid.min_lat, grid.max_lat, (grid.max_lon - grid.min_lon) / (W - 1),
            (grid.max_lat - grid.min_lat) / (H - 1)]


def prologue(grid, a, b, *, round_anchor: bool, fields: int, eps_scale: float):
    """B16 at queries (``a``, ``b``) on the grid's device: the (N,) int32
    or int64 columns and rows of cell-aligned queries, or the (N,) float64
    longitudes and latitudes of scattered ones.  Returns (anchors (2, N)
    int64 (ci, cj), oob (N,) bool, counts (2,) int32 (keys not exact in
    float32, queries not aligned), keys (2, N) float32 (ex_key, ey_key),
    variant (N,) int32, geo (2, N) float64 (qlon, qlat), xy (2, N) float64
    (x, y), aligned (N,) bool, flat (N,) int64); an output ``fields`` does
    not ask for has no columns (keys, geo, xy: (2, 0)) or no entries."""
    return library.exact_prologue(a, b, geo_of(grid), grid.num_lon, grid.num_lat, round_anchor, fields, eps_scale)


def _outputs(a, fields: int) -> list:
    """The op's outputs for the queries ``a``, allocated on their device
    (the fake implementation's shapes and dtypes); the counts zero."""
    n = a.shape[0]

    def some(flag, rows, dtype):
        m = n if fields & flag else 0
        return a.new_empty((rows, m) if rows else (m,), dtype=dtype)

    return [a.new_empty((2, n), dtype=torch.int64), a.new_empty(n, dtype=torch.bool),
            a.new_zeros(2, dtype=torch.int32), some(KEYS, 2, torch.float32), some(KEYS, 0, torch.int32),
            some(GEO, 2, _F64), some(GRID, 2, _F64), some(ALIGNED, 0, torch.bool), some(FLAT, 0, torch.int64)]


def _check(a, b, fields: int) -> None:
    if a.dtype not in _IN_TYPES or b.dtype != a.dtype:
        raise TypeError(f"exact_prologue: the queries must be int32 or int64 columns and rows or float64 "
                        f"coordinates, both of one dtype (got {a.dtype}, {b.dtype})")
    if a.dim() != 1 or b.shape != a.shape:
        raise ValueError(f"exact_prologue: the queries must be two (N,) tensors, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"exact_prologue: the queries lie on {a.device} and {b.device}")
    allowed = GRID if a.dtype == _F64 else CELL_FIELDS
    if fields & ~allowed:
        raise ValueError(f"exact_prologue: fields {fields} outside {allowed} for {a.dtype} queries")


# ---------------------------------------------------------------------------
# the plain version: the CPU implementation of the op
# ---------------------------------------------------------------------------

def prologue_ref(a, b, geo, num_lon: int, num_lat: int, round_anchor: bool, fields: int, eps_scale: float):
    """Plain version of :func:`prologue`: the same float64 arithmetic as
    torch ops, each rounded once (torch's CPU division by a python float is
    an IEEE division), in numpy's order."""
    from ..ops.exact_fast import _aligned

    _check(a, b, fields)
    min_lon, max_lon, min_lat, max_lat, lon_step, lat_step = geo
    H, W = num_lat, num_lon
    out = _outputs(a, fields)
    cell = a.dtype != _F64
    if cell:
        qlon = min_lon + a.to(_F64) * lon_step
        qlat = min_lat + b.to(_F64) * lat_step
    else:
        qlon, qlat = a, b
    oob = (qlon < min_lon) | (qlon > max_lon) | (qlat < min_lat) | (qlat > max_lat)
    x = torch.where(oob, 0.0, (qlon - min_lon) / lon_step)
    y = torch.where(oob, 0.0, (qlat - min_lat) / lat_step)

    def anchor(f, hi):
        c = torch.where(torch.isnan(f), 0.0, f).to(torch.int64)  # a NaN floor to 0
        return c.clamp(0, hi) if round_anchor else c

    ci = anchor(torch.floor(x + 0.5) if round_anchor else torch.floor(x), W - 1)
    cj = anchor(torch.floor(y + 0.5) if round_anchor else torch.floor(y), H - 1)
    out[0] = torch.stack([ci, cj])
    out[1] = oob
    if fields & GRID:
        out[6] = torch.stack([x, y])
    if not cell:
        return tuple(out)

    def residue(v, c):
        d = v - c.to(_F64)
        whole = torch.round(d).to(torch.int64)  # np.rint: half to even
        return (d - whole.to(_F64)) * eps_scale, whole

    kx, exi = residue(x, ci)
    ky, eyi = residue(y, cj)
    exact = lambda k: k.to(torch.float32).to(_F64) == k
    variant = (2 * exi + eyi).to(torch.int32)
    out[2][0] = (~(exact(kx) & exact(ky))).sum()
    if fields & KEYS:
        out[3] = torch.stack([kx, ky]).to(torch.float32)
        out[4] = variant
    if fields & GEO:
        out[5] = torch.stack([qlon, qlat])
    if fields & ALIGNED:
        out[7] = _aligned(SimpleNamespace(ci=ci, cj=cj, variant=variant, oob=oob), b.to(torch.int64),
                          a.to(torch.int64))
        out[2][1] = (~out[7]).sum()
    if fields & FLAT:
        out[8] = (b.to(torch.int64) * W + a.to(torch.int64)).clamp(0, H * W - 1)
    return tuple(out)


# ---------------------------------------------------------------------------
# the launch: the CUDA implementation of the op
# ---------------------------------------------------------------------------

def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed: {_lib().auvtpu_exact_prologue_error_string(err).decode()} "
                           f"({err})")


def prologue_launch(a, b, geo, num_lon: int, num_lat: int, round_anchor: bool, fields: int, eps_scale: float):
    """One B16 launch: the CUDA implementation of
    ``auvtpu_torch::exact_prologue``."""
    _check(a, b, fields)
    n = a.shape[0]
    if n >= 2**31:
        raise ValueError(f"exact_prologue: {n} queries; the kernel takes fewer than 2**31")
    dev = a.device
    out = _outputs(a, fields)
    if n == 0:
        return tuple(out)
    a, b = a.contiguous(), b.contiguous()
    ptr = lambda t, flag: t.data_ptr() if fields & flag else None
    with torch.cuda.device(dev):
        err = _lib().auvtpu_exact_prologue(
            _IN_TYPES[a.dtype], int(round_anchor), a.data_ptr(), b.data_ptr(), n, num_lat, num_lon, *geo,
            eps_scale, fields, out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), ptr(out[3], KEYS),
            ptr(out[4], KEYS), ptr(out[5], GEO), ptr(out[6], GRID), ptr(out[7], ALIGNED), ptr(out[8], FLAT),
            _stream(dev))
    _raise_on("exact_prologue", err)
    LAUNCHES["exact_prologue"] += 1
    return tuple(out)
