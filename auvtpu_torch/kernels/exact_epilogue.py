"""Wrappers of exact mode's epilogue kernels B17 and B18
(``csrc/exact_epilogue.cu``) and their plain versions (the counterparts of
the JAX package's jitted ``_krige_chunk``, ``_cubic_smooth_chunk`` and
``_bilinear_chunk`` and the host numpy of its at-cells cubic and bilinear,
:mod:`auvtpu.ops.exact`).

- B17 (``krige_kernel``): the coordinate-form f64 kriging of each query
  from its strict selection: the neighbours at cell centres, the
  exponential variogram, the 5x6 system and its unpivoted Gauss-Jordan
  (``ops.scattered.krige_solve``), the four-value mean where it is singular
  and the fallback mean where fewer than 4 were found (:func:`krige`); or
  the fallback mean alone, written into a whole output at given indices
  (:func:`krige_mean_into`: exact cubic's ring fallback of scattered
  queries).
- B18 (``patch_kernel``): the bilinear corners or the clamped 4x4
  Catmull-Rom patch at the queries' floor anchors, their validity, the
  fallbacks and the f64 arithmetic (:func:`patch`), in the cell-aligned
  form (the values converted to f64 first; the cubic's fallback mean of
  the query's selection where the patch is not all valid) or the scattered
  one (the values kept in the grid's dtype; the cubic's ``need`` mask).

Each wrapper goes through its custom op (``auvtpu_torch::exact_krige``,
its overload ``::exact_krige.mean_into``, and ``::exact_patch``:
:mod:`.library`): on CPU tensors the op runs the plain version (the torch
ops of :mod:`..ops.exact` as they ran before the kernels, op for op); on
CUDA tensors its CUDA implementation launches the kernel or raises.  Each
launch adds one to ``LAUNCHES["exact_krige"]`` or
``LAUNCHES["exact_patch"]``.
"""

from __future__ import annotations

import ctypes
import re
from functools import lru_cache

import torch

from ..config import KrigingConfig, VariogramConfig
from ..utils.profiling import counters, reset
from . import library

LAUNCHES = counters("launches.exact_epilogue", ("exact_krige", "exact_patch"))
KINDS = {"bilinear": 0, "cubic": 1}
_F64 = torch.float64
_GRID_DTYPES = (torch.float32, torch.float64)
_INDEX_DTYPES = (torch.int32, torch.int64)


def reset_launches() -> None:
    reset("launches.exact_epilogue")


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import load

    lib = load("exact_epilogue")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.auvtpu_exact_krige.argtypes = [I, I, I, I, P, P, P, P, P, P, D, D, D, D, D, D, D, D, P, P, P]
    lib.auvtpu_exact_krige.restype = I
    lib.auvtpu_exact_patch.argtypes = [I, I, I, I, I, I, P, P, P, P, P, P, P, P, P, P, P, P]
    lib.auvtpu_exact_patch.restype = I
    lib.auvtpu_exact_epilogue_attributes.argtypes = [I, ctypes.POINTER(I)]
    lib.auvtpu_exact_epilogue_attributes.restype = I
    lib.auvtpu_exact_epilogue_error_string.argtypes = [I]
    lib.auvtpu_exact_epilogue_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the kernels now rather than at the first launch."""
    _lib()


# every build the wrappers launch, in auvtpu_exact_epilogue_attributes' order
BUILDS = (*(f"krige_kernel<{t}, {i}, solve>" for t in ("float", "double") for i in ("int32", "int64")),
          "krige_kernel<float, mean>", "krige_kernel<double, mean>",
          *(f"patch_kernel<{t}, {k}, {'cells' if c else 'scattered'}>" for t in ("float", "double")
            for k in KINDS for c in (True, False)))
_MANGLED_KRIGE = re.compile(r"krige_kernelI([fd])([il])Lb([01])E")
_MANGLED_PATCH = re.compile(r"patch_kernelI([fd])Li([01])ELb([01])E")


def attributes(lib=None, log: str | None = None) -> dict:
    """{build: {registers, local_bytes, blocks_per_sm, threads, spill_bytes}}
    of every build on the current card (resident blocks at the build's
    block size), spills from ptxas's report in the build log; ``lib`` and
    ``log`` another build's library and log text (the package's by
    default)."""
    from .build import library_path

    lib = lib if lib is not None else _lib()
    out = (ctypes.c_int * 4)()
    res = {}
    for which, name in enumerate(BUILDS):
        _raise_on("exact_epilogue_attributes", lib.auvtpu_exact_epilogue_attributes(which, out))
        res[name] = dict(zip(("registers", "local_bytes", "blocks_per_sm", "threads"), out))
    log = log if log is not None else library_path("exact_epilogue").with_suffix(".log").read_text()
    types = {"f": "float", "d": "double"}
    for m in re.finditer(r"Function properties for (\S+)\n\s*\d+ bytes stack frame, (\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads", log):
        k, p = _MANGLED_KRIGE.search(m.group(1)), _MANGLED_PATCH.search(m.group(1))
        if k is not None:
            t, i, mean = k.groups()
            name = (f"krige_kernel<{types[t]}, mean>" if mean == "1"
                    else f"krige_kernel<{types[t]}, {'int32' if i == 'i' else 'int64'}, solve>")
        elif p is not None:
            t, kind, cells = p.groups()
            name = f"patch_kernel<{types[t]}, {'bilinear' if kind == '0' else 'cubic'}, " \
                   f"{'cells' if cells == '1' else 'scattered'}>"
        else:
            continue
        if name in res:
            res[name]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
    return res


def scalars_of(grid, cfg: KrigingConfig = KrigingConfig()) -> list:
    """What B17 takes by value: the grid's min_lon, min_lat, lon_step and
    lat_step ((max - min) / (n - 1) in float64), and the variogram's
    nugget, sill and range and the pivot tolerance of ``cfg``."""
    v = cfg.variogram
    return [grid.min_lon, grid.min_lat, grid.lon_step, grid.lat_step, float(v.nugget), float(v.sill),
            float(v.range), float(cfg.pivot_tol)]


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def krige(grid, found, sel_val, sel_gi, sel_gj, qlon, qlat):
    """B17: the (N,) float64 kriging of each query from its selection
    (found (N,) int32, sel_val (N, 4) in the grid's dtype, sel_gi, sel_gj
    (N, 4) int32 or int64 cells, zero beyond found) at its raw float64
    coordinate (qlon, qlat): the solve where found >= 4, the four-value
    mean where it is singular, the fallback mean (NaN where none was found)
    where found < 4."""
    return library.exact_krige(found, sel_val, sel_gi, sel_gj, qlon, qlat, scalars_of(grid))


def krige_mean_into(out, idx, found, sel_val) -> None:
    """B17's fallback mean alone: ``out[idx] = `` the mean of each
    selection's min(found, 4) values (NaN where none), with ``out`` (N,)
    float64 and ``idx`` (M,) int64 distinct indices into it; found (M,)
    int32, sel_val (M, 4)."""
    library.exact_krige_mean_into(found, sel_val, idx, out)


def patch(grid, kind: str, ci, cj, x, y, *, at_cells: bool, found=None, sel_val=None, oob=None, chunk: int = 16384):
    """B18 at (N,) int64 floor anchors (ci, cj) and float64 grid
    coordinates (x, y): ``kind`` 'bilinear' or 'cubic', ``at_cells`` the
    cell-aligned form (the cubic takes the selection, found and sel_val,
    for its fallback) or the scattered one (the cubic takes ``oob``).
    Returns (out (N,) float64, need (N,) bool: the scattered cubic's queries
    whose patch is not all valid and that lie in the grid; (0,) otherwise).
    ``chunk`` bounds the plain version's (chunk, 4, 4) temporaries; the
    kernel takes every query at once."""
    return library.exact_patch(grid.elev, grid.valid, ci, cj, x, y, found, sel_val, oob, KINDS[kind], at_cells,
                               chunk)


# ---------------------------------------------------------------------------
# the plain versions: the CPU implementations of the ops
# ---------------------------------------------------------------------------

def sum4(v):
    """Row sums of (N, 4) values in f64, left to right."""
    v = v.to(_F64)
    return ((v[:, 0] + v[:, 1]) + v[:, 2]) + v[:, 3]


def fallback_mean(found, sel_val):
    """Reference fallback mean: found>=4 -> mean of the 4 selected
    (GridH.cpp:10-18); 0<found<4 -> mean of all found (GridH.cpp:291-298);
    found==0 -> NaN.  Slots >= found are zero, so one sum serves all cases."""
    k = found.clamp(max=4)
    return torch.where(k > 0, sum4(sel_val) / k.clamp(min=1), torch.nan)


def krige_ref(found, sel_val, sel_gi, sel_gj, qlon, qlat, scalars):
    """Plain version of :func:`krige`: the reference's kriging of each query
    from its selection, in f64 (GridH.cpp:326-420): neighbours at cell
    centres, the query at its raw (f64) coordinate; the 4-neighbour mean
    where the solve is singular, the fallback mean where fewer than 4 were
    found."""
    from ..ops.scattered import krige_solve

    min_lon, min_lat, lon_step, lat_step, nugget, sill, rng, pivot_tol = scalars
    cx = min_lon + (sel_gi.to(_F64) + 0.5) * lon_step
    cy = min_lat + (sel_gj.to(_F64) + 0.5) * lat_step
    vals = sel_val.to(_F64)
    cfg = KrigingConfig(variogram=VariogramConfig(nugget, sill, rng), pivot_tol=pivot_tol)
    pred, singular = krige_solve(qlon, qlat, vals, cx, cy, cfg)
    solved = torch.where(singular, sum4(vals) / 4.0, pred)
    return torch.where(found >= 4, solved, fallback_mean(found, sel_val))


def mean_into_ref(found, sel_val, idx, out) -> None:
    """Plain version of :func:`krige_mean_into`."""
    out[idx] = fallback_mean(found, sel_val)


def bilinear_ref(elev, valid, x0, y0, x1, y1, wx, wy, z_dtype=None):
    """Bilinear from the corners (x0, y0) (clamped here) and (x1, y1), with
    the mean of the valid corners where any is invalid (GridH.cpp:160-210);
    corner values in ``z_dtype`` (the grid's by default)."""
    H, W = elev.shape
    x0c = x0.clamp(0, W - 1)
    y0c = y0.clamp(0, H - 1)
    ev = elev.reshape(-1)
    vv = valid.reshape(-1)
    idx = [y0c * W + x0c, y0c * W + x1, y1 * W + x0c, y1 * W + x1]
    z = [ev[i] if z_dtype is None else ev[i].to(z_dtype) for i in idx]
    m = [vv[i] > 0.5 for i in idx]
    cnt = ((m[0].int() + m[1].int()) + m[2].int()) + m[3].int()
    s = ((torch.where(m[0], z[0], 0) + torch.where(m[1], z[1], 0)) + torch.where(m[2], z[2], 0)) + torch.where(
        m[3], z[3], 0)
    fb = torch.where(cnt > 0, s / cnt.clamp(min=1), torch.nan)
    z0 = (1 - wx) * z[0] + wx * z[1]
    z1 = (1 - wx) * z[2] + wx * z[3]
    smooth = (1 - wy) * z0 + wy * z1
    return torch.where(cnt >= 4, smooth, fb)


def cubic_smooth_ref(elev, valid, xi, yi, x, y, z_dtype=None):
    """Catmull-Rom over the clamped 4x4 patch at f64 coordinates, and
    whether the patch is fully valid (GridH.cpp:223-319 smooth path); patch
    values in ``z_dtype`` (the grid's by default)."""
    from ..ops.scattered import _catmull_rom

    H, W = elev.shape
    rel = torch.arange(-1, 3, device=elev.device)
    jj = (yi[:, None] + rel).clamp(0, H - 1)
    ii = (xi[:, None] + rel).clamp(0, W - 1)
    flat = jj[:, :, None] * W + ii[:, None, :]
    patch = elev.reshape(-1)[flat]  # (N, 4, 4)
    if z_dtype is not None:
        patch = patch.to(z_dtype)
    all_ok = (valid.reshape(-1)[flat] > 0.5).flatten(1).all(dim=1)
    tx = x - xi
    ty = y - yi
    col = _catmull_rom(patch[:, :, 0], patch[:, :, 1], patch[:, :, 2], patch[:, :, 3], tx[:, None])
    return _catmull_rom(col[:, 0], col[:, 1], col[:, 2], col[:, 3], ty), all_ok


def patch_ref(elev, valid, ci, cj, x, y, found, sel_val, oob, kind: int, at_cells: bool, chunk: int):
    """Plain version of :func:`patch`, in chunks of ``chunk`` queries."""
    from ..ops.exact import _chunked

    _check_patch(elev, valid, ci, cj, x, y, found, sel_val, oob, kind, at_cells)
    H, W = elev.shape
    n = ci.shape[0]
    if kind == KINDS["bilinear"]:
        def one(x0, y0, xs, ys):
            if at_cells:
                # the +1 corners clamp the unclamped anchor: the JAX package's
                # host arithmetic, GridH.cpp:170-173
                x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
                return (bilinear_ref(elev, valid, x0, y0, x1, y1, xs - x0, ys - y0, z_dtype=_F64),)
            x1, y1 = (x0.clamp(0, W - 1) + 1).clamp(max=W - 1), (y0.clamp(0, H - 1) + 1).clamp(max=H - 1)
            return (bilinear_ref(elev, valid, x0, y0, x1, y1, xs - x0, ys - y0),)

        (out,) = _chunked(one, n, chunk, ci, cj, x, y)
        return out, ci.new_empty(0, dtype=torch.bool)
    if at_cells:
        def one(xi, yi, xs, ys, f, v):
            smooth, patch_ok = cubic_smooth_ref(elev, valid, xi, yi, xs, ys, z_dtype=_F64)
            return (torch.where(patch_ok, smooth, fallback_mean(f, v)),)

        (out,) = _chunked(one, n, chunk, ci, cj, x, y, found, sel_val)
        return out, ci.new_empty(0, dtype=torch.bool)
    smooth, all_ok = _chunked(lambda *a: cubic_smooth_ref(elev, valid, *a), n, chunk, ci, cj, x, y)
    return smooth.to(_F64), ~all_ok & ~oob


# ---------------------------------------------------------------------------
# checks, shared by the plain versions, the launches and the fakes
# ---------------------------------------------------------------------------

def _expect(what: str, name: str, t, dtypes, shape, device) -> None:
    if t is None:
        raise ValueError(f"{what}: {name} is required")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: {name} must be {' or '.join(str(d) for d in dtypes)}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: {name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{what}: {name} lies on {t.device}, the operands on {device}")


def _check_krige(found, sel_val, sel_gi=None, sel_gj=None, qlon=None, qlat=None, idx=None, out=None) -> None:
    what = "exact_krige"
    n, dev = found.shape[0], found.device
    _expect(what, "found", found, (torch.int32,), (n,), dev)
    _expect(what, "sel_val", sel_val, _GRID_DTYPES, (n, 4), dev)
    if out is None:
        _expect(what, "sel_gi", sel_gi, _INDEX_DTYPES, (n, 4), dev)
        _expect(what, "sel_gj", sel_gj, (sel_gi.dtype,), (n, 4), dev)
        _expect(what, "qlon", qlon, (_F64,), (n,), dev)
        _expect(what, "qlat", qlat, (_F64,), (n,), dev)
    else:
        _expect(what, "idx", idx, (torch.int64,), (n,), dev)
        _expect(what, "out", out, (_F64,), (out.shape[0],), dev)


def _check_patch(elev, valid, ci, cj, x, y, found, sel_val, oob, kind: int, at_cells: bool) -> None:
    what = "exact_patch"
    if elev.dtype not in _GRID_DTYPES or valid.dtype != elev.dtype:
        raise TypeError(f"{what}: float32 or float64 grids with valid of elev's dtype (got {elev.dtype}, "
                        f"{valid.dtype})")
    if elev.dim() != 2 or valid.shape != elev.shape:
        raise ValueError(f"{what}: elev and valid must be one (H, W) shape")
    if kind not in KINDS.values():
        raise ValueError(f"{what}: kind {kind}, want one of {KINDS}")
    n, dev = ci.shape[0], elev.device
    for name, t, dt in (("ci", ci, torch.int64), ("cj", cj, torch.int64), ("x", x, _F64), ("y", y, _F64)):
        _expect(what, name, t, (dt,), (n,), dev)
    if kind == KINDS["cubic"] and at_cells:
        _expect(what, "found", found, (torch.int32,), (n,), dev)
        _expect(what, "sel_val", sel_val, (elev.dtype,), (n, 4), dev)
    if kind == KINDS["cubic"] and not at_cells:
        _expect(what, "oob", oob, (torch.bool,), (n,), dev)


def patch_outputs(elev, ci, kind: int, at_cells: bool):
    """The op's outputs for ``ci``'s queries, allocated on the grid's
    device (the fake implementation's shapes and dtypes)."""
    n = ci.shape[0]
    m = n if kind == KINDS["cubic"] and not at_cells else 0
    return elev.new_empty(n, dtype=_F64), elev.new_empty(m, dtype=torch.bool)


# ---------------------------------------------------------------------------
# the launches: the CUDA implementations of the ops
# ---------------------------------------------------------------------------

def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed: "
                           f"{_lib().auvtpu_exact_epilogue_error_string(err).decode()} ({err})")


def _ptr(t):
    return t.data_ptr() if t is not None else None


def krige_launch(found, sel_val, sel_gi, sel_gj, qlon, qlat, scalars, idx=None, out=None):
    """One B17 launch: the CUDA implementation of ``auvtpu_torch::exact_krige``
    (``out`` None: a new (N,) float64 output) and of its ``mean_into``
    overload (the fallback mean alone, written to ``out[idx]``)."""
    mean = out is not None
    _check_krige(found, sel_val, sel_gi, sel_gj, qlon, qlat, idx, out)
    n, dev = found.shape[0], found.device
    if n >= 2**31:
        raise ValueError(f"exact_krige: {n} queries; the kernel takes fewer than 2**31")
    res = out if mean else torch.empty(n, dtype=_F64, device=dev)
    if n == 0:
        return res
    found, sel_val = found.contiguous(), sel_val.contiguous()
    if mean:
        if not out.is_contiguous():
            raise ValueError("exact_krige.mean_into: out must be contiguous")
        gi = gj = lon = lat = None
        idx = idx.contiguous()
    else:
        gi, gj, lon, lat = (t.contiguous() for t in (sel_gi, sel_gj, qlon, qlat))
    with torch.cuda.device(dev):
        err = _lib().auvtpu_exact_krige(
            int(sel_val.dtype == _F64), int(gi is not None and gi.dtype == torch.int64), int(mean), n,
            found.data_ptr(), sel_val.data_ptr(), _ptr(gi), _ptr(gj), _ptr(lon), _ptr(lat), *scalars, _ptr(idx),
            res.data_ptr(), _stream(dev))
    _raise_on("exact_krige", err)
    LAUNCHES["exact_krige"] += 1
    return res


def patch_launch(elev, valid, ci, cj, x, y, found, sel_val, oob, kind: int, at_cells: bool):
    """One B18 launch: the CUDA implementation of ``auvtpu_torch::exact_patch``."""
    _check_patch(elev, valid, ci, cj, x, y, found, sel_val, oob, kind, at_cells)
    n, dev = ci.shape[0], elev.device
    if n >= 2**31:
        raise ValueError(f"exact_patch: {n} queries; the kernel takes fewer than 2**31")
    out, need = patch_outputs(elev, ci, kind, at_cells)
    if n == 0:
        return out, need
    H, W = elev.shape
    elev, valid, ci, cj, x, y = (t.contiguous() for t in (elev, valid, ci, cj, x, y))
    cubic_cells = kind == KINDS["cubic"] and at_cells
    cubic_scattered = kind == KINDS["cubic"] and not at_cells
    found = found.contiguous() if cubic_cells else None
    sel_val = sel_val.contiguous() if cubic_cells else None
    oob = oob.contiguous() if cubic_scattered else None
    with torch.cuda.device(dev):
        err = _lib().auvtpu_exact_patch(
            int(elev.dtype == _F64), kind, int(at_cells), H, W, n, elev.data_ptr(), valid.data_ptr(),
            ci.data_ptr(), cj.data_ptr(), x.data_ptr(), y.data_ptr(), _ptr(found), _ptr(sel_val), _ptr(oob),
            out.data_ptr(), need.data_ptr() if cubic_scattered else None, _stream(dev))
    _raise_on("exact_patch", err)
    LAUNCHES["exact_patch"] += 1
    return out, need
