"""Wrappers of exact mode's selection kernels B13 and B14
(``csrc/exact_select.cu``) and their plain versions (counterparts of the
jitted programs of :mod:`auvtpu.ops.exact_fast` and :mod:`auvtpu.ops.exact`).

- B13 (``dense_kernel``): the two-tier dense pass at the query cells, its
  extraction and, in :func:`dense_krige`, the f64 lattice-table solve, one
  thread per query cell; replaces the whole-plane loop
  ``ops.exact_fast._dense_select`` with ``_extract_q`` (and
  ``_solve_table``).  :func:`dense_select` serves
  ``exact_select_at_cells_fast``, :func:`dense_krige`
  ``exact_kriging_at_cells_fast``.  Where every query is aligned
  (``flat_a`` None) each query's residues are read with it; else from two
  residue planes the launch scatters the aligned queries' keys into.
- B14 (``ring_kernel``): the strict ring selection, one thread per query,
  the list's first four entries and the best four of the rest in
  registers; replaces the (N, 441) gathers of ``ops.exact._select_chunk``
  (cell-aligned keys, :func:`ring_select` with a ``variant``) and
  ``_select_chunk_scattered`` (f64 distances, no ``variant``), and in
  :func:`ring_krige` adds the table solve for the two-tier path's escalated
  cells.

Where a call's queries number at least 1 / ``BIT_PLANE_CELLS`` of the
grid's cells, both walk the grid's validity as a bit plane (one bit a
cell, ceil(H * W / 32) int32 words) that the launch builds first from
``valid`` (``bits_kernel``, a second kernel of the same call); fewer
queries read ``valid`` itself.

Each wrapper goes through its custom op (``auvtpu_torch::exact_dense``,
``::exact_dense_krige``, ``::exact_ring``, ``::exact_ring_krige``:
:mod:`.library`): on CPU tensors the op runs the plain version
(``<wrapper>_ref``, the torch functions of :mod:`..ops.exact` and
:mod:`..ops.exact_fast` as they were before the kernels); on CUDA tensors
its CUDA implementation (:func:`dense_launch`, :func:`ring_launch`)
launches the kernel (after the bit plane's build, where it is made) or
raises: the kernels take float32 or float64 grids and any radius from 1 to
``MAX_RADIUS``: the callers' default, ``RADIUS`` (10), has builds of its
own, any other runs the builds that take the radius at run time (a
pass wider than 32 cells, from radius 16 on, walked in pieces of 32).  Each
launch adds one to ``LAUNCHES["exact_dense"]`` or ``LAUNCHES["exact_ring"]``.
"""

from __future__ import annotations

import ctypes
import re
from functools import lru_cache

import torch

from ..config import KrigingConfig
from ..utils.profiling import counters, reset
from . import library

LAUNCHES = counters("launches.exact_select", ("exact_dense", "exact_ring"))
# the callers' default radius, which has builds of its own (kBuiltRadius of
# csrc/exact_select.cu); the kernels take any other from 1 to MAX_RADIUS
RADIUS = 10
# kMaxRadius of csrc/exact_select.cu: the walks' int coordinates stay far
# from overflow; no version's (2R+1)^2-lane tables could be held beyond it
MAX_RADIUS = 1 << 20
# A launch builds the bit plane where its queries number at least H * W /
# BIT_PLANE_CELLS: the build reads the whole validity plane once, a walk
# reads ~7-9 lanes a query at the stand-in's 10 % removal, each a sector of
# its own (scripts/exact_variant_probe.py times both walks).
BIT_PLANE_CELLS = 32
_GRID_DTYPES = (torch.float32, torch.float64)


def reset_launches() -> None:
    reset("launches.exact_select")


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import load

    lib = load("exact_select")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.auvtpu_exact_dense.argtypes = [I, P, P, I, I, I, P, I, P, I, P, P, D, P, P, P, P, P, P, P, P]
    lib.auvtpu_exact_dense.restype = I
    lib.auvtpu_exact_ring.argtypes = [I, P, P, I, I, I, P, P, I, I, P, P, P, P, P, P, P, D, P, P, P, P, P, P, P]
    lib.auvtpu_exact_ring.restype = I
    lib.auvtpu_exact_attributes.argtypes = [I, ctypes.POINTER(I)]
    lib.auvtpu_exact_attributes.restype = I
    lib.auvtpu_exact_error_string.argtypes = [I]
    lib.auvtpu_exact_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the kernels now rather than at the first launch."""
    _lib()


def _build_name(kind: str, dtype: str, solve: bool = False, key: int = 0, bits: bool = True,
                radius: int = RADIUS) -> str:
    if kind == "bits":
        return f"bits_kernel<{dtype}>"
    walk = "bit plane" if bits else "valid"
    at = "" if radius else ", any radius"
    if kind == "dense":
        return f"dense_kernel<{dtype}, {'solve' if solve else 'select'}, {walk}{at}>"
    return f"ring_kernel<{dtype}, KEY {key}{', solve' if solve else ''}, {walk}{at}>"


# every build the wrappers launch, in auvtpu_exact_attributes' order: the
# radius-10 builds, then those of any radius (0)
BUILDS = (_build_name("bits", "float"), _build_name("bits", "double"), *(
    name for radius in (RADIUS, 0) for bits in (True, False) for dtype in ("float", "double") for name in (
        _build_name("dense", dtype, False, bits=bits, radius=radius),
        _build_name("dense", dtype, True, bits=bits, radius=radius),
        _build_name("ring", dtype, False, 0, bits, radius), _build_name("ring", dtype, True, 0, bits, radius),
        _build_name("ring", dtype, False, 1, bits, radius))))

# ptxas's mangled kernel names: the kernel, its dtype, then its int and
# bool template arguments
_MANGLED = re.compile(r"(bits|dense|ring)_kernelI([fd])((?:L[ib]\d+E)*)E")


def attributes() -> dict:
    """{build: {registers, local_bytes, blocks_per_sm, spill_bytes}} of
    every build on the current card: registers and local bytes a thread and
    resident blocks an SM (at 256 threads a block) from the runtime, spill
    stores and loads a thread from ptxas's report in the build log."""
    from .build import library_path

    out = (ctypes.c_int * 3)()
    res = {}
    for which, name in enumerate(BUILDS):
        _raise_on("exact_attributes", _lib().auvtpu_exact_attributes(which, out))
        res[name] = dict(zip(("registers", "local_bytes", "blocks_per_sm"), out))
    log = library_path("exact_select").with_suffix(".log").read_text()
    for m in re.finditer(r"Function properties for (\S+)\n\s*\d+ bytes stack frame, (\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads", log):
        k = _MANGLED.search(m.group(1))
        if k is None:
            continue
        kind, t, targs = k.groups()
        targs = [int(v) for v in re.findall(r"L[ib](\d+)E", targs)]
        dtype = "float" if t == "f" else "double"
        if kind == "bits":
            name = _build_name(kind, dtype)
        elif kind == "dense":
            name = _build_name(kind, dtype, bool(targs[0]), bits=bool(targs[1]), radius=targs[2])
        else:
            name = _build_name(kind, dtype, bool(targs[1]), targs[0], bool(targs[2]), targs[3])
        if name in res:
            res[name]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
    return res


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def dense_select(grid, flat_a, keys, flat_q, *, max_radius: int = RADIUS):
    """B13 without the solve: the dense exact selection of the kriging round
    anchor at the query cells ``flat_q`` ((P,) int64 row * W + col, in the
    plane), with the aligned queries' cells ``flat_a`` ((P_a,) int64) and
    scaled residues ``keys`` ((2, P_a) float32, ex then ey) scattered into
    the residue planes.  ``flat_a`` None: every query is aligned, ``keys``
    are the queries' own ((2, P); duplicated cells carry equal ones), the
    same as ``flat_a`` = ``flat_q``.  Returns (found (P,) int32, tie (P,)
    bool, vals (4, P) in the grid's dtype, dgi, dgj (4, P) int64 offsets
    from the cell), zero on unfilled slots."""
    return library.exact_dense(grid.elev, grid.valid, flat_a, keys, flat_q, max_radius)


def dense_krige(grid, flat_a, keys, flat_q, gpair, gq, *, max_radius: int = RADIUS):
    """B13 with the solve: (pred (P,) float64, tie (P,) bool), the
    prediction of the lattice-table f64 solve over ``gpair`` ((4R+1, 4R+1))
    and ``gq`` ((2R+1, 2R+1)) float64 tables, the four-value mean where the
    system is singular and the fallback mean where fewer than 4 were found;
    operands as for :func:`dense_select`."""
    return library.exact_dense_krige(grid.elev, grid.valid, flat_a, keys, flat_q, gpair, gq, max_radius)


def ring_select(grid, ci, cj, k0, k1, variant=None, *, max_radius: int = RADIUS, chunk: int = 16384):
    """B14: the strict selection of (N,) int64 anchors (ci, cj).  With
    ``variant`` ((N,) int32) the cell-aligned keys, ``k0``/``k1`` the
    float32 scaled residues (ex, ey); without it the f64 distances from the
    grid coordinates ``k0``/``k1`` ((N,) float64 x, y).  Returns (found (N,)
    int32, sel_val (N, 4) in the grid's dtype, sel_gi, sel_gj (N, 4) int32),
    zero beyond found.  ``chunk`` bounds the plain version's (chunk, 441)
    temporaries; the kernel takes every query at once."""
    return library.exact_ring(grid.elev, grid.valid, ci, cj, k0, k1, variant, max_radius, chunk)


def ring_krige(grid, ci, cj, variant, ex, ey, qcol, qrow, gpair, gq, *, max_radius: int = RADIUS,
               chunk: int = 16384):
    """B14 with the lattice-table solve: (N,) float64 predictions of the
    cell-aligned strict selection, the slots taken as offsets from the
    queries' own cells (``qcol``, ``qrow``, (N,) int64); tables as for
    :func:`dense_krige`."""
    return library.exact_ring_krige(grid.elev, grid.valid, ci, cj, variant, ex, ey, qcol, qrow, gpair, gq,
                                    max_radius, chunk)


# ---------------------------------------------------------------------------
# the plain versions: the CPU implementations of the ops
# ---------------------------------------------------------------------------

def dense_select_ref(elev, valid, flat_a, keys, flat_q, max_radius: int):
    """Plain version of :func:`dense_select`: the whole-plane pass, then its
    planes at the query cells (``flat_a`` None: the query cells)."""
    from ..ops.exact_fast import _dense_select, _extract_q

    flat_a = flat_q if flat_a is None else flat_a
    count, tie, ln = _dense_select(valid, flat_a, keys[0], keys[1], max_radius=max_radius)
    return _extract_q(count, tie, ln, elev, flat_q, max_radius=max_radius)


def dense_krige_ref(elev, valid, flat_a, keys, flat_q, gpair, gq, max_radius: int):
    """Plain version of :func:`dense_krige`."""
    from ..ops.exact_fast import _solve_table

    found, tie, vals, dgi, dgj = dense_select_ref(elev, valid, flat_a, keys, flat_q, max_radius)
    return _solve_table(found, vals, dgi, dgj, gpair, gq, max_radius), tie


def ring_select_ref(elev, valid, ci, cj, k0, k1, variant, max_radius: int, chunk: int):
    """Plain version of :func:`ring_select`, in chunks of ``chunk`` queries."""
    from ..ops.exact import _chunked, _device_tables, _select_chunk, _select_chunk_scattered

    grid = library._grid(elev, valid, (0.0, 1.0, 0.0, 1.0))  # the selections read no coordinate
    tb = _device_tables(max_radius, elev.device)
    if variant is None:
        return tuple(_chunked(lambda *a: _select_chunk_scattered(grid, tb, *a), ci.shape[0], chunk, ci, cj, k0, k1))
    return tuple(_chunked(lambda *a: _select_chunk(grid, tb, *a), ci.shape[0], chunk, ci, cj, variant, k0, k1))


def ring_krige_ref(elev, valid, ci, cj, variant, ex, ey, qcol, qrow, gpair, gq, max_radius: int, chunk: int):
    """Plain version of :func:`ring_krige`."""
    from ..ops.exact_fast import _solve_table

    found, sel_val, sel_gi, sel_gj = ring_select_ref(elev, valid, ci, cj, ex, ey, variant, max_radius, chunk)
    filled = torch.arange(4, device=elev.device)[None, :] < found.clamp(max=4)[:, None]
    dgi = torch.where(filled, sel_gi.long() - qcol[:, None], 0).T
    dgj = torch.where(filled, sel_gj.long() - qrow[:, None], 0).T
    return _solve_table(found, sel_val.T, dgi, dgj, gpair, gq, max_radius)


# ---------------------------------------------------------------------------
# the launches: the CUDA implementations of the ops
# ---------------------------------------------------------------------------

def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _check(what: str, elev, valid, max_radius: int, **operands) -> None:
    """Radius, grid dtype, and each operand's (tensor, dtype, shape) on the
    grid's device; raises where the kernel does not take them."""
    if not 1 <= max_radius <= MAX_RADIUS:
        raise ValueError(f"{what}: max_radius={max_radius}; the kernel takes a radius from 1 to {MAX_RADIUS}")
    if elev.dtype not in _GRID_DTYPES or valid.dtype != elev.dtype:
        raise TypeError(f"{what}: the kernel takes float32 or float64 grids with valid of elev's dtype "
                        f"(got {elev.dtype}, {valid.dtype})")
    if elev.dim() != 2 or valid.shape != elev.shape:
        raise ValueError(f"{what}: elev and valid must be one (H, W) shape")
    for name, (t, dtype, shape) in operands.items():
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if t.device != elev.device:
            raise ValueError(f"{what}: the grid lies on {elev.device}, {name} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must have shape {shape}, got {tuple(t.shape)}")


def _raise_on(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed: {_lib().auvtpu_exact_error_string(err).decode()} ({err})")


def _bit_plane(elev, n: int):
    """Scratch for the bit plane a launch of ``n`` queries builds,
    ceil(H * W / 32) words, or None where it reads ``valid`` itself."""
    H, W = elev.shape
    if n * BIT_PLANE_CELLS < H * W:
        return None
    return torch.empty((H * W + 31) // 32, dtype=torch.int32, device=elev.device)


def dense_launch(elev, valid, flat_a, keys, flat_q, gpair, gq, max_radius: int):
    """One B13 launch (with the solve where ``gpair`` is given): the CUDA
    implementation of ``auvtpu_torch::exact_dense`` and
    ``::exact_dense_krige``.  With ``flat_a`` None every query reads its
    own keys.  Else the aligned queries' residues are scattered into two
    zero planes first (as the plain version and the JAX package do), so a
    query on any cell reads what the plain version's planes hold there."""
    what = "exact_dense_krige" if gpair is not None else "exact_dense"
    n = flat_q.shape[0]
    n_a = n if flat_a is None else flat_a.shape[0]
    r = max_radius
    ops = dict(keys=(keys, torch.float32, (2, n_a)), flat_q=(flat_q, torch.int64, (n,)))
    if flat_a is not None:
        ops["flat_a"] = (flat_a, torch.int64, (n_a,))
    if gpair is not None:
        ops.update(gpair=(gpair, torch.float64, (4 * r + 1, 4 * r + 1)), gq=(gq, torch.float64, (2 * r + 1, 2 * r + 1)))
    _check(what, elev, valid, max_radius, **ops)
    dev = elev.device
    H, W = elev.shape
    tie = torch.empty(n, dtype=torch.bool, device=dev)
    if gpair is not None:
        pred = torch.empty(n, dtype=torch.float64, device=dev)
        outs, ptrs = (pred, tie), (None, tie.data_ptr(), None, None, None, pred.data_ptr())
    else:
        found = torch.empty(n, dtype=torch.int32, device=dev)
        vals = torch.empty((4, n), dtype=elev.dtype, device=dev)
        dgi = torch.empty((4, n), dtype=torch.int64, device=dev)
        dgj = torch.empty((4, n), dtype=torch.int64, device=dev)
        outs = (found, tie, vals, dgi, dgj)
        ptrs = (found.data_ptr(), tie.data_ptr(), vals.data_ptr(), dgi.data_ptr(), dgj.data_ptr(), None)
    if n == 0:
        return outs
    elev, valid, flat_q = elev.contiguous(), valid.contiguous(), flat_q.contiguous()
    if flat_a is None:
        res = keys.contiguous()
    else:
        res = torch.zeros((2, H * W), dtype=torch.float32, device=dev)
        res[:, flat_a] = keys  # an aligned query's residues on its cell (duplicated cells carry equal ones)
    tabs = (gpair.contiguous(), gq.contiguous()) if gpair is not None else (None, None)
    bits = _bit_plane(elev, n)
    with torch.cuda.device(dev):
        err = _lib().auvtpu_exact_dense(
            int(elev.dtype == torch.float64), elev.data_ptr(), valid.data_ptr(), H, W, max_radius, res.data_ptr(),
            int(flat_a is None), flat_q.data_ptr(), n, *(t.data_ptr() if t is not None else None for t in tabs),
            KrigingConfig().pivot_tol, *ptrs, bits.data_ptr() if bits is not None else None, _stream(dev))
    _raise_on(what, err)
    LAUNCHES["exact_dense"] += 1
    return outs


def ring_launch(elev, valid, ci, cj, k0, k1, variant, qcol, qrow, gpair, gq, max_radius: int):
    """One B14 launch (with the solve where ``gpair`` is given): the CUDA
    implementation of ``auvtpu_torch::exact_ring`` and
    ``::exact_ring_krige``."""
    what = "exact_ring_krige" if gpair is not None else "exact_ring"
    n = ci.shape[0]
    r = max_radius
    kdt = torch.float32 if variant is not None else torch.float64
    ops = dict(ci=(ci, torch.int64, (n,)), cj=(cj, torch.int64, (n,)), k0=(k0, kdt, (n,)), k1=(k1, kdt, (n,)))
    if variant is not None:
        ops["variant"] = (variant, torch.int32, (n,))
    if gpair is not None:
        ops.update(qcol=(qcol, torch.int64, (n,)), qrow=(qrow, torch.int64, (n,)),
                   gpair=(gpair, torch.float64, (4 * r + 1, 4 * r + 1)),
                   gq=(gq, torch.float64, (2 * r + 1, 2 * r + 1)))
    _check(what, elev, valid, max_radius, **ops)
    dev = elev.device
    H, W = elev.shape
    if gpair is not None:
        pred = torch.empty(n, dtype=torch.float64, device=dev)
        outs, ptrs = pred, (None, None, None, None, pred.data_ptr())
    else:
        found = torch.empty(n, dtype=torch.int32, device=dev)
        sel_val = torch.empty((n, 4), dtype=elev.dtype, device=dev)
        sel_gi = torch.empty((n, 4), dtype=torch.int32, device=dev)
        sel_gj = torch.empty((n, 4), dtype=torch.int32, device=dev)
        outs = (found, sel_val, sel_gi, sel_gj)
        ptrs = (found.data_ptr(), sel_val.data_ptr(), sel_gi.data_ptr(), sel_gj.data_ptr(), None)
    if n == 0:
        return outs
    elev, valid, ci, cj, k0, k1 = (t.contiguous() for t in (elev, valid, ci, cj, k0, k1))
    opt = [t.contiguous() if t is not None else None for t in (variant, qcol, qrow, gpair, gq)]
    bits = _bit_plane(elev, n)
    with torch.cuda.device(dev):
        err = _lib().auvtpu_exact_ring(
            int(elev.dtype == torch.float64), elev.data_ptr(), valid.data_ptr(), H, W, max_radius, ci.data_ptr(),
            cj.data_ptr(), n, int(variant is None), opt[0].data_ptr() if opt[0] is not None else None,
            k0.data_ptr(), k1.data_ptr(), *(t.data_ptr() if t is not None else None for t in opt[1:]),
            KrigingConfig().pivot_tol, *ptrs, bits.data_ptr() if bits is not None else None, _stream(dev))
    _raise_on(what, err)
    LAUNCHES["exact_ring"] += 1
    return outs
