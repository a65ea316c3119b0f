"""Wrappers of the windowed-fill CUDA kernels (counterpart of
:mod:`auvtpu.pallas.window_fill`).

Five kernels, all in ``csrc/window_fill.cu``:

- :func:`topk_full` (B2, replaces ``_make_topk_full_kernel``): first-k-valid
  selection, returning (cnt, vals, dxs, dys) planes;
- :func:`topk_idx` (B4, replaces ``_make_topk_kernel``): the same selection
  as (cnt, slot table-index planes);
- :func:`fill_kriging_fused` (B1, replaces ``_make_kriging_fill_kernel``):
  the same selection and the 5x6 ordinary-kriging solve in one pass;
- :func:`kriging_at_cells_fused` (B19, no Pallas counterpart): B1's
  selection and solve at a list of cells only, the values B1's plane holds
  there;
- :func:`fill_idw_fused` and :func:`fill_mean_fused` (B3, replace
  ``_make_fill_kernel``): first-k-valid IDW and mean fills, reading the
  grid's planes as they are (a window view of a larger mosaic included),
  optionally keeping observed cells' own values (``keep_observed``).

B4 reads a NaN-padded copy of the plane that its launch builds first
(:func:`_nan_padded`); B1, B2 and B3 build their halo tiles themselves,
from the grid's planes as they are, and a B1 or B2 call is one launch and
nothing else.  Each has a plain torch version beside it
(``<wrapper>_ref``).  Every wrapper goes through its custom op
(:mod:`.library`: ``auvtpu_torch::kriging_fill``, ``::kriging_cells``,
``::topk_full``, ``::window_fill``, ``::topk_idx``), whose ``cpu``
implementation is the plain version and whose ``cuda`` implementation
(:func:`kriging_launch`, :func:`kriging_cells_launch`,
:func:`topk_full_launch`, :func:`fill_launch`, :func:`topk_idx_launch`)
launches the kernel or raises.  Each launch adds one to
``LAUNCHES[<wrapper name>]``, so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..config import IDWConfig, KrigingConfig
from ..grid import RegularGrid
from ..ops.dense import (
    cell_operands,
    fill_idw,
    fill_window_mean,
    idw_denominators,
    krige_planes,
    plane_at_cells,
    window_topk_idx,
    window_topk_planes,
)
from ..tables import sorted_offsets
from ..utils.profiling import counters, reset, span, spanned
from . import library

LAUNCHES = counters("launches.window_fill",
                    ("topk_full", "topk_idx", "fill_kriging_fused", "fill_idw_fused", "fill_mean_fused",
                     "kriging_at_cells_fused"))

MAX_K = 16  # slots the selection kernel keeps in registers
_MODELS = {"exponential": 0, "linear": 1, "spherical": 2, "gaussian": 3}
_SOLVERS = {"gj": 0, "lu": 1}


def reset_launches() -> None:
    reset("launches.window_fill")


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import load

    lib = load("window_fill")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.auvtpu_topk_full.argtypes = [P, I, P, I, P, I, I, I, I, I, P, P]
    lib.auvtpu_topk_full.restype = I
    lib.auvtpu_topk_idx.argtypes = [P, P, I, I, I, I, I, P, P]
    lib.auvtpu_topk_idx.restype = I
    lib.auvtpu_fill.argtypes = [P, I, P, I, P, P, I, I, I, I, I, I, ctypes.c_float, I, P, P]
    lib.auvtpu_fill.restype = I
    FP = ctypes.POINTER(ctypes.c_float)
    lib.auvtpu_kriging_fill.argtypes = [P, I, P, I, P, I, I, I, I, FP, FP, P, P, P, I, I, I, P, P]
    lib.auvtpu_kriging_fill.restype = I
    L = ctypes.c_longlong
    lib.auvtpu_kriging_cells.argtypes = [P, I, P, I, P, I, I, I, I, FP, FP, P, P, P, I, I, P, P, L, P, P]
    lib.auvtpu_kriging_cells.restype = I
    lib.auvtpu_error_string.argtypes = [I]
    lib.auvtpu_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the kernels now rather than at the first launch."""
    _lib()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().auvtpu_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({err})")


@lru_cache(maxsize=16)
def _device_table(max_radius: int, convention: str, device: torch.device) -> torch.Tensor:
    """The sorted offset table as (M, 2) int32 (dx, dy) on ``device``."""
    dxs, dys, _ = sorted_offsets(max_radius, convention)
    return torch.from_numpy(np.stack([dxs, dys], axis=1).astype(np.int32)).to(device)


def _check_f32_planes(elev: torch.Tensor, valid: torch.Tensor, what: str) -> None:
    if elev.dtype != torch.float32 or valid.dtype != torch.float32:
        raise TypeError(
            f"{what}: the kernel is float32 only (got {elev.dtype}/"
            f"{valid.dtype}); float64 callers use the plain path on the CPU"
        )


def _check_cuda_planes(elev: torch.Tensor, valid: torch.Tensor, what: str) -> torch.device:
    dev = elev.device
    if dev.type != "cuda":
        raise ValueError(
            f"{what}: grid lies on {dev}; the kernel takes a CUDA grid "
            "(a CPU grid runs the plain version)"
        )
    if valid.device != dev:
        raise ValueError(f"{what}: elev on {dev} but valid on {valid.device}")
    _check_f32_planes(elev, valid, what)
    return dev


def _check_cuda_grid(grid: RegularGrid, what: str) -> torch.device:
    return _check_cuda_planes(grid.elev, grid.valid, what)


def _pitch(t: torch.Tensor, what: str) -> int:
    """Row pitch, in elements, of a 2-D plane whose columns are adjacent."""
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f"{what}: the kernel takes (H, W) planes with unit column stride (got strides "
                         f"{tuple(t.stride())}); copy the plane first if that is what you mean")
    return t.stride(0)


def _nan_padded(grid: RegularGrid, radius: int) -> torch.Tensor:
    """(H+2R, W+2R) f32 plane, NaN at invalid and out-of-grid cells: B4's
    input."""
    return _nan_padded_planes(grid.elev, grid.valid, radius)


def _nan_padded_planes(elev: torch.Tensor, valid: torch.Tensor, radius: int) -> torch.Tensor:
    H, W = elev.shape
    out = torch.full((H + 2 * radius, W + 2 * radius), float("nan"), dtype=torch.float32, device=elev.device)
    out[radius:radius + H, radius:radius + W] = torch.where(valid > 0.5, elev, float("nan"))
    return out


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


# ---------------------------------------------------------------------------
# B2: first-k-valid selection
# ---------------------------------------------------------------------------

def topk_full_ref(grid: RegularGrid, *, k: int = 4, max_radius: int = 10, convention: str = "reference"):
    """Plain version of :func:`topk_full`: the whole-plane selection of
    :func:`auvtpu_torch.ops.dense.window_topk_planes`, with the empty-slot
    offsets set to (-R, -R) as the kernel (and pallas_topk_full) leave them."""
    cnt, vals, dxs, dys = window_topk_planes(grid, k=k, max_radius=max_radius, convention=convention)
    empty = float(-max_radius)
    dxs = [torch.where(cnt > s, d, empty) for s, d in enumerate(dxs)]
    dys = [torch.where(cnt > s, d, empty) for s, d in enumerate(dys)]
    return cnt, vals, dxs, dys


def _topk_full_args(elev: torch.Tensor, valid: torch.Tensor, k: int) -> tuple[int, int]:
    """The row pitches (elements) B2 reads a grid's planes with, after the
    checks its kernel needs: float32 planes with unit column stride (a
    window view of a larger plane is read in place) and 1 <= k <= MAX_K."""
    _check_f32_planes(elev, valid, "topk_full")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_full: k={k} outside 1..{MAX_K}")
    return _pitch(elev, "topk_full"), _pitch(valid, "topk_full")


def topk_full(grid: RegularGrid, *, k: int = 4, max_radius: int = 10, convention: str = "reference"):
    """First-k-valid selection (B2): (cnt, vals[k], dxs[k], dys[k]) planes,
    as ``pallas_topk_full`` returns them: empty slots hold value 0 and
    offset (-R, -R), so consumers must mask slots >= cnt.  The planes may be
    views with any row stride, as for :func:`fill_idw_fused`; a call is one
    kernel launch, through the op ``auvtpu_torch::topk_full``."""
    if grid.elev.device.type not in ("cpu", "cuda"):
        _check_cuda_grid(grid, "topk_full")  # raises: a meta grid would reach the fake implementation
    planes = library.topk_full(grid.elev, grid.valid, k, max_radius, convention).unbind(0)  # one view op
    return planes[0], list(planes[1:1 + k]), list(planes[1 + k:1 + 2 * k]), list(planes[1 + 2 * k:])


def topk_full_launch(elev: torch.Tensor, valid: torch.Tensor, k: int, max_radius: int, convention: str):
    """One B2 launch over CUDA planes: the ``cuda`` implementation of
    ``auvtpu_torch::topk_full``.  Returns the (1+3k, H, W) planes."""
    dev = _check_cuda_planes(elev, valid, "topk_full")
    pe, pv = _topk_full_args(elev, valid, k)
    H, W = elev.shape
    R = max_radius
    out = torch.empty((1 + 3 * k, H, W), dtype=torch.float32, device=dev)
    if H * W > 0:
        tab = _device_table(R, convention, dev)
        with torch.cuda.device(dev):
            err = _lib().auvtpu_topk_full(
                elev.data_ptr(), pe, valid.data_ptr(), pv, tab.data_ptr(), tab.shape[0], H, W, R, k,
                out.data_ptr(), _stream(dev),
            )
        _raise_on(err, "topk_full")
        LAUNCHES["topk_full"] += 1
    return out


# ---------------------------------------------------------------------------
# B4: first-k-valid selection as slot table indices
# ---------------------------------------------------------------------------

def topk_idx_ref(grid: RegularGrid, *, k: int = 4, max_radius: int = 10, convention: str = "reference"):
    """Plain version of :func:`topk_idx`: :func:`auvtpu_torch.ops.dense.window_topk_idx`."""
    return window_topk_idx(grid, k=k, max_radius=max_radius, convention=convention)


def topk_idx(grid: RegularGrid, *, k: int = 4, max_radius: int = 10, convention: str = "reference"):
    """First-k-valid selection (B4) as (cnt, [k index planes]), f32: each
    plane holds the sorted-table row of the slot's cell, -1 at an empty
    slot, as ``pallas_topk_idx`` returns them; through the op
    ``auvtpu_torch::topk_idx``."""
    if grid.elev.device.type not in ("cpu", "cuda"):
        _check_cuda_grid(grid, "topk_idx")
    planes = library.topk_idx(grid.elev, grid.valid, k, max_radius, convention).unbind(0)
    return planes[0], list(planes[1:])


def topk_idx_launch(elev: torch.Tensor, valid: torch.Tensor, k: int, max_radius: int, convention: str):
    """One B4 launch over CUDA planes, on the NaN-padded plane it builds
    first (:func:`_nan_padded`): the ``cuda`` implementation of
    ``auvtpu_torch::topk_idx``.  Returns the (1+k, H, W) planes."""
    dev = _check_cuda_planes(elev, valid, "topk_idx")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_idx: k={k} outside 1..{MAX_K}")
    H, W = elev.shape
    R = max_radius
    out = torch.empty((1 + k, H, W), dtype=torch.float32, device=dev)
    if H * W > 0:
        nanp = _nan_padded_planes(elev, valid, R)
        tab = _device_table(R, convention, dev)
        with torch.cuda.device(dev):
            err = _lib().auvtpu_topk_idx(
                nanp.data_ptr(), tab.data_ptr(), tab.shape[0], H, W, R, k,
                out.data_ptr(), _stream(dev),
            )
        _raise_on(err, "topk_idx")
        LAUNCHES["topk_idx"] += 1
    return out


# ---------------------------------------------------------------------------
# B3: first-k-valid IDW and mean fills
# ---------------------------------------------------------------------------

@lru_cache(maxsize=16)
def _device_weights(max_radius: int, power: float, convention: str, device: torch.device) -> torch.Tensor:
    """IDW weight of each sorted-table row, 1/(d2^(p/2)+eps) in float32 (the
    Pallas host table, window_fill.py:331-335), on ``device``."""
    m = len(sorted_offsets(max_radius, convention)[0])
    w = np.float32(1.0) / idw_denominators(max_radius, power, convention)[:m]
    return torch.from_numpy(w.astype(np.float32)).to(device)


_FILL_NAMES = ("fill_idw_fused", "fill_mean_fused")  # by kind


def fill_launch(grid: RegularGrid, kind: int, *, k: int, power: float, max_radius: int, convention: str, keep_observed: bool):
    """One B3 launch over a CUDA grid (kind 0 IDW, 1 mean): the ``cuda``
    implementation of ``auvtpu_torch::window_fill``."""
    name = _FILL_NAMES[kind]
    dev = _check_cuda_grid(grid, name)
    H, W = grid.shape
    R = max_radius
    pe, pv = _pitch(grid.elev, name), _pitch(grid.valid, name)
    out = torch.empty((H, W), dtype=torch.float32, device=dev)
    if H * W > 0:
        tab = _device_table(R, convention, dev)
        wtab = _device_weights(R, float(power), convention, dev)
        with torch.cuda.device(dev):
            err = _lib().auvtpu_fill(
                grid.elev.data_ptr(), pe, grid.valid.data_ptr(), pv, tab.data_ptr(), wtab.data_ptr(),
                tab.shape[0], H, W, R, kind, k, IDWConfig().eps, int(keep_observed),
                out.data_ptr(), _stream(dev),
            )
        _raise_on(err, name)
        LAUNCHES[name] += 1
    return out


def _fill(grid: RegularGrid, kind: int, *, k: int, power: float, max_radius: int, convention: str, keep_observed: bool):
    """B3 through its op: the plain version for a CPU grid, the kernel (or
    an error) for a CUDA one."""
    if grid.elev.device.type != "cpu":
        _check_cuda_grid(grid, _FILL_NAMES[kind])
    return library.window_fill(grid.elev, grid.valid, kind, k, float(power), max_radius, convention,
                               keep_observed)


def fill_idw_fused_ref(grid: RegularGrid, *, k: int = 8, power: float = 2.0, max_radius: int = 10, convention: str = "reference", keep_observed: bool = False):
    """Plain version of :func:`fill_idw_fused`: :func:`auvtpu_torch.ops.dense.fill_idw`."""
    return fill_idw(grid, k=k, power=power, max_radius=max_radius, convention=convention, backend="torch",
                    keep_observed=keep_observed)


def fill_idw_fused(grid: RegularGrid, *, k: int = 8, power: float = 2.0, max_radius: int = 10, convention: str = "reference", keep_observed: bool = False):
    """First-k-valid IDW fill (B3): Σwv / max(Σw, eps) over the k nearest
    valid cells with static weights 1/(d2^(p/2)+eps), NaN where none is
    found; the semantics of ``pallas_fill_idw`` and ``ops.dense.fill_idw``.
    ``keep_observed``: cells with valid > 0.5 keep their own elevation.
    The planes may be views with any row stride (a window of a mosaic); a
    column stride other than 1 raises."""
    return _fill(grid, 0, k=k, power=power, max_radius=max_radius, convention=convention,
                 keep_observed=keep_observed)


def fill_mean_fused_ref(grid: RegularGrid, *, k: int = 4, max_radius: int = 10, convention: str = "reference", keep_observed: bool = False):
    """Plain version of :func:`fill_mean_fused`: :func:`auvtpu_torch.ops.dense.fill_window_mean`."""
    return fill_window_mean(grid, k=k, max_radius=max_radius, convention=convention, backend="torch",
                            keep_observed=keep_observed)


def fill_mean_fused(grid: RegularGrid, *, k: int = 4, max_radius: int = 10, convention: str = "reference", keep_observed: bool = False):
    """First-k-valid mean fill (B3): the mean of the k nearest valid cells,
    NaN where none is found; the semantics of ``pallas_fill_mean`` and
    ``ops.dense.fill_window_mean``.  ``keep_observed`` and the planes'
    strides as for :func:`fill_idw_fused`."""
    return _fill(grid, 1, k=k, power=0.0, max_radius=max_radius, convention=convention,
                 keep_observed=keep_observed)


# ---------------------------------------------------------------------------
# B1: fused selection + ordinary-kriging solve
# ---------------------------------------------------------------------------

def fill_kriging_fused_ref(grid: RegularGrid, *, max_radius: int = 10, convention: str = "reference", vparams=None, model: str = "exponential", solver: str = "gj", with_variance: bool = False, row0=0, col0=0, steps=None):
    """Plain version of :func:`fill_kriging_fused`: whole-plane selection, then
    the batched torch solve with the same options.  Its gamma is
    :func:`auvtpu_torch.variogram.variogram_model` (range clamped >= 1e-6)
    for the non-exponential models, as in the JAX package's XLA path."""
    if solver not in _SOLVERS:
        raise ValueError(solver)
    sel = window_topk_planes(grid, k=4, max_radius=max_radius, convention=convention)
    return krige_planes(
        grid, sel, row0=row0, col0=col0, steps=steps, vparams=vparams,
        convention=convention, model=model, with_variance=with_variance, solver=solver,
    )


def _kriging_params(grid: RegularGrid, vparams, convention: str, row0, col0, steps, dev):
    """The parameters of one B1 or B19 launch: the 8 fixed ones (min_lon,
    min_lat, lon_step, lat_step, half, pivot_tol, row0, col0) as host
    float32, passed by value (:func:`_fixed_params`), and the variogram's
    of :func:`_vario_params`.  Returns (geo, vario, pointers, keep)."""
    lat_step, lon_step = (grid.lat_step, grid.lon_step) if steps is None else steps
    geo = _fixed_params(*(float(v) for v in (grid.min_lon, grid.min_lat, lon_step, lat_step,
                                             0.5 if convention == "reference" else 0.0, row0, col0)))
    return (geo, *_vario_params(vparams, dev, "fill_kriging_fused"))


@lru_cache(maxsize=64)
def _fixed_params(min_lon: float, min_lat: float, lon_step: float, lat_step: float, half: float, row0: float, col0: float):
    """B1's and B19's 8 fixed parameters as host float32, made once per
    grid geometry (the array is shared: nothing writes to it)."""
    return (ctypes.c_float * 8)(min_lon, min_lat, lon_step, lat_step, half, KrigingConfig().pivot_tol, row0, col0)


def _vario_params(vparams, dev, name: str):
    """The variogram's 3 parameters of a B1 or B19 launch as host
    float32, passed by value, and for each that is a tensor (fitted
    parameters, 0-d on the device, or all three as one (3,) tensor, the
    ops' operand) its device address, so it never travels to the host.
    Returns (vario, pointers, keep): ``keep`` holds the tensors the
    pointers point into until the launch."""
    if vparams is None:
        cfg = KrigingConfig()
        vparams = (cfg.variogram.nugget, cfg.variogram.sill, cfg.variogram.range)
    vario = (ctypes.c_float * 3)()
    if torch.is_tensor(vparams):
        if vparams.shape != (3,):
            raise ValueError(f"{name}: variogram parameters: a (3,) tensor, got {tuple(vparams.shape)}")
        if vparams.device != dev or vparams.dtype != torch.float32 or not vparams.is_contiguous():
            vparams = vparams.to(dev, torch.float32).contiguous()  # a copy, as for a 0-d tensor below
        p = vparams.data_ptr()
        return vario, [p, p + 4, p + 8], [vparams]
    ptrs, keep = [None] * 3, []
    for i, v in enumerate(vparams):
        if torch.is_tensor(v):
            if v.numel() != 1:
                raise ValueError(f"{name}: variogram parameter {i} has {v.numel()} elements, want one")
            if v.device != dev or v.dtype != torch.float32:
                v = v.to(dev, torch.float32)  # a copy, where the caller's tensor is not float32 on the card
            keep.append(v)
            ptrs[i] = v.data_ptr()
        else:
            vario[i] = float(v)
    return vario, ptrs, keep


@spanned
def fill_kriging_fused(grid: RegularGrid, *, max_radius: int = 10, convention: str = "reference", vparams=None, model: str = "exponential", solver: str = "gj", with_variance: bool = False, row0=0, col0=0, steps=None):
    """Fused ordinary-kriging fill (B1): first-4-valid selection and the 5x6
    solve per cell in one kernel, one read of the grid and one write of the
    plane.  Same arguments and semantics as ``pallas_fill_kriging``: the
    mean of the found neighbours where fewer than 4 were found or a pivot
    fell below 1e-12 (NaN where none was found); ``solver`` 'gj' (the
    reference's Gauss-Jordan) or 'lu' (within 1.5e-3 of it);
    ``with_variance`` also returns the variance plane (NaN at fallback
    cells); row0/col0/steps place a sub-plane in a larger grid.  The planes
    may be views with any row stride, as for :func:`fill_idw_fused`;
    fitted variogram parameters (0-d tensors on the card) are read there by
    the kernel."""
    if grid.elev.device.type != "cpu":
        _check_cuda_grid(grid, "fill_kriging_fused")
    lat_step, lon_step = (grid.lat_step, grid.lon_step) if steps is None else steps
    geo = [float(v) for v in (grid.min_lon, grid.max_lon, grid.min_lat, grid.max_lat, lat_step, lon_step, row0, col0)]
    out = library.kriging_fill(grid.elev, grid.valid, library.variogram_tensor(vparams, grid.elev), geo, max_radius,
                               convention, model, solver, with_variance)
    if with_variance:
        return out[0], out[1]
    return out


def kriging_launch(grid: RegularGrid, vparams, *, max_radius: int, convention: str, model: str, solver: str, with_variance: bool, row0, col0, steps):
    """One B1 launch over a CUDA grid: the ``cuda`` implementation of
    ``auvtpu_torch::kriging_fill``.  Returns the plane, or (2, H, W) with the
    variance."""
    dev = _check_cuda_grid(grid, "fill_kriging_fused")
    if model not in _MODELS:
        raise ValueError(model)
    if solver not in _SOLVERS:
        raise ValueError(solver)
    H, W = grid.shape
    R = max_radius
    pe, pv = _pitch(grid.elev, "fill_kriging_fused"), _pitch(grid.valid, "fill_kriging_fused")
    out = torch.empty((2, H, W) if with_variance else (H, W), dtype=torch.float32, device=dev)
    if H * W > 0:
        tab = _device_table(R, convention, dev)
        geo, vario, ptrs, keep = _kriging_params(grid, vparams, convention, row0, col0, steps, dev)
        stream = _stream(dev)
        with torch.cuda.device(dev), span("auvtpu_torch.kernels.window_fill.kriging_launch:call"):
            err = _lib().auvtpu_kriging_fill(
                grid.elev.data_ptr(), pe, grid.valid.data_ptr(), pv, tab.data_ptr(), tab.shape[0], H, W, R,
                geo, vario, *ptrs, _MODELS[model], _SOLVERS[solver], int(with_variance),
                out.data_ptr(), stream,
            )
        del keep
        _raise_on(err, "fill_kriging_fused")
        LAUNCHES["fill_kriging_fused"] += 1
    return out


# ---------------------------------------------------------------------------
# B19: B1's selection and solve at a list of cells
# ---------------------------------------------------------------------------

def kriging_at_cells_fused_ref(grid: RegularGrid, rows: torch.Tensor, cols: torch.Tensor, *, max_radius: int = 10, convention: str = "reference", vparams=None, model: str = "exponential", solver: str = "gj", row0=0, col0=0, steps=None):
    """Plain version of :func:`kriging_at_cells_fused`: B1's plain version's
    whole plane (:func:`fill_kriging_fused_ref`), then the cells, NaN at a
    cell outside the grid."""
    plane = fill_kriging_fused_ref(grid, max_radius=max_radius, convention=convention, vparams=vparams,
                                   model=model, solver=solver, row0=row0, col0=col0, steps=steps)
    return plane_at_cells(plane, rows, cols)


@spanned
def kriging_at_cells_fused(grid: RegularGrid, rows, cols, *, max_radius: int = 10, convention: str = "reference", vparams=None, model: str = "exponential", solver: str = "gj"):
    """Ordinary kriging at a list of cells (B19): for each (row, col), B1's
    first-4-valid selection and 5x6 solve at that cell alone, so the value
    is the one :func:`fill_kriging_fused`'s plane holds there, bit for bit,
    with no plane made.  ``rows``, ``cols``: int64 tensors on the grid's
    device (anything else is converted,
    :func:`auvtpu_torch.ops.dense.cell_operands`), in any order, duplicates
    allowed; the result has their shape.  A cell outside the grid reads
    nothing and gets NaN (nothing is checked on the host).  One kernel
    launch, through the op ``auvtpu_torch::kriging_cells``, whose arguments
    are B1's and the cells."""
    if grid.elev.device.type != "cpu":
        _check_cuda_grid(grid, "kriging_at_cells_fused")
    rows, cols = cell_operands(rows, cols, grid.elev.device)
    geo = [grid.min_lon, grid.max_lon, grid.min_lat, grid.max_lat, grid.lat_step, grid.lon_step, 0.0, 0.0]
    return library.kriging_cells(grid.elev, grid.valid, rows, cols, library.variogram_tensor(vparams, grid.elev), geo,
                                 max_radius, convention, model, solver)


def kriging_cells_launch(grid: RegularGrid, rows: torch.Tensor, cols: torch.Tensor, vparams, *, max_radius: int, convention: str, model: str, solver: str, row0=0, col0=0, steps=None):
    """One B19 launch over a CUDA grid: the ``cuda`` implementation of
    ``auvtpu_torch::kriging_cells``.  ``vparams`` and ``row0``, ``col0``,
    ``steps`` as for :func:`kriging_launch` (its :func:`_kriging_params`).
    Returns the values at the cells, in ``rows``' shape."""
    dev = _check_cuda_grid(grid, "kriging_at_cells_fused")
    if model not in _MODELS:
        raise ValueError(model)
    if solver not in _SOLVERS:
        raise ValueError(solver)
    if (rows.dtype != torch.int64 or cols.dtype != torch.int64 or rows.device != dev or cols.device != dev
            or rows.shape != cols.shape or not rows.is_contiguous() or not cols.is_contiguous()):
        raise ValueError("kriging_at_cells_fused: rows and cols must be contiguous int64 tensors of one shape on "
                         f"the grid's device {dev} (got {rows.dtype} {tuple(rows.shape)} on {rows.device}, "
                         f"{cols.dtype} {tuple(cols.shape)} on {cols.device})")
    H, W = grid.shape
    R = max_radius
    pe, pv = _pitch(grid.elev, "kriging_at_cells_fused"), _pitch(grid.valid, "kriging_at_cells_fused")
    out = torch.empty(rows.shape, dtype=torch.float32, device=dev)
    n = out.numel()
    if n > 0:
        tab = _device_table(R, convention, dev)
        geo, vario, ptrs, keep = _kriging_params(grid, vparams, convention, row0, col0, steps, dev)
        stream = _stream(dev)
        with torch.cuda.device(dev), span("auvtpu_torch.kernels.window_fill.kriging_cells_launch:call"):
            err = _lib().auvtpu_kriging_cells(
                grid.elev.data_ptr(), pe, grid.valid.data_ptr(), pv, tab.data_ptr(), tab.shape[0], H, W, R,
                geo, vario, *ptrs, _MODELS[model], _SOLVERS[solver], rows.data_ptr(), cols.data_ptr(), n,
                out.data_ptr(), stream,
            )
        del keep
        _raise_on(err, "kriging_at_cells_fused")
        LAUNCHES["kriging_at_cells_fused"] += 1
    return out
