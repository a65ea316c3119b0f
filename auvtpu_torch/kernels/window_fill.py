"""Wrappers of the windowed-fill CUDA kernels (counterpart of
:mod:`auvtpu.pallas.window_fill`).

Four kernels, all in ``csrc/window_fill.cu``:

- :func:`topk_full` (B2, replaces ``_make_topk_full_kernel``): first-k-valid
  selection, returning (cnt, vals, dxs, dys) planes;
- :func:`topk_idx` (B4, replaces ``_make_topk_kernel``): the same selection
  as (cnt, slot table-index planes), a mode of B2's kernel;
- :func:`fill_kriging_fused` (B1, replaces ``_make_kriging_fill_kernel``):
  the same selection and the 5x6 ordinary-kriging solve in one pass;
- :func:`fill_idw_fused` and :func:`fill_mean_fused` (B3, replace
  ``_make_fill_kernel``): first-k-valid IDW and mean fills.

Each has a plain torch version beside it (``<wrapper>_ref``).  A wrapper runs
the plain version only for a grid on the CPU; for a CUDA grid it launches
its kernel or raises.  Each launch adds one to ``LAUNCHES[<wrapper name>]``,
so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..config import IDWConfig, KrigingConfig
from ..grid import RegularGrid
from ..ops.dense import (
    fill_idw,
    fill_window_mean,
    idw_denominators,
    krige_planes,
    window_topk_idx,
    window_topk_planes,
)
from ..tables import sorted_offsets

LAUNCHES = {
    "topk_full": 0,
    "topk_idx": 0,
    "fill_kriging_fused": 0,
    "fill_idw_fused": 0,
    "fill_mean_fused": 0,
}

MAX_K = 16  # slots the selection kernel keeps in registers
_MODELS = {"exponential": 0, "linear": 1, "spherical": 2, "gaussian": 3}
_SOLVERS = {"gj": 0, "lu": 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import load

    lib = load("window_fill")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.auvtpu_topk_full.argtypes = [P, P, I, I, I, I, I, P, P]
    lib.auvtpu_topk_full.restype = I
    lib.auvtpu_topk_idx.argtypes = [P, P, I, I, I, I, I, P, P]
    lib.auvtpu_topk_idx.restype = I
    lib.auvtpu_fill.argtypes = [P, P, P, I, I, I, I, I, I, ctypes.c_float, P, P]
    lib.auvtpu_fill.restype = I
    lib.auvtpu_kriging_fill.argtypes = [P, P, I, I, I, I, P, I, I, I, P, P]
    lib.auvtpu_kriging_fill.restype = I
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


def _check_cuda_grid(grid: RegularGrid, what: str) -> torch.device:
    dev = grid.elev.device
    if dev.type != "cuda":
        raise ValueError(
            f"{what}: grid lies on {dev}; the kernel takes a CUDA grid "
            "(a CPU grid runs the plain version)"
        )
    if grid.valid.device != dev:
        raise ValueError(f"{what}: elev on {dev} but valid on {grid.valid.device}")
    if grid.elev.dtype != torch.float32 or grid.valid.dtype != torch.float32:
        raise TypeError(
            f"{what}: the kernel is float32 only (got {grid.elev.dtype}/"
            f"{grid.valid.dtype}); float64 callers use the plain path on the CPU"
        )
    return dev


def _nan_padded(grid: RegularGrid, radius: int) -> torch.Tensor:
    """(H+2R, W+2R) f32 plane, NaN at invalid and out-of-grid cells."""
    H, W = grid.shape
    out = torch.full((H + 2 * radius, W + 2 * radius), float("nan"), dtype=torch.float32, device=grid.device)
    out[radius:radius + H, radius:radius + W] = torch.where(grid.valid > 0.5, grid.elev, float("nan"))
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


def topk_full(grid: RegularGrid, *, k: int = 4, max_radius: int = 10, convention: str = "reference"):
    """First-k-valid selection (B2): (cnt, vals[k], dxs[k], dys[k]) planes,
    as ``pallas_topk_full`` returns them: empty slots hold value 0 and
    offset (-R, -R), so consumers must mask slots >= cnt."""
    if grid.elev.device.type == "cpu":
        return topk_full_ref(grid, k=k, max_radius=max_radius, convention=convention)
    dev = _check_cuda_grid(grid, "topk_full")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_full: k={k} outside 1..{MAX_K}")
    H, W = grid.shape
    R = max_radius
    out = torch.empty((1 + 3 * k, H, W), dtype=torch.float32, device=dev)
    if H * W > 0:
        nanp = _nan_padded(grid, R)
        tab = _device_table(R, convention, dev)
        with torch.cuda.device(dev):
            err = _lib().auvtpu_topk_full(
                nanp.data_ptr(), tab.data_ptr(), tab.shape[0], H, W, R, k,
                out.data_ptr(), _stream(dev),
            )
        _raise_on(err, "topk_full")
        LAUNCHES["topk_full"] += 1
    return (
        out[0],
        [out[1 + s] for s in range(k)],
        [out[1 + k + s] for s in range(k)],
        [out[1 + 2 * k + s] for s in range(k)],
    )


# ---------------------------------------------------------------------------
# B4: first-k-valid selection as slot table indices (a mode of B2's kernel)
# ---------------------------------------------------------------------------

def topk_idx_ref(grid: RegularGrid, *, k: int = 4, max_radius: int = 10, convention: str = "reference"):
    """Plain version of :func:`topk_idx`: :func:`auvtpu_torch.ops.dense.window_topk_idx`."""
    return window_topk_idx(grid, k=k, max_radius=max_radius, convention=convention)


def topk_idx(grid: RegularGrid, *, k: int = 4, max_radius: int = 10, convention: str = "reference"):
    """First-k-valid selection (B4) as (cnt, [k index planes]), f32: each
    plane holds the sorted-table row of the slot's cell, -1 at an empty
    slot, as ``pallas_topk_idx`` returns them."""
    if grid.elev.device.type == "cpu":
        return topk_idx_ref(grid, k=k, max_radius=max_radius, convention=convention)
    dev = _check_cuda_grid(grid, "topk_idx")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_idx: k={k} outside 1..{MAX_K}")
    H, W = grid.shape
    R = max_radius
    out = torch.empty((1 + k, H, W), dtype=torch.float32, device=dev)
    if H * W > 0:
        nanp = _nan_padded(grid, R)
        tab = _device_table(R, convention, dev)
        with torch.cuda.device(dev):
            err = _lib().auvtpu_topk_idx(
                nanp.data_ptr(), tab.data_ptr(), tab.shape[0], H, W, R, k,
                out.data_ptr(), _stream(dev),
            )
        _raise_on(err, "topk_idx")
        LAUNCHES["topk_idx"] += 1
    return out[0], [out[1 + s] for s in range(k)]


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


def _fill(grid: RegularGrid, kind: int, name: str, *, k: int, power: float, max_radius: int, convention: str):
    dev = _check_cuda_grid(grid, name)
    H, W = grid.shape
    R = max_radius
    out = torch.empty((H, W), dtype=torch.float32, device=dev)
    if H * W > 0:
        nanp = _nan_padded(grid, R)
        tab = _device_table(R, convention, dev)
        wtab = _device_weights(R, float(power), convention, dev)
        with torch.cuda.device(dev):
            err = _lib().auvtpu_fill(
                nanp.data_ptr(), tab.data_ptr(), wtab.data_ptr(), tab.shape[0], H, W, R,
                kind, k, IDWConfig().eps, out.data_ptr(), _stream(dev),
            )
        _raise_on(err, name)
        LAUNCHES[name] += 1
    return out


def fill_idw_fused_ref(grid: RegularGrid, *, k: int = 8, power: float = 2.0, max_radius: int = 10, convention: str = "reference"):
    """Plain version of :func:`fill_idw_fused`: :func:`auvtpu_torch.ops.dense.fill_idw`."""
    return fill_idw(grid, k=k, power=power, max_radius=max_radius, convention=convention, backend="torch")


def fill_idw_fused(grid: RegularGrid, *, k: int = 8, power: float = 2.0, max_radius: int = 10, convention: str = "reference"):
    """First-k-valid IDW fill (B3): Σwv / max(Σw, eps) over the k nearest
    valid cells with static weights 1/(d2^(p/2)+eps), NaN where none is
    found; the semantics of ``pallas_fill_idw`` and ``ops.dense.fill_idw``."""
    if grid.elev.device.type == "cpu":
        return fill_idw_fused_ref(grid, k=k, power=power, max_radius=max_radius, convention=convention)
    return _fill(grid, 0, "fill_idw_fused", k=k, power=power, max_radius=max_radius, convention=convention)


def fill_mean_fused_ref(grid: RegularGrid, *, k: int = 4, max_radius: int = 10, convention: str = "reference"):
    """Plain version of :func:`fill_mean_fused`: :func:`auvtpu_torch.ops.dense.fill_window_mean`."""
    return fill_window_mean(grid, k=k, max_radius=max_radius, convention=convention, backend="torch")


def fill_mean_fused(grid: RegularGrid, *, k: int = 4, max_radius: int = 10, convention: str = "reference"):
    """First-k-valid mean fill (B3): the mean of the k nearest valid cells,
    NaN where none is found; the semantics of ``pallas_fill_mean`` and
    ``ops.dense.fill_window_mean``."""
    if grid.elev.device.type == "cpu":
        return fill_mean_fused_ref(grid, k=k, max_radius=max_radius, convention=convention)
    return _fill(grid, 1, "fill_mean_fused", k=k, power=0.0, max_radius=max_radius, convention=convention)


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


def _par(grid: RegularGrid, vparams, convention: str, row0, col0, steps, dev) -> torch.Tensor:
    """The kernel's 11 f32 parameters on ``dev`` (window_fill.py:884-891).
    Tensor entries (fitted variogram parameters) are copied on the device,
    never through the host."""
    cfg = KrigingConfig()
    if vparams is None:
        vparams = (cfg.variogram.nugget, cfg.variogram.sill, cfg.variogram.range)
    lat_step, lon_step = (grid.lat_step, grid.lon_step) if steps is None else steps
    half = 0.5 if convention == "reference" else 0.0
    vals = [
        *vparams, grid.min_lon, grid.min_lat, lon_step, lat_step,
        half, cfg.pivot_tol, row0, col0,
    ]
    par = torch.tensor(
        [0.0 if torch.is_tensor(v) else float(v) for v in vals], dtype=torch.float32
    ).to(dev)
    for i, v in enumerate(vals):
        if torch.is_tensor(v):
            par[i] = v
    return par


def fill_kriging_fused(grid: RegularGrid, *, max_radius: int = 10, convention: str = "reference", vparams=None, model: str = "exponential", solver: str = "gj", with_variance: bool = False, row0=0, col0=0, steps=None):
    """Fused ordinary-kriging fill (B1): first-4-valid selection and the 5x6
    solve per cell in one kernel, one read of the grid and one write of the
    plane.  Same arguments and semantics as ``pallas_fill_kriging``: the
    mean of the found neighbours where fewer than 4 were found or a pivot
    fell below 1e-12 (NaN where none was found); ``solver`` 'gj' (the
    reference's Gauss-Jordan) or 'lu' (within 1.5e-3 of it);
    ``with_variance`` also returns the variance plane (NaN at fallback
    cells); row0/col0/steps place a sub-plane in a larger grid."""
    if grid.elev.device.type == "cpu":
        return fill_kriging_fused_ref(
            grid, max_radius=max_radius, convention=convention, vparams=vparams,
            model=model, solver=solver, with_variance=with_variance,
            row0=row0, col0=col0, steps=steps,
        )
    dev = _check_cuda_grid(grid, "fill_kriging_fused")
    if model not in _MODELS:
        raise ValueError(model)
    if solver not in _SOLVERS:
        raise ValueError(solver)
    H, W = grid.shape
    R = max_radius
    out = torch.empty((2, H, W) if with_variance else (H, W), dtype=torch.float32, device=dev)
    if H * W > 0:
        nanp = _nan_padded(grid, R)
        tab = _device_table(R, convention, dev)
        par = _par(grid, vparams, convention, row0, col0, steps, dev)
        with torch.cuda.device(dev):
            err = _lib().auvtpu_kriging_fill(
                nanp.data_ptr(), tab.data_ptr(), tab.shape[0], H, W, R,
                par.data_ptr(), _MODELS[model], _SOLVERS[solver], int(with_variance),
                out.data_ptr(), _stream(dev),
            )
        _raise_on(err, "fill_kriging_fused")
        LAUNCHES["fill_kriging_fused"] += 1
    if with_variance:
        return out[0], out[1]
    return out
