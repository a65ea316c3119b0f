"""Every hand-written kernel as a ``torch.library`` custom op.

A ctypes launch on a raw pointer is opaque to the dispatcher, so to
``torch.export`` and to :func:`auvtpu_torch.utils.debug_mode`; every kernel
of the package is therefore registered as an operator of the
``auvtpu_torch`` namespace (a ``torch.library.Library`` definition each,
with no autograd kernel: a call goes through the C++ dispatcher straight to
the device's implementation):

- ``auvtpu_torch::kriging_fill`` (B1, ``csrc/window_fill.cu``
  ``kriging_fill_kernel``) and ``auvtpu_torch::kriging_cells`` (B19,
  ``kriging_cells_kernel``: B1 at a list of cells);
- ``auvtpu_torch::topk_full`` (B2, ``topk_tile_kernel``) and
  ``auvtpu_torch::topk_idx`` (B4, ``topk_idx_kernel``), the first-k-valid
  selections;
- ``auvtpu_torch::window_fill`` (B3, ``fill_tile_kernel``: kind 0 IDW, 1
  mean);
- ``auvtpu_torch::valid_select`` (B5, ``csrc/scattered_select.cu``
  ``select_kernel``), ``auvtpu_torch::idw_select`` (B6,
  ``idw_select_kernel``), ``auvtpu_torch::window_select`` (B7,
  ``window_select_kernel``), ``auvtpu_torch::select_krige`` (B11,
  ``select_krige_kernel``), ``auvtpu_torch::window_krige`` (B12,
  ``window_krige_kernel``) and ``auvtpu_torch::window_idw`` (B15,
  ``window_idw_kernel``), the scattered-query selections;
- ``auvtpu_torch::exact_dense`` and ``::exact_dense_krige`` (B13,
  ``csrc/exact_select.cu`` ``dense_kernel``: the two-tier dense pass, with
  the table solve) and ``auvtpu_torch::exact_ring`` and
  ``::exact_ring_krige`` (B14, ``ring_kernel``: the strict selection, with
  the table solve), exact mode's selections, and
  ``auvtpu_torch::exact_prologue`` (B16, ``csrc/exact_prologue.cu``
  ``prologue_kernel``), its query preparation, and
  ``auvtpu_torch::exact_krige`` with its overload ``::exact_krige.mean_into``
  (B17, ``csrc/exact_epilogue.cu`` ``krige_kernel``: the coordinate-form
  f64 solve, or the fallback mean alone scattered into an output) and
  ``auvtpu_torch::exact_patch`` (B18, ``patch_kernel``: the bilinear and
  Catmull-Rom patch), its epilogues;
- ``auvtpu_torch::band_resample`` (B8, ``csrc/band_resample.cu``);
- ``auvtpu_torch::pair_sums`` (B9, ``csrc/variogram.cu``, the binned
  variogram pair sums) and ``auvtpu_torch::fit_model`` (B10, the
  Gauss-Newton variogram fit) with its overload ``::fit_model.binned`` (B10
  on B9's float64 sums), so a fit-then-fill runs through the dispatcher as
  a fill does.

Each op takes tensors and python scalars only: a grid is unpacked into its
``elev`` and ``valid`` planes with its extent as floats, the variogram is
one tensor (B11, B12: a list of one (3,) tensor or three 0-d ones), and
what a kernel takes by value from the host (the taps of B6, B7, B11, B12
and B15, the grid scalars of B6, B11, B12 and B15) is worked out by the wrapper,
once, before the call: B7's taps a
list of floats, the others CPU tensors the launch reads on the host (a
list costs the dispatcher a conversion a value, each call).
Its ``CUDA`` implementation is the ctypes launch (with the launch count,
the checks and the errors it always had), its ``CPU`` implementation the
kernel's plain version, and its fake implementation gives the output's
shape and dtype for tracing.  The wrappers in :mod:`.window_fill`,
:mod:`.scattered_select`, :mod:`.valid_select`, :mod:`.band_resample`,
:mod:`.variogram`, :mod:`.exact_select`, :mod:`.exact_prologue` and :mod:`.exact_epilogue` call these ops and launch no
kernel themselves, so a live call, an exported program and a call under
debug mode take one route.

Importing this module registers the ops and builds nothing; a program
loaded with ``torch.export.load`` needs it imported first.
"""

from __future__ import annotations

import torch

from ..config import KrigingConfig
from ..grid import RegularGrid, device_cache

NAMESPACE = "auvtpu_torch"


def _grid(elev, valid, extent) -> RegularGrid:
    return RegularGrid(elev=elev, valid=valid, min_lon=extent[0], max_lon=extent[1], min_lat=extent[2],
                       max_lat=extent[3])


def variogram_tensor(vparams, like: torch.Tensor) -> torch.Tensor:
    """The variogram's (nugget, sill, range) as one (3,) tensor of ``like``'s
    dtype, for :func:`kriging_fill`.  ``vparams``: None (the reference's
    fixed model), three numbers (a constant tensor on ``like``'s device,
    made once per value), a (3,) tensor, or three 0-d tensors: views of one
    (3,) tensor, as a fit returns them, are that tensor with no copy and no
    launch; others are stacked."""
    if vparams is None:
        return _default_variogram(like.dtype, like.device)
    if torch.is_tensor(vparams):
        if vparams.shape != (3,):
            raise ValueError(f"variogram parameters: a (3,) tensor, got {tuple(vparams.shape)}")
        return vparams.to(like.dtype)
    if len(vparams) != 3:
        raise ValueError(f"variogram parameters: three values, got {len(vparams)}")
    if not any(torch.is_tensor(v) for v in vparams):
        key = (tuple(float(v) for v in vparams), like.dtype, like.device)
        return _constant(*key)
    for i, v in enumerate(vparams):
        if torch.is_tensor(v) and v.numel() != 1:
            raise ValueError(f"variogram parameter {i} has {v.numel()} elements, want one")
    base = vparams[0]._base if torch.is_tensor(vparams[0]) else None
    if (base is not None and base.shape == (3,) and base.dtype == like.dtype and base.device == like.device
            and all(torch.is_tensor(v) and v._base is base and v.dim() == 0
                    and v.storage_offset() == base.storage_offset() + i * base.stride(0)
                    for i, v in enumerate(vparams))):
        return base
    return torch.stack([torch.as_tensor(v).reshape(()).to(like.device, like.dtype) for v in vparams])


def variogram_tensors(vparams, like: torch.Tensor) -> list[torch.Tensor]:
    """B11's variogram operand: three 0-d tensors on ``like``'s device that
    are not views of one (3,) tensor, as they are (stacking them would be a
    kernel a call); else ``[variogram_tensor(vparams, like)]``."""
    if (isinstance(vparams, (tuple, list)) and len(vparams) == 3
            and all(torch.is_tensor(v) and v.dim() == 0 and v.device == like.device for v in vparams)
            and (vparams[0]._base is None or vparams[0]._base.shape != (3,))):
        return list(vparams)
    return [variogram_tensor(vparams, like)]


@device_cache(maxsize=8)
def _default_variogram(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    v = KrigingConfig().variogram
    return _constant((float(v.nugget), float(v.sill), float(v.range)), dtype, device)


@device_cache(maxsize=32)
def _constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# registration: a schema and the CPU, CUDA and fake implementations, with no
# autograd kernel (no op here has a gradient), so a call is one trip through
# the C++ dispatcher to the device's implementation
# ---------------------------------------------------------------------------

_LIB = torch.library.Library(NAMESPACE, "DEF")


def _op(schema: str, *, cpu, cuda, fake):
    """Define ``auvtpu_torch::<schema>`` (``name.overload(...)`` for an
    overload) with its implementations; returns the overload the wrappers
    call."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    base, _, overload = name.partition(".")
    return getattr(getattr(getattr(torch.ops, NAMESPACE), base), overload or "default")


# ---------------------------------------------------------------------------
# B1: fused selection + ordinary-kriging solve.  Over the (H, W) planes: the
# kriging plane, or (2, H, W) with the variance.  vario (3,) (nugget, sill,
# range); geo (min_lon, max_lon, min_lat, max_lat, lat_step, lon_step, row0,
# col0).
# ---------------------------------------------------------------------------

def _kriging_args(elev, valid, geo):
    return _grid(elev, valid, geo[:4]), dict(steps=(geo[4], geo[5]), row0=geo[6], col0=geo[7])


def _kriging_cpu(elev, valid, vario, geo, max_radius, convention, model, solver, with_variance):
    from .window_fill import fill_kriging_fused_ref

    grid, place = _kriging_args(elev, valid, geo)
    out = fill_kriging_fused_ref(grid, max_radius=max_radius, convention=convention,
                                 vparams=tuple(float(v) for v in vario), model=model, solver=solver,
                                 with_variance=with_variance, **place)
    return torch.stack(out) if with_variance else out


def _kriging_cuda(elev, valid, vario, geo, max_radius, convention, model, solver, with_variance):
    from .window_fill import kriging_launch

    grid, place = _kriging_args(elev, valid, geo)
    return kriging_launch(grid, vario, max_radius=max_radius, convention=convention, model=model, solver=solver,
                          with_variance=with_variance, **place)


def _kriging_fake(elev, valid, vario, geo, max_radius, convention, model, solver, with_variance):
    return elev.new_empty(((2,) if with_variance else ()) + tuple(elev.shape))


kriging_fill = _op(
    "kriging_fill(Tensor elev, Tensor valid, Tensor vario, float[] geo, int max_radius, str convention, "
    "str model, str solver, bool with_variance) -> Tensor",
    cpu=_kriging_cpu, cuda=_kriging_cuda, fake=_kriging_fake)


# ---------------------------------------------------------------------------
# B19: B1 at a list of cells.  rows, cols: int64 cells of one shape; the
# values there, in that shape, NaN at a cell outside the grid.  vario and
# geo as for B1.
# ---------------------------------------------------------------------------

def _cells_cpu(elev, valid, rows, cols, vario, geo, max_radius, convention, model, solver):
    from .window_fill import kriging_at_cells_fused_ref

    grid, place = _kriging_args(elev, valid, geo)
    return kriging_at_cells_fused_ref(grid, rows, cols, max_radius=max_radius, convention=convention,
                                      vparams=tuple(float(v) for v in vario), model=model, solver=solver, **place)


def _cells_cuda(elev, valid, rows, cols, vario, geo, max_radius, convention, model, solver):
    from .window_fill import kriging_cells_launch

    grid, place = _kriging_args(elev, valid, geo)
    return kriging_cells_launch(grid, rows, cols, vario, max_radius=max_radius, convention=convention, model=model,
                                solver=solver, **place)


def _cells_fake(elev, valid, rows, cols, vario, geo, max_radius, convention, model, solver):
    return elev.new_empty(rows.shape)


kriging_cells = _op(
    "kriging_cells(Tensor elev, Tensor valid, Tensor rows, Tensor cols, Tensor vario, float[] geo, int max_radius, "
    "str convention, str model, str solver) -> Tensor",
    cpu=_cells_cpu, cuda=_cells_cuda, fake=_cells_fake)


# ---------------------------------------------------------------------------
# B2 and B4: first-k-valid selection over the (H, W) planes, as (1+3k, H, W)
# planes [cnt, k vals, k dxs, k dys] (B2) or (1+k, H, W) [cnt, k table
# rows] (B4).  B2 reads the planes as they are (views with any row stride);
# B4's NaN-padded plane is built inside its CUDA implementation.
# ---------------------------------------------------------------------------

def _topk_full_cpu(elev, valid, k, max_radius, convention):
    from .window_fill import topk_full_ref

    cnt, vals, dxs, dys = topk_full_ref(_grid(elev, valid, (0.0, 1.0, 0.0, 1.0)), k=k, max_radius=max_radius,
                                        convention=convention)  # the selection reads no coordinate
    return torch.stack([cnt, *vals, *dxs, *dys])


def _topk_full_fake(elev, valid, k, max_radius, convention):
    return elev.new_empty((1 + 3 * k, *elev.shape))


def _topk_full_cuda(elev, valid, k, max_radius, convention):
    from .window_fill import topk_full_launch

    return topk_full_launch(elev, valid, k, max_radius, convention)


topk_full = _op("topk_full(Tensor elev, Tensor valid, int k, int max_radius, str convention) -> Tensor",
                cpu=_topk_full_cpu, cuda=_topk_full_cuda, fake=_topk_full_fake)


def _topk_idx_cpu(elev, valid, k, max_radius, convention):
    from .window_fill import topk_idx_ref

    cnt, idx = topk_idx_ref(_grid(elev, valid, (0.0, 1.0, 0.0, 1.0)), k=k, max_radius=max_radius,
                            convention=convention)
    return torch.stack([cnt, *idx])


def _topk_idx_fake(elev, valid, k, max_radius, convention):
    return elev.new_empty((1 + k, *elev.shape))


def _topk_idx_cuda(elev, valid, k, max_radius, convention):
    from .window_fill import topk_idx_launch

    return topk_idx_launch(elev, valid, k, max_radius, convention)


topk_idx = _op("topk_idx(Tensor elev, Tensor valid, int k, int max_radius, str convention) -> Tensor",
               cpu=_topk_idx_cpu, cuda=_topk_idx_cuda, fake=_topk_idx_fake)


# ---------------------------------------------------------------------------
# B3: first-k-valid IDW (kind 0) and mean (kind 1) fills over the (H, W)
# planes
# ---------------------------------------------------------------------------

def _fill_cpu(elev, valid, kind, k, power, max_radius, convention, keep_observed):
    from .window_fill import fill_idw_fused_ref, fill_mean_fused_ref

    grid = _grid(elev, valid, (0.0, 1.0, 0.0, 1.0))  # the fills read no coordinate
    kw = dict(k=k, max_radius=max_radius, convention=convention, keep_observed=keep_observed)
    return fill_idw_fused_ref(grid, power=power, **kw) if kind == 0 else fill_mean_fused_ref(grid, **kw)


def _fill_cuda(elev, valid, kind, k, power, max_radius, convention, keep_observed):
    from .window_fill import fill_launch

    return fill_launch(_grid(elev, valid, (0.0, 1.0, 0.0, 1.0)), kind, k=k, power=power, max_radius=max_radius,
                       convention=convention, keep_observed=keep_observed)


def _fill_fake(elev, valid, kind, k, power, max_radius, convention, keep_observed):
    return elev.new_empty(elev.shape)


window_fill = _op(
    "window_fill(Tensor elev, Tensor valid, int kind, int k, float power, int max_radius, str convention, "
    "bool keep_observed) -> Tensor",
    cpu=_fill_cpu, cuda=_fill_cuda, fake=_fill_fake)


# ---------------------------------------------------------------------------
# B7: window top-k from a stencil pack: (N, 1+3k) rows [cnt, vals, d2s,
# codes] over the pack rows ``cell``.  tab is the (3, P) 'dx' table (the
# plain version's); taps the kernel's by-value taps
# (scattered_select._window_taps), empty for a CPU pack.
# ---------------------------------------------------------------------------

def _select_cpu(pack, cell, fx, fy, tab, taps, P, k, half):
    from .scattered_select import select_ref

    return select_ref(pack, P, cell, fx, fy, tab, mode="rows_n", k=k, half=half)


def _select_cuda(pack, cell, fx, fy, tab, taps, P, k, half):
    from .scattered_select import window_launch

    return window_launch(pack, P, cell, fx, fy, tab, taps, k)


def _select_fake(pack, cell, fx, fy, tab, taps, P, k, half):
    return pack.new_empty((cell.shape[0], 1 + 3 * k))


window_select = _op(
    "window_select(Tensor pack, Tensor cell, Tensor fx, Tensor fy, Tensor tab, float[] taps, int P, int k, "
    "float half) -> Tensor",
    cpu=_select_cpu, cuda=_select_cuda, fake=_select_fake)


# ---------------------------------------------------------------------------
# B5: transposed top-k rows (1+2k[+k][+1], N) [cnt, k vals, (k d2), k codes,
# (resolved)] over the pack rows ``cell``, with the (3, P) 'dy' table
# ---------------------------------------------------------------------------

def _rows_cpu(pack, cell, fx, fy, tab, P, k, emit_d2, half, resolve_thresh):
    from .scattered_select import select_ref

    return select_ref(pack, P, cell, fx, fy, tab, mode="rows_t", k=k, emit_d2=emit_d2, half=half,
                      resolve_thresh=resolve_thresh)


def _rows_cuda(pack, cell, fx, fy, tab, P, k, emit_d2, half, resolve_thresh):
    from .scattered_select import rows_launch

    return rows_launch(pack, P, cell, fx, fy, tab, k, emit_d2, half, resolve_thresh)


def _rows_fake(pack, cell, fx, fy, tab, P, k, emit_d2, half, resolve_thresh):
    return pack.new_empty((1 + (3 if emit_d2 else 2) * k + int(resolve_thresh is not None), cell.shape[0]))


valid_select = _op(
    "valid_select(Tensor pack, Tensor cell, Tensor fx, Tensor fy, Tensor tab, int P, int k, bool emit_d2, "
    "float half, float? resolve_thresh) -> Tensor",
    cpu=_rows_cpu, cuda=_rows_cuda, fake=_rows_fake)


# ---------------------------------------------------------------------------
# The scattered kernels that compute the query prologue themselves, at the
# queries (qlon, qlat) (the grid's dtype, contiguous), with geo the grid's
# scalars, a (10,) float64 CPU tensor (scattered_select._krige_geo: bounds,
# reciprocal steps, steps, half, pivot tolerance), and taps the kernel's
# by-value taps, a CPU float32 tensor, empty for a CPU pack.  Taps and
# scalars travel as tensors: one operand through the dispatcher each, where
# a list of floats is one a value.  The plain versions read the grid's
# shape, not its cells: a 0-d plane expanded to (H, W) stands for it.
# ---------------------------------------------------------------------------

def _geo_grid(qlon, geo, num_lon, num_lat) -> RegularGrid:
    plane = qlon.new_empty(()).expand(num_lat, num_lon)
    return _grid(plane, plane, geo.tolist()[:4])


def _vparams(vario) -> tuple:
    return tuple(float(v) for v in (vario[0] if len(vario) == 1 else vario))


# B6: the power-2 IDW value (1[+1], N) [value, (resolved)]; tab the (3, P)
# 'dy' table, taps scattered_select._idw_taps's
def _idw_cpu(pack, tab, qlon, qlat, taps, geo, P, num_lon, num_lat, k, resolve_thresh, eps):
    from .scattered_select import idw_select_plain

    return idw_select_plain(pack, P, tab, _geo_grid(qlon, geo, num_lon, num_lat), qlon, qlat, k=k,
                            half=float(geo[8]), resolve_thresh=resolve_thresh, eps=eps)


def _idw_cuda(pack, tab, qlon, qlat, taps, geo, P, num_lon, num_lat, k, resolve_thresh, eps):
    from .scattered_select import idw_launch

    return idw_launch(pack, P, qlon, qlat, taps, geo, num_lon, num_lat, k, resolve_thresh, eps)


def _idw_fake(pack, tab, qlon, qlat, taps, geo, P, num_lon, num_lat, k, resolve_thresh, eps):
    return qlon.new_empty((1 + int(resolve_thresh is not None), qlon.shape[0]))


idw_select = _op(
    "idw_select(Tensor pack, Tensor tab, Tensor qlon, Tensor qlat, Tensor taps, Tensor geo, int P, int num_lon, "
    "int num_lat, int k, float? resolve_thresh, float eps) -> Tensor",
    cpu=_idw_cpu, cuda=_idw_cuda, fake=_idw_fake)


# B11: the valid top-4 and the ordinary-kriging solve, (1[+1], N) rows
# [prediction, (resolved)]; tab the (3, P) 'dy' table, taps
# scattered_select._krige_taps's; vario one (3,) tensor or three 0-d
# tensors (library.variogram_tensors), read on the device
def _krige_cpu(pack, tab, qlon, qlat, vario, taps, geo, P, R, num_lon, num_lat, model, resolve_thresh):
    from .scattered_select import select_krige_plain

    return select_krige_plain(pack, P, tab, R, _geo_grid(qlon, geo, num_lon, num_lat), qlon, qlat,
                              half=float(geo[8]), vparams=_vparams(vario), model=model, resolve_thresh=resolve_thresh)


def _krige_cuda(pack, tab, qlon, qlat, vario, taps, geo, P, R, num_lon, num_lat, model, resolve_thresh):
    from .scattered_select import krige_launch

    return krige_launch(pack, P, qlon, qlat, vario, taps, geo, num_lon, num_lat, model, resolve_thresh)


def _krige_fake(pack, tab, qlon, qlat, vario, taps, geo, P, R, num_lon, num_lat, model, resolve_thresh):
    return qlon.new_empty((1 + int(resolve_thresh is not None), qlon.shape[0]))


select_krige = _op(
    "select_krige(Tensor pack, Tensor tab, Tensor qlon, Tensor qlat, Tensor[] vario, Tensor taps, Tensor geo, "
    "int P, int R, int num_lon, int num_lat, str model, float? resolve_thresh) -> Tensor",
    cpu=_krige_cpu, cuda=_krige_cuda, fake=_krige_fake)


# B12: B7's window top-4 and the same solve, (N,) predictions (NaN where no
# tap was found); tab the (3, P) 'dx' table, taps
# scattered_select._window_krige_taps's, vario as for B11
def _window_krige_cpu(pack, tab, qlon, qlat, vario, taps, geo, P, R, num_lon, num_lat, model):
    from .scattered_select import window_krige_plain

    return window_krige_plain(pack, P, tab, R, _geo_grid(qlon, geo, num_lon, num_lat), qlon, qlat,
                              half=float(geo[8]), vparams=_vparams(vario), model=model)


def _window_krige_cuda(pack, tab, qlon, qlat, vario, taps, geo, P, R, num_lon, num_lat, model):
    from .scattered_select import window_krige_launch

    return window_krige_launch(pack, P, qlon, qlat, vario, taps, geo, num_lon, num_lat, model)


def _window_krige_fake(pack, tab, qlon, qlat, vario, taps, geo, P, R, num_lon, num_lat, model):
    return qlon.new_empty(qlon.shape)


window_krige = _op(
    "window_krige(Tensor pack, Tensor tab, Tensor qlon, Tensor qlat, Tensor[] vario, Tensor taps, Tensor geo, "
    "int P, int R, int num_lon, int num_lat, str model) -> Tensor",
    cpu=_window_krige_cpu, cuda=_window_krige_cuda, fake=_window_krige_fake)


# B15: B7's window top-k and the IDW weights and quotient, (N,) values (NaN
# where no tap was found and out of the grid); tab the (3, P) 'dx' table,
# taps scattered_select._window_krige_taps's; power any float, eps
# IDWConfig(k, power).eps
def _window_idw_cpu(pack, tab, qlon, qlat, taps, geo, P, R, num_lon, num_lat, k, power, eps):
    from .scattered_select import window_idw_plain

    return window_idw_plain(pack, P, tab, R, _geo_grid(qlon, geo, num_lon, num_lat), qlon, qlat, k=k,
                            half=float(geo[8]), power=power, eps=eps)


def _window_idw_cuda(pack, tab, qlon, qlat, taps, geo, P, R, num_lon, num_lat, k, power, eps):
    from .scattered_select import window_idw_launch

    return window_idw_launch(pack, P, qlon, qlat, taps, geo, num_lon, num_lat, k, power, eps)


def _window_idw_fake(pack, tab, qlon, qlat, taps, geo, P, R, num_lon, num_lat, k, power, eps):
    return qlon.new_empty(qlon.shape)


window_idw = _op(
    "window_idw(Tensor pack, Tensor tab, Tensor qlon, Tensor qlat, Tensor taps, Tensor geo, int P, int R, "
    "int num_lon, int num_lat, int k, float power, float eps) -> Tensor",
    cpu=_window_idw_cpu, cuda=_window_idw_cuda, fake=_window_idw_fake)


# ---------------------------------------------------------------------------
# B13: exact mode's two-tier dense pass at the query cells flat_q, with the
# aligned queries' cells flat_a and (2, P_a) float32 residue keys (flat_a
# None: every query aligned, (2, P) keys of its own):
# exact_dense gives (found, tie, vals (4, P), dgi, dgj (4, P) int64),
# exact_dense_krige (pred (P,) float64, tie) with the lattice tables gpair
# and gq.  B14: the strict ring selection of (N,) int64 anchors, keyed by
# (variant, f32 ex, ey) or, with no variant, the f64 coordinates (x, y):
# exact_ring gives (found, sel_val (N, 4), sel_gi, sel_gj), exact_ring_krige
# the (N,) float64 table-solve predictions with offsets from (qcol, qrow).
# chunk bounds the plain versions' temporaries; the kernels ignore it.
# ---------------------------------------------------------------------------

def _dense_cpu(elev, valid, flat_a, keys, flat_q, max_radius):
    from .exact_select import dense_select_ref

    return dense_select_ref(elev, valid, flat_a, keys, flat_q, max_radius)


def _dense_cuda(elev, valid, flat_a, keys, flat_q, max_radius):
    from .exact_select import dense_launch

    return dense_launch(elev, valid, flat_a, keys, flat_q, None, None, max_radius)


def _dense_fake(elev, valid, flat_a, keys, flat_q, max_radius):
    n = flat_q.shape[0]
    return (flat_q.new_empty(n, dtype=torch.int32), flat_q.new_empty(n, dtype=torch.bool), elev.new_empty((4, n)),
            flat_q.new_empty((4, n), dtype=torch.int64), flat_q.new_empty((4, n), dtype=torch.int64))


exact_dense = _op(
    "exact_dense(Tensor elev, Tensor valid, Tensor? flat_a, Tensor keys, Tensor flat_q, int max_radius) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    cpu=_dense_cpu, cuda=_dense_cuda, fake=_dense_fake)


def _dense_krige_cpu(elev, valid, flat_a, keys, flat_q, gpair, gq, max_radius):
    from .exact_select import dense_krige_ref

    return dense_krige_ref(elev, valid, flat_a, keys, flat_q, gpair, gq, max_radius)


def _dense_krige_cuda(elev, valid, flat_a, keys, flat_q, gpair, gq, max_radius):
    from .exact_select import dense_launch

    return dense_launch(elev, valid, flat_a, keys, flat_q, gpair, gq, max_radius)


def _dense_krige_fake(elev, valid, flat_a, keys, flat_q, gpair, gq, max_radius):
    n = flat_q.shape[0]
    return flat_q.new_empty(n, dtype=torch.float64), flat_q.new_empty(n, dtype=torch.bool)


exact_dense_krige = _op(
    "exact_dense_krige(Tensor elev, Tensor valid, Tensor? flat_a, Tensor keys, Tensor flat_q, Tensor gpair, "
    "Tensor gq, int max_radius) -> (Tensor, Tensor)",
    cpu=_dense_krige_cpu, cuda=_dense_krige_cuda, fake=_dense_krige_fake)


def _ring_cpu(elev, valid, ci, cj, k0, k1, variant, max_radius, chunk):
    from .exact_select import ring_select_ref

    return ring_select_ref(elev, valid, ci, cj, k0, k1, variant, max_radius, chunk)


def _ring_cuda(elev, valid, ci, cj, k0, k1, variant, max_radius, chunk):
    from .exact_select import ring_launch

    return ring_launch(elev, valid, ci, cj, k0, k1, variant, None, None, None, None, max_radius)


def _ring_fake(elev, valid, ci, cj, k0, k1, variant, max_radius, chunk):
    n = ci.shape[0]
    return (ci.new_empty(n, dtype=torch.int32), elev.new_empty((n, 4)), ci.new_empty((n, 4), dtype=torch.int32),
            ci.new_empty((n, 4), dtype=torch.int32))


exact_ring = _op(
    "exact_ring(Tensor elev, Tensor valid, Tensor ci, Tensor cj, Tensor k0, Tensor k1, Tensor? variant, "
    "int max_radius, int chunk) -> (Tensor, Tensor, Tensor, Tensor)",
    cpu=_ring_cpu, cuda=_ring_cuda, fake=_ring_fake)


def _ring_krige_cpu(elev, valid, ci, cj, variant, ex, ey, qcol, qrow, gpair, gq, max_radius, chunk):
    from .exact_select import ring_krige_ref

    return ring_krige_ref(elev, valid, ci, cj, variant, ex, ey, qcol, qrow, gpair, gq, max_radius, chunk)


def _ring_krige_cuda(elev, valid, ci, cj, variant, ex, ey, qcol, qrow, gpair, gq, max_radius, chunk):
    from .exact_select import ring_launch

    return ring_launch(elev, valid, ci, cj, ex, ey, variant, qcol, qrow, gpair, gq, max_radius)


def _ring_krige_fake(elev, valid, ci, cj, variant, ex, ey, qcol, qrow, gpair, gq, max_radius, chunk):
    return ci.new_empty(ci.shape[0], dtype=torch.float64)


exact_ring_krige = _op(
    "exact_ring_krige(Tensor elev, Tensor valid, Tensor ci, Tensor cj, Tensor variant, Tensor ex, Tensor ey, "
    "Tensor qcol, Tensor qrow, Tensor gpair, Tensor gq, int max_radius, int chunk) -> Tensor",
    cpu=_ring_krige_cpu, cuda=_ring_krige_cuda, fake=_ring_krige_fake)


# ---------------------------------------------------------------------------
# B16: exact mode's query preparation at (N,) queries (a, b): int32 or int64
# columns and rows, or float64 longitudes and latitudes; geo the grid's
# (min_lon, max_lon, min_lat, max_lat, lon_step, lat_step); fields the
# outputs to write (exact_prologue.KEYS ...).  Gives (anchors (2, N) int64,
# oob, counts (2,) int32, keys (2, N) f32, variant, geo (2, N) f64, xy (2, N)
# f64, aligned, flat), each output fields leaves out empty
# ---------------------------------------------------------------------------

def _prologue_cpu(a, b, geo, num_lon, num_lat, round_anchor, fields, eps_scale):
    from .exact_prologue import prologue_ref

    return prologue_ref(a, b, geo, num_lon, num_lat, round_anchor, fields, eps_scale)


def _prologue_cuda(a, b, geo, num_lon, num_lat, round_anchor, fields, eps_scale):
    from .exact_prologue import prologue_launch

    return prologue_launch(a, b, geo, num_lon, num_lat, round_anchor, fields, eps_scale)


def _prologue_fake(a, b, geo, num_lon, num_lat, round_anchor, fields, eps_scale):
    from .exact_prologue import _check, _outputs

    _check(a, b, fields)
    return tuple(_outputs(a, fields))


exact_prologue = _op(
    "exact_prologue(Tensor a, Tensor b, float[] geo, int num_lon, int num_lat, bool round_anchor, int fields, "
    "float eps_scale) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    cpu=_prologue_cpu, cuda=_prologue_cuda, fake=_prologue_fake)


# ---------------------------------------------------------------------------
# B17: exact mode's coordinate-form kriging of (N,) selections (found int32,
# sel_val (N, 4), sel_gi, sel_gj (N, 4) int32 or int64) at f64 (qlon, qlat);
# scalars (min_lon, min_lat, lon_step, lat_step, nugget, sill, range,
# pivot_tol): the (N,) float64 predictions.  mean_into: the fallback mean
# alone written to out[idx].  B18: the bilinear (kind 0) or Catmull-Rom
# (kind 1) patch at (N,) int64 floor anchors and f64 grid coordinates, at
# cells (the cubic with the selection's found, sel_val) or scattered (the
# cubic with oob): (out (N,) float64, need (N,) bool or (0,)).  chunk
# bounds the plain version's temporaries; the kernel ignores it.
# ---------------------------------------------------------------------------

def _exact_krige_cpu(found, sel_val, sel_gi, sel_gj, qlon, qlat, scalars):
    from .exact_epilogue import _check_krige, krige_ref

    _check_krige(found, sel_val, sel_gi, sel_gj, qlon, qlat)
    return krige_ref(found, sel_val, sel_gi, sel_gj, qlon, qlat, scalars)


def _exact_krige_cuda(found, sel_val, sel_gi, sel_gj, qlon, qlat, scalars):
    from .exact_epilogue import krige_launch

    return krige_launch(found, sel_val, sel_gi, sel_gj, qlon, qlat, scalars)


def _exact_krige_fake(found, sel_val, sel_gi, sel_gj, qlon, qlat, scalars):
    from .exact_epilogue import _check_krige

    _check_krige(found, sel_val, sel_gi, sel_gj, qlon, qlat)
    return found.new_empty(found.shape[0], dtype=torch.float64)


exact_krige = _op(
    "exact_krige(Tensor found, Tensor sel_val, Tensor sel_gi, Tensor sel_gj, Tensor qlon, Tensor qlat, "
    "float[] scalars) -> Tensor",
    cpu=_exact_krige_cpu, cuda=_exact_krige_cuda, fake=_exact_krige_fake)


def _mean_into_cpu(found, sel_val, idx, out):
    from .exact_epilogue import _check_krige, mean_into_ref

    _check_krige(found, sel_val, idx=idx, out=out)
    mean_into_ref(found, sel_val, idx, out)


def _mean_into_cuda(found, sel_val, idx, out):
    from .exact_epilogue import krige_launch

    krige_launch(found, sel_val, None, None, None, None, [0.0] * 8, idx, out)


def _mean_into_fake(found, sel_val, idx, out):
    from .exact_epilogue import _check_krige

    _check_krige(found, sel_val, idx=idx, out=out)


exact_krige_mean_into = _op(
    "exact_krige.mean_into(Tensor found, Tensor sel_val, Tensor idx, Tensor(a!) out) -> ()",
    cpu=_mean_into_cpu, cuda=_mean_into_cuda, fake=_mean_into_fake)


def _patch_cpu(elev, valid, ci, cj, x, y, found, sel_val, oob, kind, at_cells, chunk):
    from .exact_epilogue import patch_ref

    return patch_ref(elev, valid, ci, cj, x, y, found, sel_val, oob, kind, at_cells, chunk)


def _patch_cuda(elev, valid, ci, cj, x, y, found, sel_val, oob, kind, at_cells, chunk):
    from .exact_epilogue import patch_launch

    return patch_launch(elev, valid, ci, cj, x, y, found, sel_val, oob, kind, at_cells)


def _patch_fake(elev, valid, ci, cj, x, y, found, sel_val, oob, kind, at_cells, chunk):
    from .exact_epilogue import _check_patch, patch_outputs

    _check_patch(elev, valid, ci, cj, x, y, found, sel_val, oob, kind, at_cells)
    return patch_outputs(elev, ci, kind, at_cells)


exact_patch = _op(
    "exact_patch(Tensor elev, Tensor valid, Tensor ci, Tensor cj, Tensor x, Tensor y, Tensor? found, "
    "Tensor? sel_val, Tensor? oob, int kind, bool at_cells, int chunk) -> (Tensor, Tensor)",
    cpu=_patch_cpu, cuda=_patch_cuda, fake=_patch_fake)


# ---------------------------------------------------------------------------
# B8: chunked windowed bilinear over band or atlas pages: (z (N,), ok (N,)
# bool) as band_resample.band_resample_ref gives them
# ---------------------------------------------------------------------------

def _resample_cpu(planes, vmasks, origins, x, y, chunk, wr, wc, pick, aligned, hat, affine):
    from .band_resample import band_resample_ref

    return band_resample_ref(planes, vmasks, origins, x, y, chunk=chunk, wr=wr, wc=wc, pick=pick, aligned=aligned,
                             hat=hat, affine=tuple(affine))


def _resample_cuda(planes, vmasks, origins, x, y, chunk, wr, wc, pick, aligned, hat, affine):
    from .band_resample import resample_launch

    return resample_launch(planes, vmasks, origins, x, y, chunk=chunk, wr=wr, wc=wc, pick=pick, aligned=aligned,
                           hat=hat, affine=tuple(affine))


def _resample_fake(planes, vmasks, origins, x, y, chunk, wr, wc, pick, aligned, hat, affine):
    return x.new_empty(x.shape), x.new_empty(x.shape, dtype=torch.bool)


band_resample = _op(
    "band_resample(Tensor planes, Tensor? vmasks, Tensor? origins, Tensor x, Tensor y, int chunk, int wr, "
    "int wc, bool pick, bool aligned, bool hat, float[] affine) -> (Tensor, Tensor)",
    cpu=_resample_cpu, cuda=_resample_cuda, fake=_resample_fake)


# ---------------------------------------------------------------------------
# B9: binned float64 pair sums, (2, n_out) (sums, counts), of the base block
# elev[:n_rows, col0:col0 + n_cols] against its partners at the grouped
# offset table's (dy, dx) (variogram.grouped_table)
# ---------------------------------------------------------------------------

def _pair_sums_cpu(elev, valid, table, n_rows, n_cols, col0, max_lag, n_out):
    from .variogram import pair_sums_ref, split_table

    s, c = pair_sums_ref(elev, valid, n_rows, n_cols, col0, *split_table(table, n_out), n_out, max_lag)
    return torch.stack([s, c])


def _pair_sums_cuda(elev, valid, table, n_rows, n_cols, col0, max_lag, n_out):
    from .variogram import pair_sums_launch

    return pair_sums_launch(elev, valid, table, n_rows, n_cols, col0, max_lag, n_out)


def _pair_sums_fake(elev, valid, table, n_rows, n_cols, col0, max_lag, n_out):
    return elev.new_empty((2, n_out), dtype=torch.float64)


pair_sums = _op(
    "pair_sums(Tensor elev, Tensor valid, Tensor table, int n_rows, int n_cols, int col0, int max_lag, "
    "int n_out) -> Tensor",
    cpu=_pair_sums_cpu, cuda=_pair_sums_cuda, fake=_pair_sums_fake)


# ---------------------------------------------------------------------------
# B10: the float64 Gauss-Newton variogram fit: ((3,) (nugget, p1, p2) in
# gamma's dtype, (iters, 2) int8 per-step (kept, frozen)); init None (the
# data-driven start) or (3,) float64
# ---------------------------------------------------------------------------

def _fit_cpu(lags, gamma, counts, init, model, iters, stop):
    from .variogram import fit_model_ref

    record = []
    p = fit_model_ref(lags, gamma, counts, model=model, iters=iters, init=None if init is None else init.unbind(),
                      stop=stop, record=record)
    flags = (torch.stack([torch.stack(kf) for kf in record]).to(torch.int8) if record
             else torch.empty((0, 2), dtype=torch.int8))
    return torch.stack(p), flags


def _fit_cuda(lags, gamma, counts, init, model, iters, stop):
    from .variogram import fit_launch

    return fit_launch(lags, gamma, counts, init, model, iters, stop)


def _fit_fake(lags, gamma, counts, init, model, iters, stop):
    return gamma.new_empty(3), gamma.new_empty((iters, 2), dtype=torch.int8)


fit_model = _op(
    "fit_model(Tensor lags, Tensor gamma, Tensor counts, Tensor? init, str model, int iters, float stop) "
    "-> (Tensor, Tensor)",
    cpu=_fit_cpu, cuda=_fit_cuda, fake=_fit_fake)


# ---------------------------------------------------------------------------
# B10 on B9's float64 (sums, counts) (n,) each: the semivariance formed in
# lags' dtype, then the fit; (3,) (nugget, p1, p2) in lags' dtype
# ---------------------------------------------------------------------------

def _fit_binned_cpu(lags, sums, counts, init, model, iters, stop):
    from .variogram import fit_binned_ref

    return fit_binned_ref(lags, sums, counts, init, model, iters, stop)


def _fit_binned_cuda(lags, sums, counts, init, model, iters, stop):
    from .variogram import fit_binned_launch

    return fit_binned_launch(lags, sums, counts, init, model, iters, stop)


def _fit_binned_fake(lags, sums, counts, init, model, iters, stop):
    return lags.new_empty(3)


fit_binned = _op(
    "fit_model.binned(Tensor lags, Tensor sums, Tensor counts, Tensor? init, str model, int iters, float stop) "
    "-> Tensor",
    cpu=_fit_binned_cpu, cuda=_fit_binned_cuda, fake=_fit_binned_fake)
