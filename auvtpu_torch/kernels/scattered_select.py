"""The scattered-query selection kernels (B5, B6, B7, B11, B12, B15) and
the B7 wrappers (counterpart of :mod:`auvtpu.pallas.scattered_select`).

Six CUDA kernels in ``csrc/scattered_select.cu`` replace three TPU
kernels and three XLA epilogues: per query they read the taps of its centre
cell's pack row, take the squared distance to each valid tap and extract
the k nearest by min-extract passes (ties to the lowest table index =
collection order).  The modes of :func:`select`:

- ``"rows_t"`` (B5, ``valid_select.py::_sel_kernel``): (1+2k[+k][+1], N)
  rows [cnt, k vals, (k d2), k codes, (resolved)], dy-major codes; wrappers
  in :mod:`auvtpu_torch.kernels.valid_select`;
- ``"rows_n"`` (B7, ``scattered_select.py::_make_select_kernel``): (N, 1+3k)
  rows [cnt, vals, d2s, codes], dx-major codes, in a kernel that scans only
  the window's real taps and takes them, with each tap's code, by value (a
  pack that is not 16-byte aligned takes its scalar loads); wrappers
  :func:`window_select_fused` below, which returns the select dict of
  :func:`auvtpu_torch.ops.packs.packed_window_select`.

Four kernels take the queries and the grid's scalars and compute the
query prologue themselves (``csrc/query_prologue.cuh``), so that a call is
one launch:

- :func:`idw_select` (B6, ``valid_select.py::_idw_kernel`` with the
  ``_prologue`` before it and ``_idw_launch``'s epilogue after it): the
  power-2 IDW value and the resolved row, (1[+1], N), for ``packed_idw_t``;
  its plain version is :func:`idw_select_ref`, the torch prologue, B6's
  plain sums (:func:`select_ref`, mode ``"idw"``) and the epilogue;
- :func:`select_krige` (B11): B5's top-4 with the ordinary-kriging solve
  and its fallbacks fused in (``valid_select.py::_sel_kernel`` and the XLA
  row epilogue ``_kriging_rows_epilogue`` after it): (1[+1], N) rows
  [prediction, (resolved)], for ``kriging_valid_t`` and
  ``packed_kriging_t``; its plain version is :func:`select_krige_ref`;
- :func:`window_krige` (B12): B7's top-4 with the same solve
  (``pallas_packed_kriging``: ``pallas_window_select`` and the XLA
  ``kriging_from_select`` after it), (N,) predictions, for
  :func:`packed_kriging_fused`; its plain version is
  :func:`window_krige_ref`;
- :func:`window_idw` (B15): B7's top-k with the IDW weights and quotient
  of any power (``pallas_packed_idw``: ``pallas_window_select`` and the XLA
  ``idw_from_select`` after it), (N,) values, for :func:`packed_idw_fused`;
  its plain version is :func:`window_idw_ref`.

For B5 and B7 the normalisation (x, y, oob, centre cell, fractional
offsets) is torch, in one place (:func:`prologue`), and the kernels do the
fetch and the selection.  :func:`select_ref` is the selection's plain
version, a transcription of the TPU kernels (same d2 op order, sentinels
and tie rule).  Each kernel is a custom op of :mod:`.library`: for a CPU
pack it runs the plain version; for a CUDA pack it launches the kernel or
raises.  Each launch adds one to ``LAUNCHES[<kernel>]``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..config import IDWConfig, KrigingConfig
from ..grid import RegularGrid, as_dtype, device_cache
from ..ops.packs import SENTINEL, pack_width, window_offsets
from ..ops.scattered import _nan_like, _normalize, cell_centres, centre_cells, krige_solve_cols, queries
from ..utils.profiling import counters, reset, span, spanned
from . import library
from .window_fill import _MODELS

# one count per TPU kernel replaced
LAUNCHES = counters("launches.scattered_select", ("select_rows", "idw_rows", "window_select_fused", "select_krige",
                                                "window_krige", "window_idw"))
_MODES = {"rows_t": "select_rows", "idw": "idw_rows", "rows_n": "window_select_fused"}
KERNEL_P = (16, 32, 64)  # pack widths the kernel is built for (radius <= 3)
INF = 3e30  # d2 of an invalid tap (valid_select.py:62)


def reset_launches() -> None:
    reset("launches.scattered_select")


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import load

    lib = load("scattered_select")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.auvtpu_scattered_select.argtypes = [P, I, P, P, P, I, I, I, F, I, F, P, P]
    lib.auvtpu_scattered_select.restype = I
    FP = ctypes.POINTER(F)
    lib.auvtpu_idw_select.argtypes = [P, I, I, P, P, P, I, I, I, P, I, I, F, F, P, P]  # taps, geo: host float32
    lib.auvtpu_idw_select.restype = I
    lib.auvtpu_window_select.argtypes = [P, I, I, P, P, ctypes.POINTER(F), I, I, P, P]
    lib.auvtpu_window_select.restype = I
    lib.auvtpu_select_krige.argtypes = [P, I, I, P, P, P, I, I, I, P, FP, P, P, P, I, I, F, P, P]  # taps, geo: host
    lib.auvtpu_select_krige.restype = I
    lib.auvtpu_window_krige.argtypes = [P, I, I, P, P, P, I, I, I, P, FP, P, P, P, I, P, P]  # taps, geo: host
    lib.auvtpu_window_krige.restype = I
    lib.auvtpu_window_idw.argtypes = [P, I, I, P, P, P, I, I, I, P, I, I, F, F, P, P]  # taps, geo: host
    lib.auvtpu_window_idw.restype = I
    lib.auvtpu_window_idw_attributes.argtypes = [I, I, ctypes.POINTER(I)]
    lib.auvtpu_window_idw_attributes.restype = I
    lib.auvtpu_select_krige_attributes.argtypes = [I, I, ctypes.POINTER(I)]
    lib.auvtpu_select_krige_attributes.restype = I
    lib.auvtpu_window_krige_attributes.argtypes = [I, I, ctypes.POINTER(I)]
    lib.auvtpu_window_krige_attributes.restype = I
    lib.auvtpu_scattered_error_string.argtypes = [I]
    lib.auvtpu_scattered_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the kernel now rather than at the first launch."""
    _lib()


# ---------------------------------------------------------------------------
# offset tables: (3, P) f32 rows dx, dy, code
# ---------------------------------------------------------------------------

IDW_M = (9, 16, 25, 49)  # real taps a row B6 and B11 are built for: windows of radius 1-3, valid16
WINDOW_M = (9, 25, 49)  # real taps a row B7 is built for: windows of radius 1-3


def table(offs, P: int, R: int, layout: str, device) -> torch.Tensor:
    """(3, P) f32 per-tap (dx, dy, code) on ``device`` for a pack of width P
    holding ``offs`` (dy, dx).

    layout 'dy' (B5, B6; valid_select.py:65-76): dead taps carry offset 0;
    code (dy+R)*B + (dx+R).  layout 'dx' (B7; scattered_select.py:50-67):
    dead taps carry offset 1e4 and code -1; code (dx+R)*B + (dy+R).  The
    pack holds the sentinel at dead taps, so their entries are never
    selected.  The tensor carries its host copy as ``.host``, from which B6
    and B7 take their taps by value."""
    return _table(tuple(offs), P, R, layout, torch.device(device))


@device_cache(maxsize=32)
def _table(offs: tuple, P: int, R: int, layout: str, device: torch.device) -> torch.Tensor:
    B = 2 * R + 2
    tab = np.full((3, P), 0.0 if layout == "dy" else 1e4, np.float32)
    tab[2] = R * B + R if layout == "dy" else -1.0
    for t, (dy, dx) in enumerate(offs):
        tab[0, t], tab[1, t] = dx, dy
        tab[2, t] = (dy + R) * B + (dx + R) if layout == "dy" else (dx + R) * B + (dy + R)
    out = torch.from_numpy(tab).to(device)
    out.host = tab
    return out


def _host(tab: torch.Tensor) -> np.ndarray:
    """The host copy a table of :func:`table` carries, or, for another
    table, one copy back to the host."""
    host = getattr(tab, "host", None)
    return tab.detach().cpu().numpy() if host is None else host


def _real_taps(tab: torch.Tensor, P: int, name: str):
    """(M, dx, dy) for B6 and B11: the instantiation M that holds the real
    taps of ``tab`` (layout 'dy') and the offsets of its first M taps as
    host float32.  The real taps run to the last with an offset other than
    (0, 0): dead taps carry (0, 0) and the windows list the centre tap
    first, so every window of a build size finds its build.  Taps past the
    real ones are padding, which the pack marks invalid."""
    host = _host(tab)
    dx, dy = host[0].astype(np.float32), host[1].astype(np.float32)
    off = np.flatnonzero((dx != 0) | (dy != 0))
    n = int(off[-1]) + 1 if off.size else 1
    M = next((m for m in IDW_M if m >= n and pack_width(m) == P), None)
    if M is None:
        raise ValueError(f"{name}: no build for {n} taps in rows of {P}; built for {IDW_M}")
    return M, dx[:M], dy[:M]


def _idw_taps(tab: torch.Tensor, P: int, half: float):
    """(M, taps) for B6: :func:`_real_taps` as (dx + half, dy + half) of
    each, 2*M host float32, exact sums (dx integer, half 0 or 0.5)."""
    M, dx, dy = _real_taps(tab, P, "idw_rows")
    h32 = np.float32(half)
    return M, np.ascontiguousarray(np.concatenate([dx + h32, dy + h32]), dtype=np.float32)


def _window_taps(tab: torch.Tensor, P: int, half: float):
    """(M, taps) for B7: the M real taps of ``tab`` (layout 'dx': they run
    to the last tap with a code other than -1, the dead taps' code) and, as
    3*M host float32, dx + half of each, dy + half of each and the code of
    each, all exact (integers, half 0 or 0.5)."""
    host = _host(tab)
    code = host[2].astype(np.float32)
    live = np.flatnonzero(code >= 0)
    M = int(live[-1]) + 1 if live.size else 0
    if M not in WINDOW_M or pack_width(M) != P or live.size != M:
        raise ValueError(f"window_select_fused: no build for {M} taps in rows of {P} (a 'dx' table of a window "
                         f"of radius 1-3, {WINDOW_M} taps)")
    h32 = np.float32(half)
    taps = [host[0, :M].astype(np.float32) + h32, host[1, :M].astype(np.float32) + h32, code[:M]]
    return M, np.ascontiguousarray(np.concatenate(taps), dtype=np.float32)


# ---------------------------------------------------------------------------
# prologue (torch) and the kernel with its plain version
# ---------------------------------------------------------------------------

def prologue(grid: RegularGrid, lons, lats):
    """The query geometry the kernels B5 and B7, the plain versions and the
    epilogues use: x, y, oob (:func:`auvtpu_torch.ops.scattered._normalize`),
    the clamped centre (ci, cj), its cell index cj*W + ci (int32) and the
    fractional offsets fx = x - ci, fy = y - cj (valid_select.py:146-173).
    B6, B11 and B12 compute it in the kernel, op for op."""
    if grid.dtype != torch.float32:
        raise TypeError(
            f"the scattered select kernels are float32 (grid is {grid.dtype}); "
            "float64 callers use the torch packed path (ops.packs)"
        )
    x, y, oob = _normalize(grid, lons, lats)
    ci, cj = centre_cells(grid, x, y)
    cell = cj * grid.num_lon + ci
    return x, y, oob, ci, cj, cell, x - ci.to(x.dtype), y - cj.to(y.dtype)


def _out_shape(mode: str, n: int, k: int, emit_d2: bool, resolve: bool):
    if mode == "rows_t":
        return (1 + (3 if emit_d2 else 2) * k + int(resolve), n)
    if mode == "idw":
        return (2 + int(resolve), n)
    return (n, 1 + 3 * k)


def select_ref(pack, P: int, cell, fx, fy, tab, *, mode: str, k: int, emit_d2: bool = False, half: float = 0.5, resolve_thresh=None, eps: float = IDWConfig().eps):
    """Plain version of :func:`select`: the TPU kernels' arithmetic on (N, P)
    stencils, one min-extract pass per slot."""
    if mode not in _MODES:
        raise ValueError(mode)
    st = pack.view(-1, P)[cell.long()]
    n = st.shape[0]
    ok = st < 0.5 * SENTINEL
    di = (tab[0] + half)[None, :] - fx[:, None]
    dj = (tab[1] + half)[None, :] - fy[:, None]
    d2 = torch.where(ok, di * di + dj * dj, torch.full_like(st, INF))
    iota = torch.arange(P, device=st.device)
    zero = torch.zeros(n, dtype=st.dtype, device=st.device)
    cnt, num, den, resolved = zero, zero, zero, zero
    vals, d2s, codes = [], [], []
    for s in range(k):
        m = d2.min(dim=1).values
        got = m < 0.5 * INF
        # the lowest index of the min; P where no tap equals it (a NaN query:
        # m is NaN), and then the pass takes no slot, as the TPU kernels'
        # all-zero one-hot takes none
        idx = torch.where(d2 == m[:, None], iota, P).min(dim=1).values
        at = idx.clamp(max=P - 1)
        val = torch.where(got, st.gather(1, at[:, None])[:, 0], zero)
        d2 = torch.where((iota == idx[:, None]) & got[:, None], INF, d2)
        if mode == "idw":
            w = torch.where(got, 1.0 / (m + eps), zero)
            num = num + w * val
            den = den + w
        else:
            vals.append(val)
            # B7 writes the pass's minimum as it is (scattered_select.py:100),
            # B5 INF at an empty slot (valid_select.py:101)
            d2s.append(m if mode == "rows_n" else torch.where(got, m, torch.full_like(m, INF)))
            codes.append(torch.where(got, tab[2][at], zero))
        cnt = cnt + got.to(st.dtype)
        if s == k - 1 and resolve_thresh is not None:
            resolved = (got & (m < resolve_thresh)).to(st.dtype)
    res = [resolved] if resolve_thresh is not None else []
    if mode == "idw":
        return torch.stack([num, den] + res)
    if mode == "rows_t":
        return torch.stack([cnt] + vals + (d2s if emit_d2 else []) + codes + res)
    return torch.stack([cnt] + vals + d2s + codes, dim=1)


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _check(pack, P: int, k: int, name: str, *inputs) -> None:
    """What every select kernel takes: float32 (the pack and every floating
    input), a built pack width, 1 <= k <= P, a contiguous pack of whole
    rows, every input on the pack's device."""
    dev = pack.device
    dtypes = [t.dtype for t in inputs if t.is_floating_point()]
    if pack.dtype != torch.float32 or any(d != torch.float32 for d in dtypes):
        raise TypeError(f"{name}: the kernel is float32 only (pack {pack.dtype}, inputs {dtypes})")
    if P not in KERNEL_P:
        raise ValueError(_width_message(name, P))
    if not 1 <= k <= P:
        raise ValueError(f"{name}: k={k} outside 1..{P}")
    if not pack.is_contiguous() or pack.numel() % P or (name in ("select_rows", "select_krige")
                                                         and pack.data_ptr() % 16):
        raise ValueError(f"{name}: the pack must be contiguous, a whole number of rows and (but for B6 and "
                         "B7, which take scalar loads there) 16-byte aligned")
    for t in inputs:
        if t.device != dev:
            raise ValueError(f"{name}: pack on {dev} but an input on {t.device}")


def _check_device(pack, name: str) -> None:
    """A pack off the CPU must be on a card: one elsewhere (meta) would
    reach the op's fake implementation and launch nothing."""
    if pack.device.type != "cuda":
        raise ValueError(f"{name}: pack lies on {pack.device}; the kernel takes a CUDA pack (a CPU pack runs the "
                         "plain version)")


def _width_message(name: str, P: int) -> str:
    return (f"{name}: pack width P={P} is not built: the kernel keeps P distances in registers and takes P in "
            f"{KERNEL_P}, window radius <= 3 (radius 4 needs P=128)")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = _lib().auvtpu_scattered_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({err})")


def select(pack, P: int, cell, fx, fy, tab, *, mode: str, k: int, emit_d2: bool = False, half: float = 0.5, resolve_thresh=None):
    """k-nearest selection over the pack rows ``cell`` (B5 or B7 by
    ``mode``).

    pack (cells*P,) f32 with the 1e30 sentinel at invalid taps; cell (N,)
    integer; fx, fy (N,) f32; tab (3, P) f32 (dx, dy, code).  Each mode is a
    custom op (``auvtpu_torch::valid_select``, ``::window_select``): for a
    CPU pack it runs :func:`select_ref`, for a CUDA pack it launches the
    kernel or raises.  B7's taps are worked out here from the table's host
    copy, once a table.  B6 (IDW) takes the queries, not their cells:
    :func:`idw_select`."""
    cpu = pack.device.type == "cpu"
    if mode not in ("rows_t", "rows_n"):
        raise ValueError(f"select: mode {mode!r}; 'rows_t' (B5) or 'rows_n' (B7); B6 is idw_select")
    if not cpu:
        _check_device(pack, _MODES[mode])
    if mode == "rows_n":
        return library.window_select(pack, cell, fx, fy, tab, [] if cpu else _taps(tab, P, half, "dx"), P, k,
                                     half)
    return library.valid_select(pack, cell, fx, fy, tab, P, k, emit_d2, half, resolve_thresh)


# a CPU pack's taps: the plain versions read the table
_NO_TAPS = torch.empty(0)


def _taps(tab: torch.Tensor, P: int, half: float, layout: str):
    """The by-value taps of B7 (layout 'dx', :func:`_window_taps`) as a list
    of floats, its op's schema; of B6 ('dy', :func:`_idw_taps`) as a CPU
    float32 tensor whose memory the launch reads (one operand through the
    dispatcher where a list of 2*M floats is 2*M).  Kept on a table of
    :func:`table` (a cached constant), so a table's are worked out once.  A
    pack width the kernels are not built for raises here, before the taps
    are read."""
    if P not in KERNEL_P:
        raise ValueError(_width_message("idw_rows" if layout == "dy" else "window_select_fused", P))
    memo = tab.__dict__.setdefault("_taps", {}) if hasattr(tab, "host") else {}
    taps = memo.get((P, half, layout))
    if taps is None:
        vals = (_idw_taps if layout == "dy" else _window_taps)(tab, P, half)[1]
        taps = torch.from_numpy(vals) if layout == "dy" else vals.tolist()
        memo[(P, half, layout)] = taps
    return taps


def _host_floats(t: torch.Tensor, name: str, what: str) -> int:
    """The address of a contiguous CPU float32 tensor, for a launch that
    reads it on the host."""
    if t.device.type != "cpu" or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: the {what} are a contiguous CPU float32 tensor (got {t.dtype} on {t.device})")
    return t.data_ptr()


def _inputs_of(cell, fx, fy):
    """The (N,) int32 cell indices and the (2, N) f32 (fx, fy) the select
    kernels read."""
    return cell.to(torch.int32).contiguous(), torch.stack([fx, fy]).contiguous()


def rows_launch(pack, P: int, cell, fx, fy, tab, k: int, emit_d2: bool, half: float, resolve_thresh):
    """One B5 launch: the ``cuda`` implementation of
    ``auvtpu_torch::valid_select``."""
    name = "select_rows"
    _check(pack, P, k, name, cell, fx, fy, tab)
    n = int(cell.shape[0])
    out = torch.empty(_out_shape("rows_t", n, k, emit_d2, resolve_thresh is not None), dtype=torch.float32,
                      device=pack.device)
    if n == 0:
        return out
    cell32, fxy = _inputs_of(cell, fx, fy)
    tab = tab.to(torch.float32).contiguous()
    with torch.cuda.device(pack.device):
        err = _lib().auvtpu_scattered_select(
            pack.data_ptr(), P, cell32.data_ptr(), fxy.data_ptr(), tab.data_ptr(), n, k,
            int(emit_d2), float(half), int(resolve_thresh is not None),
            0.0 if resolve_thresh is None else float(resolve_thresh), out.data_ptr(), _stream(pack.device),
        )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def idw_launch(pack, P: int, qlon, qlat, taps, geo, num_lon: int, num_lat: int, k: int, resolve_thresh, eps: float):
    """One B6 launch: the ``cuda`` implementation of
    ``auvtpu_torch::idw_select``.  ``taps`` are the by-value taps of
    :func:`_idw_taps` (2*M floats: dx + half of each real tap, then dy +
    half) and ``geo`` :func:`_krige_geo`'s, CPU tensors read on the host."""
    name = "idw_rows"
    _check(pack, P, k, name, qlon, qlat)
    M = taps.numel() // 2
    if taps.numel() % 2 or M not in IDW_M or pack_width(M) != P or geo.numel() != 10:
        raise ValueError(f"{name}: {taps.numel()} tap values for rows of {P} and {geo.numel()} grid scalars; want "
                         f"2*M, M in {IDW_M}, and 10")
    geo32 = _geo32(geo)  # held until the launch has read it
    host_taps, host_geo = _host_floats(taps, name, "taps"), _host_floats(geo32, name, "grid scalars")
    n = int(qlon.shape[0])
    out = torch.empty((1 + int(resolve_thresh is not None), n), dtype=torch.float32, device=pack.device)
    if n == 0:
        return out
    resolve = resolve_thresh is not None
    thresh, stream = float(resolve_thresh) if resolve else 0.0, _stream(pack.device)
    with torch.cuda.device(pack.device), span("auvtpu_torch.kernels.scattered_select.idw_launch:call"):
        err = _lib().auvtpu_idw_select(
            pack.data_ptr(), P, M, qlon.data_ptr(), qlat.data_ptr(), host_taps, n, num_lon, num_lat, host_geo, k,
            int(resolve), thresh, float(eps), out.data_ptr(), stream,
        )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def window_launch(pack, P: int, cell, fx, fy, tab, taps, k: int):
    """One B7 launch: the ``cuda`` implementation of
    ``auvtpu_torch::window_select``.  ``taps`` are the by-value taps of
    :func:`_window_taps` (3*M floats)."""
    name = "window_select_fused"
    _check(pack, P, k, name, cell, fx, fy, tab)
    if len(taps) % 3 or len(taps) // 3 not in WINDOW_M:
        raise ValueError(f"{name}: {len(taps)} tap values; want 3*M, M in {WINDOW_M}")
    dev = pack.device
    n = int(cell.shape[0])
    out = torch.empty((n, 1 + 3 * k), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    cell32, fxy = _inputs_of(cell, fx, fy)
    with torch.cuda.device(dev):
        err = _lib().auvtpu_window_select(
            pack.data_ptr(), P, len(taps) // 3, cell32.data_ptr(), fxy.data_ptr(), _c_floats(tuple(taps)), n, k,
            out.data_ptr(), _stream(dev),
        )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# B6: the query prologue, the k-nearest IDW sums and the epilogue in one
# kernel, with its plain version
# ---------------------------------------------------------------------------

@spanned
def idw_select(pack, P: int, offs, R: int, grid: RegularGrid, lons, lats, *, k: int = 8, convention: str = "reference", resolve_thresh=None):
    """k-nearest IDW with power 2 over the pack rows of ``offs`` (B6):
    (1[+1], N) f32 rows [value, (resolved)].  The value is sum w*v /
    max(sum w, eps) over the k nearest valid taps, w = 1/(d2 + eps) and eps
    ``IDWConfig(k=k).eps``, NaN where no tap was found and out of the grid;
    the resolved row (two-tier, ``resolve_thresh``) is found & d2 <
    resolve_thresh at slot k.  Through the op ``auvtpu_torch::idw_select``:
    for a CPU pack it runs :func:`idw_select_ref`; for a CUDA pack it
    launches the kernel once, which computes the query prologue from the
    queries and the grid's scalars and the quotient itself, or raises."""
    cpu = pack.device.type == "cpu"
    if not cpu:
        _check_device(pack, "idw_rows")
    if not 1 <= k <= P:
        raise ValueError(f"k must be in 1..{P}")
    qlon, qlat = (q.contiguous() for q in queries(grid, lons, lats))
    tab = table(_offs_key(offs), P, R, "dy", grid.device)
    half = 0.5 if convention == "reference" else 0.0
    return library.idw_select(pack, tab, qlon, qlat, _NO_TAPS if cpu else _taps(tab, P, half, "dy"),
                              _krige_geo(grid, convention), P, grid.num_lon, grid.num_lat, k, resolve_thresh,
                              IDWConfig(k=k).eps)


def idw_select_ref(pack, P: int, offs, R: int, grid: RegularGrid, lons, lats, *, k: int = 8, convention: str = "reference", resolve_thresh=None):
    """Plain version of :func:`idw_select`: the torch prologue, B6's plain
    sums (:func:`select_ref`, mode ``"idw"``) and the epilogue of
    ``_idw_launch`` in torch."""
    return idw_select_plain(pack, P, table(offs, P, R, "dy", grid.device), grid, lons, lats, k=k,
                            half=0.5 if convention == "reference" else 0.0, resolve_thresh=resolve_thresh,
                            eps=IDWConfig(k=k).eps)


def idw_select_plain(pack, P: int, tab, grid: RegularGrid, lons, lats, *, k: int, half: float, resolve_thresh, eps: float):
    """:func:`idw_select_ref` over the pack's (3, P) 'dy' table: the ``cpu``
    implementation of ``auvtpu_torch::idw_select``, in the kernel's op
    order."""
    _, _, oob, _, _, cell, fx, fy = prologue(grid, lons, lats)
    rows = select_ref(pack, P, cell, fx, fy, tab, mode="idw", k=k, half=half, resolve_thresh=resolve_thresh, eps=eps)
    num, den = rows[0], rows[1]
    res = torch.where(den > 0, num / torch.clamp(den, min=eps), _nan_like(num))
    res = torch.where(oob, _nan_like(res), res)
    return torch.stack([res] + ([rows[2]] if resolve_thresh is not None else []))


# ---------------------------------------------------------------------------
# B11: the top-4 and the kriging solve in one kernel, with its plain version
# ---------------------------------------------------------------------------

def _kriging_rows_epilogue(grid, lons, lats, out, oob, ci, cj, R, *, vparams, model, half=0.5):
    """Kriging from B5's rows [cnt, 4 vals, 4 codes]: decode the dy-major
    codes, solve in column form, fall back to the mean of the found
    neighbours (empty slots hold 0, so sum/count is the masked mean); the
    XLA epilogue ``valid_select.py::_kriging_rows_epilogue``."""
    B = 2 * R + 2
    dt = grid.dtype
    found = out[0]
    vals_c = [out[1 + a] for a in range(4)]
    lon_step = as_dtype(grid.lon_step, dt)
    lat_step = as_dtype(grid.lat_step, dt)
    min_lon, min_lat = as_dtype(grid.min_lon, dt), as_dtype(grid.min_lat, dt)
    ci_f = ci.to(dt)
    cj_f = cj.to(dt)
    cx_c, cy_c = [], []
    for a in range(4):
        code = torch.clamp(out[5 + a], min=0.0)
        sdy = torch.floor(code / B) - R
        sdx = code - (sdy + R) * B - R
        cx_c.append(min_lon + (ci_f + sdx + half) * lon_step)
        cy_c.append(min_lat + (cj_f + sdy + half) * lat_step)
    qlon, qlat = queries(grid, lons, lats)
    pred, singular = krige_solve_cols(qlon, qlat, vals_c, cx_c, cy_c, KrigingConfig(), vparams=vparams, model=model)
    fb = (vals_c[0] + vals_c[1] + vals_c[2] + vals_c[3]) / torch.clamp(found, min=1.0)
    res = torch.where(singular | (found < 3.5), fb, pred)
    return torch.where(oob, _nan_like(res), res)


def select_krige_ref(pack, P: int, offs, R: int, grid: RegularGrid, lons, lats, *, convention: str = "reference", vparams=None, model: str = "exponential", resolve_thresh=None):
    """Plain version of :func:`select_krige`: B5's plain rows
    (:func:`select_ref`, k=4, with the resolved row where asked) and the
    torch row epilogue.  (1[+1], N) rows [prediction, (resolved)]."""
    return select_krige_plain(pack, P, table(offs, P, R, "dy", grid.device), R, grid, lons, lats,
                              half=0.5 if convention == "reference" else 0.0, vparams=vparams, model=model,
                              resolve_thresh=resolve_thresh)


def select_krige_plain(pack, P: int, tab, R: int, grid: RegularGrid, lons, lats, *, half: float, vparams, model: str, resolve_thresh):
    """:func:`select_krige_ref` over the pack's (3, P) 'dy' table: the
    ``cpu`` implementation of ``auvtpu_torch::select_krige``."""
    _, _, oob, ci, cj, cell, fx, fy = prologue(grid, lons, lats)
    rows = select_ref(pack, P, cell, fx, fy, tab, mode="rows_t", k=4, half=half, resolve_thresh=resolve_thresh)
    res = _kriging_rows_epilogue(grid, lons, lats, rows, oob, ci, cj, R, vparams=vparams, model=model, half=half)
    return torch.stack([res] + ([rows[9]] if resolve_thresh is not None else []))


@spanned
def select_krige(pack, P: int, offs, R: int, grid: RegularGrid, lons, lats, *, convention: str = "reference", vparams=None, model: str = "exponential", resolve_thresh=None):
    """Ordinary kriging from the k=4 selection over the pack rows of
    ``offs`` (B11): (1[+1], N) f32 rows [prediction, (resolved)].  The
    prediction is the 5x6 solve of the four nearest valid taps, the mean of
    the found ones (0 where none was found) where fewer than four were
    found or a pivot fell below ``KrigingConfig().pivot_tol``, NaN out of
    the grid; the resolved row (two-tier, ``resolve_thresh``) is B5's.
    Through the op ``auvtpu_torch::select_krige``: for a CPU pack it runs
    :func:`select_krige_ref`; for a CUDA pack it launches the kernel once,
    which computes the query prologue from the queries and the grid's
    scalars itself, or raises.  Fitted ``vparams`` (0-d tensors on the
    card) are read there by the kernel."""
    if pack.device.type != "cpu":
        _check_device(pack, "select_krige")
    qlon, qlat = (q.contiguous() for q in queries(grid, lons, lats))
    key = _offs_key(offs)
    tab = table(key, P, R, "dy", grid.device)
    taps = _NO_TAPS if pack.device.type == "cpu" else _krige_taps(key, P, R)[1]
    return library.select_krige(pack, tab, qlon, qlat, library.variogram_tensors(vparams, qlon), taps,
                                _krige_geo(grid, convention), P, R, grid.num_lon, grid.num_lat, model, resolve_thresh)


def krige_launch(pack, P: int, qlon, qlat, vario, taps, geo, num_lon: int, num_lat: int, model: str, resolve_thresh):
    """One B11 launch: the ``cuda`` implementation of
    ``auvtpu_torch::select_krige``.  ``taps`` are :func:`_krige_taps`'s and
    ``geo`` :func:`_krige_geo`'s (CPU tensors read on the host), ``vario``
    one (3,) tensor or three 0-d tensors whose device addresses the kernel
    reads (a copy first where one is not float32 on the pack's card)."""
    name = "select_krige"
    if model not in _MODELS:
        raise ValueError(model)
    dev = pack.device
    _check(pack, P, 4, name, qlon, qlat)
    M = taps.numel() // 2
    if taps.numel() % 2 or M not in IDW_M or pack_width(M) != P or geo.numel() != 10:
        raise ValueError(f"{name}: {taps.numel()} tap values for rows of {P} and {geo.numel()} grid scalars; want "
                         f"2*M, M in {IDW_M}, and 10")
    geo32 = _geo32(geo)  # held until the launch has read it
    host_taps, host_geo = _host_floats(taps, name, "taps"), _host_floats(geo32, name, "grid scalars")
    n = int(qlon.shape[0])
    resolve = resolve_thresh is not None
    out = torch.empty((1 + int(resolve), n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    ptrs, keep = _vario_pointers(vario, dev, name)
    stream = _stream(dev)
    with torch.cuda.device(dev), span("auvtpu_torch.kernels.scattered_select.krige_launch:call"):
        err = _lib().auvtpu_select_krige(
            pack.data_ptr(), P, M, qlon.data_ptr(), qlat.data_ptr(), host_taps, n, num_lon, num_lat,
            host_geo, _NO_VARIO, *ptrs, _MODELS[model], int(resolve),
            float(resolve_thresh) if resolve else 0.0, out.data_ptr(), stream,
        )
    del keep
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def _geo32(geo: torch.Tensor) -> torch.Tensor:
    """The float32 grid scalars a launch takes by value: made beside a
    geometry of :func:`_krige_geo`; a loaded program's are converted."""
    geo32 = getattr(geo, "f32", None)
    return geo.to(torch.float32) if geo32 is None else geo32


_NO_VARIO = (ctypes.c_float * 3)()  # the by-value parameters: unused, every one is read through its address


def _vario_pointers(vario, dev, name: str):
    """The device addresses of the variogram's three parameters, from one
    (3,) tensor or three 0-d tensors; (pointers, keep): ``keep`` holds the
    tensors they point into until the launch."""
    keep = [v if v.device == dev and v.dtype == torch.float32 else v.to(dev, torch.float32) for v in vario]
    if len(keep) == 1 and keep[0].shape == (3,):
        base, step = keep[0].data_ptr(), 4 * keep[0].stride(0)
        return (base, base + step, base + 2 * step), keep
    if len(keep) != 3 or any(v.numel() != 1 for v in keep):
        raise ValueError(f"{name}: the variogram is one (3,) tensor or three one-element tensors")
    return tuple(v.data_ptr() for v in keep), keep


def _offs_key(offs) -> tuple:
    """``offs`` as the hashable tuple of (dy, dx) pairs the caches take."""
    return offs if isinstance(offs, tuple) else tuple(map(tuple, offs))


@device_cache(maxsize=32)
def _krige_taps(offs: tuple, P: int, R: int, name: str = "select_krige"):
    """(M, taps) for B11 and B12: :func:`_real_taps` of the pack's table,
    the M taps' dx then dy in a CPU float32 tensor that the launch reads.
    A pack width the kernel is not built for raises here, before the taps
    are read."""
    if P not in KERNEL_P:
        raise ValueError(_width_message(name, P))
    M, dx, dy = _real_taps(table(offs, P, R, "dy", "cpu"), P, name)
    return M, torch.from_numpy(np.concatenate([dx, dy]))


def _krige_geo(grid: RegularGrid, convention: str) -> torch.Tensor:
    """The grid scalars of B6, B11 and B12 as a (10,) float64 CPU tensor:
    the bounds and the reciprocal steps of :meth:`RegularGrid.inv_steps`
    (the query prologue, all B6 reads), the steps (the neighbours'
    centres), half and the pivot tolerance.  The bounds are the grid's
    python floats, the plain version's extent; ``.f32`` holds the float32
    values the kernel takes by value."""
    return _geo(grid.min_lon, grid.max_lon, grid.min_lat, grid.max_lat, grid.num_lon, grid.num_lat, convention)


@device_cache(maxsize=32)
def _geo(min_lon: float, max_lon: float, min_lat: float, max_lat: float, num_lon: int, num_lat: int, convention: str):
    plane = torch.empty(()).expand(num_lat, num_lon)
    grid = RegularGrid(plane, plane, min_lon, max_lon, min_lat, max_lat)
    inv_lon, inv_lat = grid.inv_steps(torch.float32)
    half = 0.5 if convention == "reference" else 0.0
    geo = torch.tensor([min_lon, max_lon, min_lat, max_lat, inv_lon, inv_lat, grid.lon_step, grid.lat_step, half,
                        KrigingConfig().pivot_tol], dtype=torch.float64)
    geo.f32 = geo.to(torch.float32)
    return geo


@lru_cache(maxsize=32)
def _c_floats(vals: tuple):
    return (ctypes.c_float * len(vals))(*vals)


def krige_attributes(M: int, model: str = "exponential") -> dict:
    """The resources of B11's build for M taps and ``model`` on the current
    card: registers a thread, spill (local) bytes a thread, resident blocks
    an SM by the occupancy calculator."""
    out = (ctypes.c_int * 3)()
    _raise_on(_lib().auvtpu_select_krige_attributes(M, _MODELS[model], out), "select_krige")
    return dict(zip(("registers", "spill_bytes", "blocks_per_sm"), out))


# ---------------------------------------------------------------------------
# B12: B7's top-4 and the kriging solve in one kernel, with its plain version
# ---------------------------------------------------------------------------

def window_krige(pack, P: int, offs, R: int, grid: RegularGrid, lons, lats, *, convention: str = "reference", vparams=None, model: str = "exponential"):
    """Ordinary kriging from B7's k=4 window selection over the pack rows of
    ``offs`` (B12): (N,) f32 predictions.  The prediction is the 5x6 solve
    of the four nearest valid taps, the mean of the found ones where fewer
    than four were found or a pivot fell below ``KrigingConfig().pivot_tol``
    (NaN where none was found), NaN out of the grid: ``kriging_from_select``
    after ``pallas_window_select``.  Through the op
    ``auvtpu_torch::window_krige``: for a CPU pack it runs
    :func:`window_krige_ref`; for a CUDA pack it launches the kernel once,
    which computes the query prologue itself, or raises.  Fitted
    ``vparams`` (0-d tensors on the card) are read there by the kernel."""
    cpu = pack.device.type == "cpu"
    if not cpu:
        _check_device(pack, "window_krige")
    qlon, qlat = (q.contiguous() for q in queries(grid, lons, lats))
    key = _offs_key(offs)
    tab = table(key, P, R, "dx", grid.device)
    taps = _NO_TAPS if cpu else _window_krige_taps(key, P, R)
    return library.window_krige(pack, tab, qlon, qlat, library.variogram_tensors(vparams, qlon), taps,
                                _krige_geo(grid, convention), P, R, grid.num_lon, grid.num_lat, model)


def window_krige_attributes(M: int, model: str = "exponential") -> dict:
    """The resources of B12's build for M taps and ``model`` on the current
    card: registers a thread, spill (local) bytes a thread, resident blocks
    an SM by the occupancy calculator at the build's shared memory, and that
    shared memory (bytes a block: the rows' stages)."""
    out = (ctypes.c_int * 4)()
    _raise_on(_lib().auvtpu_window_krige_attributes(M, _MODELS[model], out), "window_krige")
    return dict(zip(("registers", "spill_bytes", "blocks_per_sm", "shared_bytes"), out))


def _window_krige_taps(offs: tuple, P: int, R: int, name: str = "window_krige") -> torch.Tensor:
    """B12's and B15's taps, :func:`_krige_taps`'s, for a window of B7's
    builds."""
    M, taps = _krige_taps(offs, P, R, name)
    if M not in WINDOW_M:
        raise ValueError(f"{name}: no build for {M} taps; built for the windows of radius 1-3, {WINDOW_M}")
    return taps


def window_krige_ref(pack, P: int, offs, R: int, grid: RegularGrid, lons, lats, *, convention: str = "reference", vparams=None, model: str = "exponential"):
    """Plain version of :func:`window_krige`: :func:`window_select_fused`'s
    plain path (the torch prologue, :func:`select_ref` in mode ``"rows_n"``
    over the 'dx' table, the select dict) and ``kriging_from_select``."""
    return window_krige_plain(pack, P, table(offs, P, R, "dx", grid.device), R, grid, lons, lats,
                              half=0.5 if convention == "reference" else 0.0, vparams=vparams, model=model)


def window_krige_plain(pack, P: int, tab, R: int, grid: RegularGrid, lons, lats, *, half: float, vparams, model: str):
    """:func:`window_krige_ref` over the pack's (3, P) 'dx' table: the
    ``cpu`` implementation of ``auvtpu_torch::window_krige``.  The solve is
    ``ops.packs.kriging_from_select``'s; its fallback, ``masked_mean``,
    with the sum of the four slots spelled out in the kernel's order."""
    x, y, oob, ci, cj, cell, fx, fy = prologue(grid, lons, lats)
    sel = _window_dict(select_ref(pack, P, cell, fx, fy, tab, mode="rows_n", k=4, half=half), x, y, oob, ci, cj, 4, R)
    cx, cy = cell_centres(grid, ci, cj, sel["dx"], sel["dy"], half)
    qlon, qlat = queries(grid, lons, lats)
    val = sel["val"]
    pred, singular = krige_solve_cols(qlon, qlat, [val[:, a] for a in range(4)], [cx[:, a] for a in range(4)],
                                      [cy[:, a] for a in range(4)], KrigingConfig(), vparams=vparams, model=model)
    ok = sel["slot_ok"]
    v = torch.where(ok, val, torch.zeros_like(val))
    total = ((v[:, 0] + v[:, 1]) + v[:, 2]) + v[:, 3]
    cnt = ok.sum(dim=1)
    fb = torch.where(cnt > 0, total / cnt.clamp(min=1), _nan_like(total))
    res = torch.where(singular | (sel["found"] < 4), fb, pred)
    return torch.where(oob, _nan_like(res), res)


def window_krige_launch(pack, P: int, qlon, qlat, vario, taps, geo, num_lon: int, num_lat: int, model: str):
    """One B12 launch: the ``cuda`` implementation of
    ``auvtpu_torch::window_krige``.  ``taps`` (:func:`_window_krige_taps`)
    and ``geo`` (:func:`_krige_geo`) are CPU tensors read on the host,
    ``vario`` as for :func:`krige_launch`."""
    name = "window_krige"
    if model not in _MODELS:
        raise ValueError(model)
    dev = pack.device
    _check(pack, P, 4, name, qlon, qlat)
    M = taps.numel() // 2
    if taps.numel() % 2 or M not in WINDOW_M or pack_width(M) != P or geo.numel() != 10:
        raise ValueError(f"{name}: {taps.numel()} tap values for rows of {P} and {geo.numel()} grid scalars; want "
                         f"2*M, M in {WINDOW_M}, and 10")
    geo32 = _geo32(geo)  # held until the launch has read it
    host_taps, host_geo = _host_floats(taps, name, "taps"), _host_floats(geo32, name, "grid scalars")
    n = int(qlon.shape[0])
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    ptrs, keep = _vario_pointers(vario, dev, name)
    with torch.cuda.device(dev):
        err = _lib().auvtpu_window_krige(
            pack.data_ptr(), P, M, qlon.data_ptr(), qlat.data_ptr(), host_taps, n, num_lon, num_lat, host_geo,
            _NO_VARIO, *ptrs, _MODELS[model], out.data_ptr(), _stream(dev),
        )
    del keep
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# B15: B7's top-k and the IDW weights and quotient in one kernel, with its
# plain version
# ---------------------------------------------------------------------------

def window_idw(pack, P: int, offs, R: int, grid: RegularGrid, lons, lats, *, k: int = 8, power: float = 2.0, convention: str = "reference"):
    """k-nearest IDW from B7's window selection over the pack rows of
    ``offs`` (B15): (N,) f32 values.  The value is sum w*v / max(sum w,
    eps) over the k nearest valid taps, w = 1/(d2 ** (power/2) + eps) and
    eps ``IDWConfig(k, power).eps``, NaN where no tap was found and out of
    the grid: ``idw_from_select`` after ``pallas_window_select``.  Through
    the op ``auvtpu_torch::window_idw``: for a CPU pack it runs
    :func:`window_idw_ref`; for a CUDA pack it launches the kernel once,
    which computes the query prologue itself, or raises."""
    cpu = pack.device.type == "cpu"
    if not cpu:
        _check_device(pack, "window_idw")
    if not 1 <= k <= P:
        raise ValueError(f"window_idw: k={k} outside 1..{P}")
    qlon, qlat = (q.contiguous() for q in queries(grid, lons, lats))
    key = _offs_key(offs)
    tab = table(key, P, R, "dx", grid.device)
    taps = _NO_TAPS if cpu else _window_krige_taps(key, P, R, "window_idw")
    return library.window_idw(pack, tab, qlon, qlat, taps, _krige_geo(grid, convention), P, R, grid.num_lon,
                              grid.num_lat, k, float(power), IDWConfig(k=k, power=power).eps)


def window_idw_ref(pack, P: int, offs, R: int, grid: RegularGrid, lons, lats, *, k: int = 8, power: float = 2.0, convention: str = "reference"):
    """Plain version of :func:`window_idw`: :func:`window_select_fused`'s
    plain path (the torch prologue, :func:`select_ref` in mode ``"rows_n"``
    over the 'dx' table, the select dict) and ``idw_from_select``'s weights,
    with its two sums in the kernel's slot order."""
    return window_idw_plain(pack, P, table(offs, P, R, "dx", grid.device), R, grid, lons, lats, k=k,
                            half=0.5 if convention == "reference" else 0.0, power=power,
                            eps=IDWConfig(k=k, power=power).eps)


def window_idw_plain(pack, P: int, tab, R: int, grid: RegularGrid, lons, lats, *, k: int, half: float, power: float, eps: float):
    """:func:`window_idw_ref` over the pack's (3, P) 'dx' table: the ``cpu``
    implementation of ``auvtpu_torch::window_idw``.  The weights are
    ``ops.packs.idw_from_select``'s, over the same (N, k) select rows; its
    sums over k are spelled out slot by slot, as the kernel adds."""
    x, y, oob, ci, cj, cell, fx, fy = prologue(grid, lons, lats)
    sel = _window_dict(select_ref(pack, P, cell, fx, fy, tab, mode="rows_n", k=k, half=half), x, y, oob, ci, cj, k, R)
    d2, val = sel["d2"], sel["val"]
    w = torch.where(sel["slot_ok"], 1.0 / (d2 ** (power / 2.0) + eps), torch.zeros_like(d2))
    num = den = torch.zeros_like(w[:, 0])
    for s in range(k):
        num = num + w[:, s] * val[:, s]
        den = den + w[:, s]
    res = torch.where(den > 0, num / torch.clamp(den, min=eps), _nan_like(den))
    return torch.where(oob, _nan_like(res), res)


# torch's CUDA pow(Tensor, Scalar) by exponent: the kernel's IdwPow mode
# (any other exponent: 8, powf)
_POW_MODES = {0.0: 0, 1.0: 1, 0.5: 2, -0.5: 3, -1.0: 4, 2.0: 5, 3.0: 6, -2.0: 7}


def _pow_mode(power: float) -> tuple[int, float]:
    """(mode, e) of B15's weights for ``power``: e = power / 2, as the plain
    version's ``d2 ** (power / 2.0)``, and the way torch computes that power
    on the card (``IdwPow`` in ``csrc/scattered_select.cu``)."""
    e = float(power) / 2.0
    return _POW_MODES.get(e, 8), e


def window_idw_launch(pack, P: int, qlon, qlat, taps, geo, num_lon: int, num_lat: int, k: int, power: float, eps: float):
    """One B15 launch: the ``cuda`` implementation of
    ``auvtpu_torch::window_idw``.  ``taps`` (:func:`_window_krige_taps`)
    and ``geo`` (:func:`_krige_geo`) are CPU tensors read on the host."""
    name = "window_idw"
    dev = pack.device
    _check(pack, P, k, name, qlon, qlat)
    M = taps.numel() // 2
    if taps.numel() % 2 or M not in WINDOW_M or pack_width(M) != P or geo.numel() != 10:
        raise ValueError(f"{name}: {taps.numel()} tap values for rows of {P} and {geo.numel()} grid scalars; want "
                         f"2*M, M in {WINDOW_M}, and 10")
    geo32 = _geo32(geo)  # held until the launch has read it
    host_taps, host_geo = _host_floats(taps, name, "taps"), _host_floats(geo32, name, "grid scalars")
    n = int(qlon.shape[0])
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    mode, e = _pow_mode(power)
    with torch.cuda.device(dev):
        err = _lib().auvtpu_window_idw(
            pack.data_ptr(), P, M, qlon.data_ptr(), qlat.data_ptr(), host_taps, n, num_lon, num_lat, host_geo, k,
            mode, e, float(eps), out.data_ptr(), _stream(dev),
        )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def window_idw_attributes(M: int, k: int = 8) -> dict:
    """The resources of B15's build for M taps and ``k`` (4 and 8 have
    builds of their own, any other k the general one) on the current card,
    as :func:`window_krige_attributes` gives them (the shared memory and
    blocks an SM of its launch on an aligned pack), and ``stages``: the
    chunks of rows a warp holds in shared memory (0: the rows go straight
    into registers)."""
    out = (ctypes.c_int * 5)()
    _raise_on(_lib().auvtpu_window_idw_attributes(M, k, out), "window_idw")
    return dict(zip(("registers", "spill_bytes", "blocks_per_sm", "shared_bytes", "stages"), out))


# ---------------------------------------------------------------------------
# B7 wrappers: the select dict of ops.packs.packed_window_select
# ---------------------------------------------------------------------------

def _window_dict(out, x, y, oob, ci, cj, k: int, R: int) -> dict:
    """The select dict of ``ops.packs.packed_window_select`` from B7's
    (N, 1+3k) rows, the dx-major codes decoded as
    ``pallas_window_select`` decodes them."""
    B = 2 * R + 2
    found = out[:, 0].to(torch.int32)
    slot_ok = torch.arange(k, device=out.device)[None, :] < found[:, None]
    c_ = torch.clamp(out[:, 1 + 2 * k:1 + 3 * k], min=0.0)
    dxs = torch.floor(c_ * (1.0 / B))
    dys = c_ - dxs * B - R
    return {
        "x": x, "y": y, "oob": oob, "ci": ci, "cj": cj,
        "val": out[:, 1:1 + k], "d2": out[:, 1 + k:1 + 2 * k], "slot_ok": slot_ok,
        "found": found, "dy": dys, "dx": dxs - R,
    }


def window_select_fused(pack, grid: RegularGrid, lons, lats, *, k: int, window_radius: int = 2, convention: str = "reference"):
    """Window top-k from a pack through the B7 mode of the kernel (drop-in
    for ``ops.packs.packed_window_select``; ``pallas_window_select``).
    Returns the same select dict: x, y, oob, ci, cj, val, d2, slot_ok,
    found, dy, dx."""
    offs = window_offsets(window_radius)
    P = pack_width(len(offs))
    R = window_radius
    x, y, oob, ci, cj, cell, fx, fy = prologue(grid, lons, lats)
    half = 0.5 if convention == "reference" else 0.0
    out = select(pack, P, cell, fx, fy, table(offs, P, R, "dx", grid.device), mode="rows_n", k=k, half=half)
    return _window_dict(out, x, y, oob, ci, cj, k, R)


def packed_kriging_fused(pack, grid: RegularGrid, lons, lats, *, window_radius: int = 2, vparams=None, convention: str = "reference", model: str = "exponential"):
    """Ordinary kriging over the radius-R window pack with B7's selection
    and the solve in one kernel, B12 (``pallas_packed_kriging``): one launch
    a call on the card."""
    offs = _window(window_radius)
    return window_krige(pack, pack_width(len(offs)), offs, window_radius, grid, lons, lats, convention=convention,
                        vparams=vparams, model=model)


def packed_idw_fused(pack, grid: RegularGrid, lons, lats, *, k: int = 8, power: float = 2.0, window_radius: int = 2, convention: str = "reference"):
    """k-nearest IDW over the radius-R window pack with B7's selection, the
    weights and the quotient in one kernel, B15 (``pallas_packed_idw``):
    one launch a call on the card."""
    offs = _window(window_radius)
    return window_idw(pack, pack_width(len(offs)), offs, window_radius, grid, lons, lats, k=k, power=power,
                      convention=convention)


@lru_cache(maxsize=8)
def _window(radius: int) -> tuple:
    """``window_offsets(radius)`` as a tuple, made once: the per-call key of
    the tap tables' caches."""
    return tuple(window_offsets(radius))
