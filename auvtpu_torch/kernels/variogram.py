"""Wrappers of the variogram kernels (counterpart of the scans of
:mod:`auvtpu.variogram`, which have no Pallas kernel).

Two kernels, both in ``csrc/variogram.cu``:

- :func:`pair_sums` (B9, ``pair_sums_tile_kernel`` + ``pair_sums_finish_kernel``,
  replaces the offset scan of ``auvtpu/variogram.py:60``): the binned
  float64 (sum of squared differences, pair count) of a block's base cells
  against their partners at an offset table's (dy, dx), partners outside the
  source plane reading as zero.  One layout serves the whole grid, a row
  band with the next band's rows below it and a 2-D block inside its
  halo-extended block (:func:`pair_sums_ref` states it).  A tile block
  whose cells all have a validity of 0 or 1 and a bounded elevation runs a
  faster path (NaN-coded halo, integer counts) with the same bits;
- :func:`fit_model` (B10, ``fit_model_kernel``, replaces the Gauss-Newton
  scan of ``auvtpu/variogram.py:337``): the whole float64 fit loop of
  :func:`fit_model_ref` in one launch of one warp, optionally with its
  per-step (kept, frozen) record (:func:`fit_walk`); the kernel stops at
  the first step that is not kept or that freezes, after which the loop's
  state cannot change, and records the rest as not kept.  With
  ``binned=True`` it takes B9's float64 sums and counts as they come and
  forms the semivariance in its launch (:func:`binned_gamma` states how),
  so a fit is B9's two kernels and B10's one, with nothing between them.

Each has its plain torch version beside it (``<wrapper>_ref``, the loops the
CPU tests hold against the JAX package).  A wrapper runs the plain version
only for tensors on the CPU; for CUDA tensors it launches its kernel or
raises.  Both go through their custom ops (:mod:`.library`:
``auvtpu_torch::pair_sums``, ``auvtpu_torch::fit_model`` and its overload
``::fit_model.binned``), whose ``cuda`` implementations are
:func:`pair_sums_launch`, :func:`fit_launch` and :func:`fit_binned_launch`.
Each launch adds one to ``LAUNCHES[<wrapper name>]``; each call of a
wrapper is a span of its own name.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..grid import device_cache
from ..utils.profiling import OFF, counters, reset, span, spanned
from . import library

LAUNCHES = counters("launches.variogram", ("pair_sums", "fit_model"))

MAX_LAG = 16  # the partner halo B9 stages in shared memory
MAX_OUT = 1024  # bins B9 takes
MAX_FIT_BINS = 512  # bins B10 keeps in shared memory
TILE = 32  # B9's tile of base cells is TILE x TILE
_MODELS = {"exponential": 0, "linear": 1, "spherical": 2, "gaussian": 3}


def reset_launches() -> None:
    reset("launches.variogram")


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# the C interface of csrc/variogram.cu (pointers and the stream as void*)
ARGTYPES = {
    "auvtpu_pair_sums": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P, _P],
    "auvtpu_fit_model": [_P, _I, _P, _I, _P, _I, _I, _P, _I, _I, _D, _P, _I, _P, _P],
    "auvtpu_fit_binned": [_P, _P, _P, _I, _I, _P, _I, _I, _D, _P, _P, _P, _P],
}


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import load

    lib = load("variogram")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I
    lib.auvtpu_variogram_error_string.argtypes = [_I]
    lib.auvtpu_variogram_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the kernels now rather than at the first launch."""
    _lib()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().auvtpu_variogram_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({err})")


def _stream(dev: torch.device) -> ctypes.c_void_p:
    """The current stream of ``dev`` as the C interface takes it: torch's
    raw handle, with no ``torch.cuda.Stream`` made for it (that costs ~9 µs
    of host a launch)."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(dev.index))


def _on(dev: torch.device):
    """The device context of a launch on ``dev``: none where ``dev`` is the
    current device already, as it is on a one-card machine (entering
    ``torch.cuda.device`` costs ~7 µs of host a launch)."""
    return OFF if dev.index == torch.cuda.current_device() else torch.cuda.device(dev)


# ---------------------------------------------------------------------------
# B9: binned pair sums
# ---------------------------------------------------------------------------

def grouped_table(dys, dxs, bin_of, n_out: int) -> np.ndarray:
    """B9's offset table: the (dy, dx) pairs stably sorted by bin (within a
    bin, the table's own order), then the n_out + 1 bin starts, as one int32
    array.  A bin's sum in this order is the plain loop's, which adds into
    each bin in table order."""
    bins = np.asarray(bin_of, np.int64)
    if bins.size and (bins.min() < 0 or bins.max() >= n_out):
        raise ValueError(f"pair_sums: bins outside 0..{n_out - 1}")
    order = np.argsort(bins, kind="stable")
    pairs = np.stack([np.asarray(dys, np.int64)[order], np.asarray(dxs, np.int64)[order]], axis=1)
    starts = np.searchsorted(bins[order], np.arange(n_out + 1), side="left")
    return np.concatenate([pairs.reshape(-1), starts]).astype(np.int32)


def split_table(table, n_out: int):
    """(dys, dxs, bin_of) of a :func:`grouped_table` (host lists), in its
    order."""
    t = [int(v) for v in (table.tolist() if torch.is_tensor(table) else table)]
    n_off = (len(t) - (n_out + 1)) // 2
    starts = t[2 * n_off:]
    bins = [b for b in range(n_out) for _ in range(starts[b + 1] - starts[b])]
    return t[0:2 * n_off:2], t[1:2 * n_off:2], bins


@device_cache(maxsize=32)
def _device_table(key: tuple, n_out: int, device: torch.device) -> torch.Tensor:
    dys, dxs, bin_of = (np.asarray(a) for a in key)
    return torch.from_numpy(grouped_table(dys, dxs, bin_of, n_out)).to(device)


def binned_sums_ref(base_e, base_v, shifted, dys, dxs, bin_of, n_out: int):
    """The pair sums of the base cells against ``shifted(dy, dx)``'s planes.
    The squared differences are taken in the planes' dtype and summed in
    float64: the pair counts are exact (a float32 count stops at 2**24) and
    the sums, rounded once by the caller, do not depend on how a grid is
    split into blocks, so a sharded fit sums what the one-device fit
    sums."""
    s = torch.zeros(n_out, dtype=torch.float64, device=base_e.device)
    c = torch.zeros(n_out, dtype=torch.float64, device=base_e.device)
    for dy, dx, b in zip(dys.tolist(), dxs.tolist(), bin_of.tolist()):
        zv, mv = shifted(dy, dx)
        both = base_v * mv
        d = (base_e - zv) * both
        s[b] += torch.sum(d * d, dtype=torch.float64)
        c[b] += torch.sum(both, dtype=torch.float64)
    return s, c


def pair_sums_ref(elev, valid, n_rows: int, n_cols: int, col0: int, dys, dxs, bin_of, n_out: int, max_lag: int):
    """Plain version of :func:`pair_sums`.  Layout: base cells
    ``elev[:n_rows, col0:col0 + n_cols]``; the partner of base cell (i, j)
    at offset (dy, dx) is ``elev[i + dy, col0 + j + dx]``, elevation 0 and
    validity 0 where that falls outside the plane (zero padding, as the JAX
    package pads).  Returns the float64 (sums (n_out,), counts (n_out,))."""
    H, Wb, R = n_rows, n_cols, max_lag
    Hs, Ws = elev.shape
    pad = (max(0, R - col0), max(0, col0 + Wb + R - Ws), 0, max(0, H + R - Hs))
    pe, pv = (F.pad(elev, pad), F.pad(valid, pad)) if any(pad) else (elev, valid)
    c = col0 + pad[0]
    return binned_sums_ref(elev[:H, col0:col0 + Wb], valid[:H, col0:col0 + Wb],
                           lambda dy, dx: (pe[dy:dy + H, c + dx:c + dx + Wb], pv[dy:dy + H, c + dx:c + dx + Wb]),
                           np.asarray(dys), np.asarray(dxs), np.asarray(bin_of), n_out)


def _pitch(t: torch.Tensor, what: str) -> int:
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f"{what}: the kernel takes (H, W) planes with unit column stride (got strides "
                         f"{tuple(t.stride())})")
    return t.stride(0)


def _check_layout(elev, valid, n_rows: int, n_cols: int, col0: int, n_out: int, max_lag: int) -> None:
    if elev.shape != valid.shape or elev.dim() != 2:
        raise ValueError(f"pair_sums: elev {tuple(elev.shape)} and valid {tuple(valid.shape)} must be one (H, W) shape")
    Hs, Ws = elev.shape
    if not (0 <= n_rows <= Hs and col0 >= 0 and n_cols >= 0 and col0 + n_cols <= Ws):
        raise ValueError(f"pair_sums: base block {n_rows}x{n_cols} at column {col0} outside the {Hs}x{Ws} plane")
    if not 1 <= n_out <= MAX_OUT:
        raise ValueError(f"pair_sums: {n_out} bins outside 1..{MAX_OUT}")
    if max_lag < 0:
        raise ValueError(f"pair_sums: max_lag {max_lag} < 0")


def offset_table(dys, dxs, bin_of, n_out: int, max_lag: int, device) -> torch.Tensor:
    """The offsets' :func:`grouped_table` on ``device``, made once per
    offsets and device; every offset must have 0 <= dy <= max_lag and
    |dx| <= max_lag."""
    dys, dxs, bin_of = (np.asarray(a, np.int64) for a in (dys, dxs, bin_of))
    if dys.size and (dys.min() < 0 or dys.max() > max_lag or np.abs(dxs).max() > max_lag):
        raise ValueError(f"pair_sums: an offset lies outside 0 <= dy <= {max_lag}, |dx| <= {max_lag}")
    key = (tuple(dys.tolist()), tuple(dxs.tolist()), tuple(bin_of.tolist()))
    return _device_table(key, n_out, device)


@spanned
def pair_sums(elev, valid, n_rows: int, n_cols: int, col0: int, dys, dxs, bin_of, n_out: int, max_lag: int,
              table=None):
    """Binned float64 (sums, counts) of the squared elevation differences of
    the base cells and their partners (B9; the layout of
    :func:`pair_sums_ref`).  The planes are read in place (any row stride,
    unit column stride), float32 or float64 alike; every offset must have
    0 <= dy <= max_lag and |dx| <= max_lag.  ``table``: the offsets'
    :func:`offset_table` on the planes' device where the caller keeps it,
    sparing the call the offsets' checks and the table's lookup.  On the
    card a call is two kernel launches (the tiles, then the fixed-order sum
    of their partials), the same bits every call.  Returns two views of
    one (2, n_out) tensor."""
    _check_layout(elev, valid, n_rows, n_cols, col0, n_out, max_lag)
    if table is None:
        table = offset_table(dys, dxs, bin_of, n_out, max_lag, elev.device)
    out = library.pair_sums(elev, valid, table, n_rows, n_cols, col0, max_lag, n_out)
    return out[0], out[1]


def pair_sums_launch(elev, valid, table, n_rows: int, n_cols: int, col0: int, max_lag: int, n_out: int):
    """One B9 call on CUDA planes: the ``cuda`` implementation of
    ``auvtpu_torch::pair_sums``.  Returns (2, n_out) float64."""
    dev = elev.device
    if dev.type != "cuda" or valid.device != dev or table.device != dev:
        raise ValueError(f"pair_sums: elev on {dev}, valid on {valid.device}, table on {table.device}; the kernel "
                         "takes them on one card (CPU planes run the plain version)")
    if elev.dtype not in (torch.float32, torch.float64) or valid.dtype != elev.dtype:
        raise TypeError(f"pair_sums: the kernel takes float32 or float64 planes of one dtype (got {elev.dtype}/"
                        f"{valid.dtype})")
    if table.dtype != torch.int32 or not table.is_contiguous():
        raise TypeError("pair_sums: the offset table is a contiguous int32 tensor (grouped_table)")
    _check_layout(elev, valid, n_rows, n_cols, col0, n_out, max_lag)
    if max_lag > MAX_LAG:
        raise ValueError(f"pair_sums: max_lag {max_lag} above the kernel's {MAX_LAG}")
    pe, pv = _pitch(elev, "pair_sums"), _pitch(valid, "pair_sums")
    n_off = (table.numel() - (n_out + 1)) // 2
    n_cta = -(-n_rows // TILE) * -(-n_cols // TILE) if n_rows and n_cols else 0
    # one allocation: the (2, n_out) output, then the blocks' partials
    buf = torch.empty(2 * n_out + max(n_cta, 1) * n_out * 2, dtype=torch.float64, device=dev)
    out, partials = buf[:2 * n_out].view(2, n_out), buf[2 * n_out:]
    Hs, Ws = elev.shape
    stream = _stream(dev)
    with _on(dev), span("auvtpu_torch.kernels.variogram.pair_sums_launch:call"):
        err = _lib().auvtpu_pair_sums(
            elev.data_ptr(), pe, valid.data_ptr(), pv, int(elev.dtype == torch.float64), Hs, Ws, n_rows, n_cols,
            col0, max_lag, table.data_ptr(), n_off, n_out, partials.data_ptr(), out.data_ptr(), stream,
        )
    _raise_on(err, "pair_sums")
    LAUNCHES["pair_sums"] += 1
    return out


# ---------------------------------------------------------------------------
# B10: the Gauss-Newton variogram fit
# ---------------------------------------------------------------------------

def fit_model_ref(lags, gamma, counts, *, model: str = "exponential", iters: int = 30, init=None, stop: float = 1e-4,
                  record: list | None = None):
    """Plain version of :func:`fit_model`: the float64 damped Gauss-Newton
    loop of :func:`auvtpu_torch.variogram.fit_model` (torch.func.jacfwd,
    solve_ex), ``stop`` its STOP_DGAMMA.  ``record``, a list, receives each
    step's (kept, frozen) pair of 0-d bool tensors.  Returns (nugget, p1,
    p2) as 0-d tensors in the dtype and on the device of ``gamma``."""
    from ..variogram import variogram_model

    dt = gamma.dtype
    dev = gamma.device
    lags, gamma, counts = (torch.as_tensor(a, device=dev).to(torch.float64) for a in (lags, gamma, counts))
    w = counts / torch.clamp(counts.sum(), min=1.0)
    if init is None:
        # data-driven init: sill ~ max gamma, range ~ a third of max lag,
        # nugget ~ 1% of sill
        sill0 = torch.clamp(torch.max(gamma), min=1e-3)
        maxlag = torch.clamp(torch.max(lags), min=1e-9)
        p1_0 = sill0 / maxlag if model == "linear" else sill0
        init = torch.stack([0.01 * sill0, p1_0, maxlag / 3.0])
    else:
        init = torch.stack([torch.as_tensor(v, dtype=torch.float64, device=dev).reshape(()) for v in init])
    theta = torch.log(init)
    sw = torch.sqrt(w)
    pairs = counts > 0

    def curve(th):
        return variogram_model(lags, torch.exp(th), model)

    def resid(th):
        return (curve(th) - gamma) * sw

    jac = torch.func.jacfwd(resid)
    eye = torch.eye(3, dtype=torch.float64, device=dev)
    frozen = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        now = curve(theta)
        r = (now - gamma) * sw
        J = jac(theta)
        A = J.T @ J
        damp = 1e-4 * torch.clamp(torch.trace(A) / 3.0, min=1e-12)
        g = J.T @ r
        # solve_ex: no error check, so no device-to-host sync in the loop
        delta, _ = torch.linalg.solve_ex(A + damp * eye, g)
        # trust region on the log step keeps early iterations stable
        delta = torch.clamp(delta, -2.0, 2.0)
        new = theta - delta
        nxt = curve(new)
        keep = ~frozen & (torch.sum(((nxt - gamma) * sw) ** 2) <= torch.sum(r**2))
        moved = torch.max(torch.where(pairs, (nxt - now).abs() / now.abs(), torch.zeros_like(now)))
        theta = torch.where(keep, new, theta)
        frozen = frozen | (keep & (moved < stop))
        if record is not None:
            record.append((keep, frozen))
    p = torch.exp(theta).to(dt)
    return p[0], p[1], p[2]


def _init_tensor(init, dev) -> torch.Tensor:
    """A fit's given start (nugget, p1, p2) as a (3,) float64 tensor on
    ``dev``."""
    return torch.stack([torch.as_tensor(v, dtype=torch.float64, device=dev).reshape(()) for v in init])


def _fit_args(lags, gamma, counts, init):
    """The fit's inputs as 1-D contiguous tensors on ``gamma``'s device and
    ``init`` as None or a (3,) float64 tensor there."""
    dev = torch.as_tensor(gamma).device
    lags, gamma, counts = (torch.as_tensor(a, device=dev).reshape(-1).contiguous() for a in (lags, gamma, counts))
    return lags, gamma, counts, None if init is None else _init_tensor(init, dev)


def fit_walk(lags, gamma, counts, *, model: str = "exponential", iters: int = 30, init=None, stop: float = 1e-4):
    """:func:`fit_model` with its walk: ((3,) parameters in ``gamma``'s
    dtype, (iters, 2) int8 per-step (kept, frozen)), the parameters those
    of :func:`fit_model_ref`'s loop."""
    if model not in _MODELS:
        raise ValueError(model)
    lags, gamma, counts, init = _fit_args(lags, gamma, counts, init)
    return library.fit_model(lags, gamma, counts, init, model, int(iters), float(stop))


@spanned
def fit_model(lags, gamma, counts, *, model: str = "exponential", iters: int = 30, init=None, stop: float = 1e-4,
              binned: bool = False):
    """Weighted damped Gauss-Newton fit of a variogram model (B10 on the
    card): :func:`fit_model_ref`'s loop, up to ``iters`` steps in one
    launch, nothing read back.  Returns (nugget, p1, p2) as 0-d views of one (3,)
    tensor in the dtype and on the device of ``gamma``.

    ``binned``: ``gamma`` and ``counts`` are B9's float64 sums and counts as
    :func:`pair_sums` returns them, and ``lags`` a (n,) float32 or float64
    tensor on their device; the fit forms the semivariance and the counts
    in ``lags``' dtype (:func:`binned_gamma`), inside its launch on the
    card, and returns the parameters in that dtype: the same bits as
    :func:`binned_gamma` followed by this fit."""
    if binned:
        if model not in _MODELS:
            raise ValueError(model)
        p = library.fit_binned(lags, gamma, counts, None if init is None else _init_tensor(init, gamma.device),
                               model, int(iters), float(stop))
    else:
        p, _ = fit_walk(lags, gamma, counts, model=model, iters=iters, init=init, stop=stop)
    return p.unbind()


def binned_gamma(sums, counts, dtype: torch.dtype):
    """The binned Matheron semivariance and the pair counts in ``dtype``
    from float64 (sums, counts): both rounded to ``dtype`` once, gamma =
    s / (2 max(c, 1)) where c > 0, else 0.  The torch ops of
    :func:`auvtpu_torch.variogram.empirical_variogram`, and what B10's
    binned form computes in its launch."""
    s, c = sums.to(dtype), counts.to(dtype)
    return torch.where(c > 0, s / (2.0 * torch.clamp(c, min=1.0)), torch.zeros_like(s)), c


def _is_f64(t: torch.Tensor, what: str) -> int:
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fit_model: {what} is {t.dtype}; the kernel takes float32 or float64")
    return int(t.dtype == torch.float64)


def fit_launch(lags, gamma, counts, init, model: str, iters: int, stop: float):
    """One B10 launch: the ``cuda`` implementation of
    ``auvtpu_torch::fit_model``.  Returns ((3,) parameters, (iters, 2)
    int8 flags)."""
    dev = gamma.device
    if dev.type != "cuda" or any(t.device != dev for t in (lags, counts) + ((init,) if init is not None else ())):
        raise ValueError(f"fit_model: the kernel takes its inputs on one card (gamma on {dev}); CPU inputs run "
                         "the plain loop")
    n = gamma.numel()
    if lags.numel() != n or counts.numel() != n:
        raise ValueError(f"fit_model: lags {lags.numel()}, gamma {n}, counts {counts.numel()} bins differ")
    if not 1 <= n <= MAX_FIT_BINS:
        raise ValueError(f"fit_model: {n} bins outside the kernel's 1..{MAX_FIT_BINS}")
    if model not in _MODELS:
        raise ValueError(model)
    if iters < 0:
        raise ValueError(f"fit_model: iters {iters} < 0")
    flags_in = [_is_f64(t, name) for t, name in ((lags, "lags"), (gamma, "gamma"), (counts, "counts"))]
    lags, gamma, counts = (t.contiguous() for t in (lags, gamma, counts))
    if init is not None:
        init = init.to(torch.float64).contiguous()
    out = torch.empty(3, dtype=gamma.dtype, device=dev)
    flags = torch.empty((iters, 2), dtype=torch.int8, device=dev)
    stream = _stream(dev)
    with _on(dev), span("auvtpu_torch.kernels.variogram.fit_launch:call"):
        err = _lib().auvtpu_fit_model(
            lags.data_ptr(), flags_in[0], gamma.data_ptr(), flags_in[1], counts.data_ptr(), flags_in[2], n,
            init.data_ptr() if init is not None else None, _MODELS[model], iters, stop, out.data_ptr(),
            flags_in[1], flags.data_ptr() if iters else None, stream,
        )
    _raise_on(err, "fit_model")
    LAUNCHES["fit_model"] += 1
    return out, flags


def fit_binned_ref(lags, sums, counts, init, model: str, iters: int, stop: float):
    """Plain version of the binned fit: :func:`binned_gamma` in ``lags``'
    dtype, then :func:`fit_model_ref`.  Returns the (3,) parameters."""
    gamma, c = binned_gamma(sums, counts, lags.dtype)
    return torch.stack(fit_model_ref(lags, gamma, c, model=model, iters=iters,
                                     init=None if init is None else init.unbind(), stop=stop))


def fit_binned_launch(lags, sums, counts, init, model: str, iters: int, stop: float, formed=None):
    """One B10 launch on B9's float64 (sums, counts): the ``cuda``
    implementation of ``auvtpu_torch::fit_model.binned``.  ``formed``, a
    (2, n) tensor in ``lags``' dtype, receives the gamma and counts the
    kernel formed.  Returns the (3,) parameters in ``lags``' dtype."""
    dev = lags.device
    if dev.type != "cuda" or any(t.device != dev for t in (sums, counts) + ((init,) if init is not None else ())):
        raise ValueError(f"fit_model: the kernel takes its inputs on one card (lags on {dev}); CPU inputs run "
                         "the plain loop")
    n = lags.numel()
    if lags.dim() != 1 or sums.shape != (n,) or counts.shape != (n,):
        raise ValueError(f"fit_model: lags {tuple(lags.shape)}, sums {tuple(sums.shape)}, counts "
                         f"{tuple(counts.shape)}: three (n,) tensors")
    if not 1 <= n <= MAX_FIT_BINS:
        raise ValueError(f"fit_model: {n} bins outside the kernel's 1..{MAX_FIT_BINS}")
    if model not in _MODELS:
        raise ValueError(model)
    if iters < 0:
        raise ValueError(f"fit_model: iters {iters} < 0")
    f64 = _is_f64(lags, "lags")
    if sums.dtype != torch.float64 or counts.dtype != torch.float64:
        raise TypeError(f"fit_model: binned sums and counts are B9's float64 (got {sums.dtype}/{counts.dtype})")
    lags, sums, counts = (t.contiguous() for t in (lags, sums, counts))
    if init is not None:
        init = init.to(torch.float64).contiguous()
    if formed is not None and (formed.shape != (2, n) or formed.dtype != lags.dtype or formed.device != dev
                               or not formed.is_contiguous()):
        raise ValueError(f"fit_model: formed is a contiguous (2, {n}) {lags.dtype} tensor on {dev}")
    out = torch.empty(3, dtype=lags.dtype, device=dev)
    stream = _stream(dev)
    with _on(dev), span("auvtpu_torch.kernels.variogram.fit_binned_launch:call"):
        err = _lib().auvtpu_fit_binned(
            lags.data_ptr(), sums.data_ptr(), counts.data_ptr(), f64, n,
            init.data_ptr() if init is not None else None, _MODELS[model], iters, stop, out.data_ptr(), None,
            formed.data_ptr() if formed is not None else None, stream,
        )
    _raise_on(err, "fit_model")
    LAUNCHES["fit_model"] += 1
    return out
