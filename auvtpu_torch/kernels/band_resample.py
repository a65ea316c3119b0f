"""The band/atlas resample kernel (B8) and its plain version (counterpart of
:mod:`auvtpu.pallas.band_resample` and of the XLA default path of
``auvtpu.ops.band``).

``csrc/band_resample.cu`` serves a trajectory in chunks of consecutive
queries, one thread block a chunk: it maps each query into the frame of the
pages (the coordinate prologue), picks the chunk's page (``pick``), bases
one window at the chunk's minimum cell, and resamples each query bilinearly
from the four corners of its cell, NaN where the cell leaves the window or
the page (or, with ``masked``, touches an undefined cell).

The prologue is an affine map of f32 scalars ``(u0, du, su, v0, dv, sv)``:
x = (u - u0) / du - su and y = (v - v0) / dv - sv, each operation rounded
once (IEEE division).  With the grid's origin, step and a band's (col0,
row0) it is ``ops.band._xy`` followed by the band shift, bit for bit; the
identity ``(0, 1, 0)`` takes frame coordinates as they are.  The batch may
end in a ragged chunk: its bbox is reduced over its real queries only,
which gives the min and max of the JAX package's pad with the last query.

Two choices shape the result, and the kernel and the plain version take
both:

- the window geometry: ``aligned=False`` is the XLA path's (wr, wc) window
  based at the chunk's minimum cell; ``aligned=True`` is
  ``pallas_band_resample``'s, widened to (ceil8(wr)+8, ceil128(wc)+128) with
  an 8/128-aligned base clamped to the padded extent (``_window_bases``);
- the weights: ``hat=False`` is the one-hot family (1-f, f) of the Pallas
  kernel and ``lerp_mode="onehot"``; ``hat=True`` the hat family
  (1-f, 1-(1-f)) of ``"hat"``, ``"hat2"`` and ``"hat_t"``.

:func:`band_resample_ref` is the plain version: the same prologue, floors,
four-corner gather and two-term sums in the same order, so the two are
bit-equal on a card.  :func:`band_resample` runs it only for planes on the
CPU; for CUDA planes it launches the kernel or raises, through the custom
op ``auvtpu_torch::band_resample`` (:mod:`.library`) whose ``cuda``
implementation is :func:`resample_launch`.  Each launch adds one
to ``LAUNCHES["band_resample"]``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..ops.band import _ceil_to
from ..ops.scattered import saturating_index
from ..utils.profiling import counters, reset
from . import library

LAUNCHES = counters("launches.band_resample", ("band_resample",))
# masked queries resolve where the weights on the vmask sum above 1 - 1e-3,
# the python constant JAX rounds to float32 (ops/band.py:217, :246)
WSUM_THRESH = float(np.float32(1.0 - 1e-3))
# the prologue that takes frame coordinates as they are: (x - 0) / 1 - 0
IDENTITY = (0.0, 1.0, 0.0, 0.0, 1.0, 0.0)


def reset_launches() -> None:
    reset("launches.band_resample")


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import load

    lib = load("band_resample")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.auvtpu_band_resample.argtypes = [P, P, P, I, I, I, P, P, I, I, I, I, I, I, I, I, I, I, I,
                                         F, F, F, F, F, F, F, P, P, P]
    lib.auvtpu_band_resample.restype = I
    lib.auvtpu_band_error_string.argtypes = [I]
    lib.auvtpu_band_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the kernel now rather than at the first launch."""
    _lib()


def geometry(R: int, C: int, wr: int, wc: int, aligned: bool):
    """(window rows, window cols, row alignment, col alignment, row base
    limit, col base limit) of a (wr, wc) window over (R, C) pages.  Aligned:
    the window of ``pallas_band_resample`` and the base clamp to the padded
    extent of ``_pad_planes`` (band_resample.py:174-180, 194-202); the
    kernel needs no padded copy, since ``ok`` keeps every read inside the
    real (R, C)."""
    if not aligned:
        return wr, wc, 1, 1, max(R - wr, 0), max(C - wc, 0)
    wrp = _ceil_to(wr, 8) + 8
    wcp = _ceil_to(wc, 128) + 128
    Rp = max(_ceil_to(R, 8), wrp)
    Cp = max(_ceil_to(C, 128), wcp)
    return wrp, wcp, 8, 128, Rp - wrp, Cp - wcp


def band_resample_ref(planes, vmasks, origins, x, y, *, chunk: int, wr: int, wc: int, pick: bool, aligned: bool = False, hat: bool = True, affine=IDENTITY):
    """Plain version of :func:`band_resample`.

    planes (K, R, C) NaN-free page values; vmasks (K, R, C) definedness or
    None (the page is fully defined); origins (K, 2) page (row0, col0) in
    the planes' dtype, or None (every page at (0, 0)); x, y (N,) query
    coordinates, mapped into the origins' frame by ``affine`` (module
    docstring), any N (the last chunk may be ragged).  Returns (z (N,), ok
    (N,) bool)."""
    K, R, C = planes.shape
    n = x.shape[0]
    dev = planes.device
    if n == 0:
        return x.new_empty(0), torch.zeros(0, dtype=torch.bool, device=x.device)
    u0, du, su, v0, dv, sv = affine
    # the steps divide as 0-d tensors: a python-scalar divisor of a CUDA
    # tensor is a multiply by its reciprocal, which the kernel does not do
    x = (x - u0) / torch.tensor(du, dtype=x.dtype, device=x.device) - su
    y = (y - v0) / torch.tensor(dv, dtype=y.dtype, device=y.device) - sv
    pad = (-n) % chunk  # the ragged last chunk, padded with its last query
    if pad:
        x = torch.cat([x, x[-1:].expand(pad)])
        y = torch.cat([y, y[-1:].expand(pad)])
    if origins is None:
        origins = torch.zeros((K, 2), dtype=planes.dtype, device=dev)
    wh, ww, ar, ac, lim_r, lim_c = geometry(R, C, wr, wc, aligned)
    nch = x.shape[0] // chunk
    xc = x.reshape(nch, chunk)
    yc = y.reshape(nch, chunk)
    if pick:
        cx = 0.5 * (xc.amin(dim=1) + xc.amax(dim=1))
        cy = 0.5 * (yc.amin(dim=1) + yc.amax(dim=1))
        r0 = origins[:, 0][None, :]
        c0 = origins[:, 1][None, :]
        fits = (cx[:, None] >= c0) & (cx[:, None] <= c0 + (C - 1)) & (cy[:, None] >= r0) & (cy[:, None] <= r0 + (R - 1))
        any_fit = fits.any(dim=1)
        page = torch.argmax(fits.to(torch.int32), dim=1)  # the first page that fits
    else:
        any_fit = torch.ones(nch, dtype=torch.bool, device=x.device)
        page = torch.zeros(nch, dtype=torch.int64, device=x.device)
    org = origins[page]
    xb = xc - org[:, 1:2]
    yb = yc - org[:, 0:1]
    fx0 = torch.floor(xb)
    fy0 = torch.floor(yb)
    # cast as XLA does (jnp.floor(x).astype(jnp.int32), ops/band.py:100-101,
    # :468-469): a NaN ping is cell 0 in the window base, +inf 2**31 - 1
    x0 = saturating_index(fx0)
    y0 = saturating_index(fy0)
    bx = torch.clamp(torch.div(x0.amin(dim=1), ac, rounding_mode="floor") * ac, 0, lim_c)
    by = torch.clamp(torch.div(y0.amin(dim=1), ar, rounding_mode="floor") * ar, 0, lim_r)
    lx0 = x0 - bx[:, None]
    ly0 = y0 - by[:, None]
    ok = (
        (lx0 >= 0) & (lx0 <= ww - 2) & (ly0 >= 0) & (ly0 <= wh - 2)
        & (x0 >= 0) & (x0 <= C - 2) & (y0 >= 0) & (y0 <= R - 2) & any_fit[:, None]
    )
    wx = xb - fx0
    wy = yb - fy0
    ax0, ay0 = 1.0 - wx, 1.0 - wy
    ax1 = 1.0 - (1.0 - wx) if hat else wx
    ay1 = 1.0 - (1.0 - wy) if hat else wy
    # corners of the clamped cell: every query reads in range, the ones that
    # are not ok are discarded below
    i00 = (page[:, None] * (R * C) + y0.clamp(0, max(R - 2, 0)).long() * C + x0.clamp(0, max(C - 2, 0)).long())
    i10 = i00 + C

    def lerp(flat):
        ra = ay0 * flat[i00] + ay1 * flat[i10]
        rb = ay0 * flat[i00 + 1] + ay1 * flat[i10 + 1]
        return ax0 * ra + ax1 * rb

    z = lerp(planes.reshape(-1))
    if vmasks is not None:
        ok = ok & (lerp(vmasks.reshape(-1)) > WSUM_THRESH)
    z = torch.where(ok, z, torch.full_like(z, float("nan")))
    return z.reshape(-1)[:n], ok.reshape(-1)[:n]


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def band_resample(planes, vmasks, origins, x, y, *, chunk: int, wr: int, wc: int, pick: bool, aligned: bool = False, hat: bool = True, affine=IDENTITY):
    """Chunked windowed bilinear over K pages (B8): (z, ok) as
    :func:`band_resample_ref` gives them, through the op
    ``auvtpu_torch::band_resample``.  For planes on the CPU this is the
    plain version; for CUDA planes it launches the kernel: one launch and
    the two outputs' allocation, whatever the batch."""
    if planes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"band_resample: planes lie on {planes.device}; the kernel takes CUDA planes "
                         "(CPU planes run the plain version)")
    return library.band_resample(planes, vmasks, origins, x, y, chunk, wr, wc, pick, aligned, hat,
                                 [float(v) for v in affine])


def resample_launch(planes, vmasks, origins, x, y, *, chunk: int, wr: int, wc: int, pick: bool, aligned: bool, hat: bool, affine):
    """One B8 launch: the ``cuda`` implementation of
    ``auvtpu_torch::band_resample``."""
    dev = planes.device
    ins = [planes, x, y] + [t for t in (origins, vmasks) if t is not None]
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"band_resample: the kernel is float32 only (got {sorted({str(t.dtype) for t in ins})}); "
                        "float64 callers use the plain path on the CPU")
    if any(t.device != dev for t in ins):
        raise ValueError(f"band_resample: planes on {dev} but an input on another device")
    if planes.dim() != 3 or x.shape != y.shape or x.dim() != 1 or (
            origins is not None and origins.shape != (planes.shape[0], 2)):
        raise ValueError("band_resample: planes (K, R, C), origins (K, 2) or None, x and y (N,) expected")
    if vmasks is not None and vmasks.shape != planes.shape:
        raise ValueError("band_resample: vmasks must have the planes' shape")
    if chunk < 1:
        raise ValueError(f"band_resample: chunk={chunk} must be positive")
    K, R, C = planes.shape
    n = int(x.shape[0])
    wh, ww, ar, ac, lim_r, lim_c = geometry(R, C, wr, wc, aligned)
    # a strided x or y is copied; an unaligned slice is taken as it is (the
    # kernel's scalar-load instantiation)
    planes, x, y = (t.contiguous() for t in (planes, x, y))
    org = origins.contiguous() if origins is not None else None
    vm = vmasks.contiguous() if vmasks is not None else None
    z = torch.empty(n, dtype=torch.float32, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return z, ok
    with torch.cuda.device(dev):
        err = _lib().auvtpu_band_resample(
            planes.data_ptr(), vm.data_ptr() if vm is not None else None,
            org.data_ptr() if org is not None else None, K, R, C,
            x.data_ptr(), y.data_ptr(), n, chunk, wh, ww, ar, ac, lim_r, lim_c,
            int(vm is not None), int(pick), int(hat), WSUM_THRESH, *affine, z.data_ptr(), ok.data_ptr(), _stream(dev),
        )
    if err != 0:
        msg = _lib().auvtpu_band_error_string(err).decode()
        raise RuntimeError(f"band_resample: CUDA launch failed: {msg} ({err})")
    LAUNCHES["band_resample"] += 1
    return z, ok
