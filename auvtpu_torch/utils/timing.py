"""Timing utilities (counterpart of :mod:`auvtpu.utils.timing`).

The reference times each batch end-to-end with std::chrono around the call,
including H2D/D2H staging and the device sync (GridD.cu:107-147 inside the
timed region).  We report both:

- ``time_once_ms``: one cold-ish end-to-end call including result readback,
  the reference-comparable number;
- ``steady_state_ms``: amortized device throughput over K queued calls with a
  single synchronise, the production serving number.

Each is a host clock around work that ends in ``torch.cuda.synchronize()``
when the result lies on a card; a CPU result is ready when the call returns.
"""

from __future__ import annotations

import time

import torch


def _leaves(x) -> list:
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [leaf for e in x for leaf in _leaves(e)]
    if isinstance(x, dict):
        return [leaf for e in x.values() for leaf in _leaves(e)]
    return []


def _sync(x):
    """Wait for the device work behind ``x``."""
    if any(t.is_cuda for t in _leaves(x)):
        torch.cuda.synchronize()
    return x


def _sync_full(x):
    """Readback sync: copies the last tensor of ``x`` to the host."""
    leaves = _leaves(x)
    if leaves:
        leaves[-1].detach().cpu()
    return _sync(x)


def time_once_ms(fn, *args) -> tuple[float, object]:
    """Cold-ish end-to-end: includes result readback (the reference's timed
    region includes D2H, GridD.cu:107-147)."""
    t0 = time.perf_counter()
    out = _sync_full(fn(*args))
    return (time.perf_counter() - t0) * 1e3, out


def warm_e2e_ms(fn, *args, reps: int = 3):
    """Warm end-to-end: one call + full result readback.

    The reference's timed region is exactly this shape on an already-built
    kernel (GridD.cu:107-147: per-batch staging + launch + sync + D2H) and
    never includes compilation.  This calls fn once un-timed (absorbing the
    kernel build and allocator warm-up), then reports the fastest of
    ``reps`` timed end-to-end calls.
    """
    out = _sync_full(fn(*args))
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        out = _sync_full(fn(*args))
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, out


def steady_state_ms(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Steady-state device time: K queued calls, one synchronise."""
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) * 1e3 / iters
