"""Profiling helpers (counterpart of :mod:`auvtpu.utils.profiling`, which
captures a ``jax.profiler`` trace): a ``torch.profiler`` trace of the host
and, where there is a card, of its kernels."""

from __future__ import annotations

import contextlib
import os
import time

import torch

# torch.profiler keeps only the device records whose times, mapped onto the
# host's clock, fall inside its capture window, and on an H100 host two
# things put records outside it (scripts/trace_window_probe.py): in a
# process that has done much device work, the first few kernel records of
# every session (3 to 14 seen) are dropped as out of range whatever the
# wait before them; and now and then a session's device times are skewed
# ~4 ms early, dropping the kernels of its first milliseconds.  So the
# window opens with WARMUP_KERNELS tiny kernels, labelled, that take the
# first loss, then a synchronisation and WINDOW_MARGIN_S of idle card before
# the traced code, and closes WINDOW_MARGIN_S after it.
WARMUP_KERNELS = 128
WINDOW_MARGIN_S = 0.05


@contextlib.contextmanager
def trace(out_dir: str | None):
    """Context manager: profile the enclosed code (CPU activity, and CUDA
    activity when torch sees a card) and write a Chrome trace into
    ``out_dir`` (``trace.<pid>.<ms>.json``; open it in Perfetto or
    chrome://tracing).  Yields the profiler, whose ``key_averages()`` the
    caller may read after the block.  With a card, the trace also holds
    ``WARMUP_KERNELS`` tiny kernels under "auvtpu_torch.trace warm-up"
    before the traced code, and the window opens and closes
    ``WINDOW_MARGIN_S`` away from it.  No-op (yields None) when ``out_dir``
    is falsy."""
    if not out_dir:
        yield None
        return
    os.makedirs(out_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        if cuda:
            with torch.profiler.record_function("auvtpu_torch.trace warm-up"):
                x = torch.zeros(1, device="cuda")
                for _ in range(WARMUP_KERNELS):
                    x.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(WINDOW_MARGIN_S)
        yield prof
        if cuda:
            torch.cuda.synchronize()
            time.sleep(WINDOW_MARGIN_S)
    prof.export_chrome_trace(os.path.join(out_dir, f"trace.{os.getpid()}.{int(time.time() * 1e3)}.json"))
