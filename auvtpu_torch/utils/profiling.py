"""Profiling helpers (counterpart of :mod:`auvtpu.utils.profiling`, which
captures a ``jax.profiler`` trace): a ``torch.profiler`` trace of the host
and, where there is a card, of its kernels (:func:`trace`); the program's
spans, which name its layers in such a trace (:func:`span`,
:func:`spanned`); and its counters (:data:`COUNTERS`).

**Spans.** A span is a profiler event named
``auvtpu_torch.<module>.<function>`` (``:<part>`` for a piece of a
function): the dot keeps it apart from the dispatcher's
``auvtpu_torch::<op>`` events.  A span with no enclosing span of the
package on its thread is a *root*, one a request: its children nest under
it, so nesting gives each span's parent.  Spans are events of whatever
profiler runs (this module's :func:`trace`, or a caller's own
``torch.profiler.profile``), on the device trace's clock, kept in the
profiler's memory and written with its Chrome trace.  With no profiler
running a span costs one check and opens nothing, and it never enters a
graph that ``torch.compile`` or ``torch.export`` traces.

**Counters.** One registry of plain integer counts, always on:
``COUNTERS[section][name]``.  Each kernel module's ``LAUNCHES`` is its
section ``launches.<module>`` (the same dict object): one a launch of each
kernel.  Section ``fill``: ``cells_solved``, the cells a kriging fill
solves (H x W of every :func:`auvtpu_torch.ops.dense.fill_kriging`
call, whatever its backend: each solves the whole plane; the listed cells
of a :func:`auvtpu_torch.ops.dense.kriging_at_cells` call that B19 solves
alone), and
``cells_returned``, the cells :func:`auvtpu_torch.ops.dense.kriging_at_cells`
hands back.  Section ``fit``: ``fits``, one a call of
:func:`auvtpu_torch.variogram.fit_variogram` (a fit-then-fill's fit).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch

OFF = contextlib.nullcontext()  # what a span is with no profiler running
_enabled = torch._C._autograd._profiler_enabled
_Fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
# read before _enabled(), which Dynamo cannot trace: the flag that
# torch.compiler.is_compiling() returns, without its two python calls
_compiler = torch.compiler


def span(name: str):
    """A context manager that records ``name`` (``auvtpu_torch.<module>.<function>``
    or ``...:<part>``) as an event of the running profiler: a
    ``_RecordFunctionFast`` (a ``cpu_op`` in the trace), or
    ``torch.profiler.record_function`` where torch lacks it.  With no
    profiler running, or while ``torch.compile`` or ``torch.export``
    traces the caller, the shared no-op :data:`OFF`."""
    if _compiler._is_compiling_flag or not _enabled() or _compiler.is_exporting():
        return OFF
    return _Fast(name) if _Fast is not None else torch.profiler.record_function(name)


def spanned(fn):
    """Decorator: every call of ``fn`` inside :func:`span` named
    ``<module>.<qualified name>`` (``auvtpu_torch.ops.dense.fill_kriging``);
    with no profiler running, a plain call after the same one check."""
    name = f"{fn.__module__}.{fn.__qualname__}"

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if _compiler._is_compiling_flag or not _enabled():
            return fn(*args, **kwargs)
        with span(name):
            return fn(*args, **kwargs)

    return call


COUNTERS: dict[str, dict[str, int]] = {}


def counters(section: str, names) -> dict[str, int]:
    """The registry's ``section``, each of ``names`` in it (at 0 when new):
    the same dict object every call, so a module keeps it as its own."""
    sec = COUNTERS.setdefault(section, {})
    for name in names:
        sec.setdefault(name, 0)
    return sec


def reset(section: str) -> None:
    """Set every count of ``section`` to 0."""
    sec = COUNTERS.get(section, {})
    for name in sec:
        sec[name] = 0


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
