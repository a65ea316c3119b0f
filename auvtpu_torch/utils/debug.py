"""Debug / sanitizer mode (counterpart of :mod:`auvtpu.utils.debug`).

The JAX package switches on ``jax_debug_nans`` (raise at the primitive that
made a NaN) and ``jax_disable_jit`` (run op by op).  Torch has no such
flags; their counterpart is a dispatch mode that sees every op:

- *nans*: after each op, its floating outputs are checked, and an op that
  made a NaN that none of its inputs held (tensors or numbers) raises
  ``FloatingPointError`` naming the op.  A NaN passed along is not made
  again, so the check names the op where it first appeared.
- *disable_jit*: torch runs op by op already, but a CUDA launch returns
  before the card has run it, so a fault shows at some later op.  The mode
  calls ``torch.cuda.synchronize()`` after every op on a CUDA tensor, so an
  asynchronous fault is raised at the op that caused it.  Nothing is swapped
  for a plain version: the kernels run as they do without the mode.
- *x64*: torch always has float64 (no switch to turn on), so the argument
  is accepted and changes nothing.

What the mode sees: every aten op and every hand-written kernel, each an
``auvtpu_torch::`` custom op that passes through the dispatcher
(:mod:`auvtpu_torch.kernels.library`: B1 ``kriging_fill``, B2
``topk_full``, B3 ``window_fill``, B4 ``topk_idx``, B5 ``valid_select``,
B6 ``idw_select``, B7 ``window_select``, B8 ``band_resample``, B9
``pair_sums``, B10 ``fit_model``, B11 ``select_krige``), so a NaN that a
kernel makes raises naming its op, and *disable_jit* synchronises right
after each launch.  Outputs of ``empty`` ops hold whatever the memory held
and are not checked.

NaN caveat (the JAX package's, narrowed): the reference encodes "no data"
as NaN.  The port's plain fills write such cells from a NaN constant (a
``where`` against ``full_like(x, nan)``), which holds a NaN, so they pass;
a NaN that arithmetic makes (0/0, inf - inf, log of a negative) raises,
legitimate or not.  So does a kernel that writes NaN as "no data" from no
NaN input, as the JAX package's ``pallas_call`` does under
``jax_debug_nans``:

- B11 (``select_krige``) at a query outside the grid;
- B1 (``kriging_fill``) and B3 (``window_fill``) at a cell with no valid
  neighbour in the window (and B1's variance plane at every fallback
  cell);
- B8 (``band_resample``) at a ping that is not resolved (outside its
  window or page, or on a masked band too little of it valid).

Run debug mode on fully covered workloads where that matters, or catch the
``FloatingPointError`` and read the op it names.  Each check reads a flag
back from the device, so the mode costs a synchronisation an op.

Use as a context manager or process-wide::

    with debug_mode():                  # NaN checking only
        out = fill_kriging(grid)
    with debug_mode(disable_jit=True):  # also synchronise after every op
        ...

CLIs expose it as ``--debug`` (NaN checking) / ``--debug-eager``.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _floats(tree):
    return [t for t in tree_leaves(tree) if torch.is_tensor(t) and t.is_floating_point()]


def _holds_nan(tree) -> bool:
    for x in tree_leaves(tree):
        if torch.is_tensor(x):
            if x.is_floating_point() and bool(torch.isnan(x).any()):
                return True
        elif isinstance(x, float) and math.isnan(x):
            return True
    return False


class _DebugMode(TorchDispatchMode):
    def __init__(self, nans: bool, sync: bool):
        super().__init__()
        self.nans = nans
        self.sync = sync

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.sync and any(t.is_cuda for t in tree_leaves((out, args, kwargs)) if torch.is_tensor(t)):
            torch.cuda.synchronize()
        if self.nans and not func.__name__.startswith(("empty", "new_empty")):
            if any(bool(torch.isnan(t).any()) for t in _floats(out)) and not _holds_nan((args, kwargs)):
                raise FloatingPointError(f"NaN made by {func} (debug_mode: none of its inputs held a NaN)")
        return out


@contextlib.contextmanager
def debug_mode(*, nans: bool = True, disable_jit: bool = False, x64: bool = False):
    """Context manager enabling the checking modes; restores on exit.
    ``x64`` is accepted for the JAX package's signature and changes nothing
    (torch always has float64)."""
    del x64
    if not (nans or disable_jit):
        yield
        return
    with _DebugMode(nans, disable_jit):
        yield


def enable_debug(*, nans: bool = True, disable_jit: bool = False):
    """Process-wide switch (CLI ``--debug`` / ``--debug-eager``): enters the
    mode for the rest of the process on this thread.  Returns the mode
    (``mode.__exit__(None, None, None)`` leaves it), or None when both
    checks are off."""
    if not (nans or disable_jit):
        return None
    mode = _DebugMode(nans, disable_jit)
    mode.__enter__()
    return mode
