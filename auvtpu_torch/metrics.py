"""Error metrics (copy of :mod:`auvtpu.metrics`), on numpy arrays and torch
tensors.

``*_reference`` variants reproduce src/error_calculator.cpp exactly, including
its quirks:

- MAE (error_calculator.cpp:5-17) and RMSE (:19-32) skip NaN *predictions* but
  still divide by the full reference length, a bias that must be kept for
  parity with the published tables.
- max error (:34-45) never tests isnan; NaN differences fail every ``>``
  comparison and silently drop out.

``*_corrected`` variants divide by the number of finite predictions instead.
A tensor prediction is reduced with torch on its own device (the reference
values are moved there); anything else is reduced with numpy.
"""

from __future__ import annotations

import numpy as np
import torch


class _TorchNS:
    """The few numpy names the metrics use, on torch, bound to a device."""

    inf = float("inf")
    isnan = staticmethod(torch.isnan)
    abs = staticmethod(torch.abs)
    sqrt = staticmethod(torch.sqrt)
    sum = staticmethod(torch.sum)
    max = staticmethod(torch.max)
    min = staticmethod(torch.min)
    where = staticmethod(torch.where)

    def __init__(self, device):
        self.device = device

    def asarray(self, a):
        return torch.as_tensor(a, device=self.device)

    @staticmethod
    def maximum(a, b):
        return torch.clamp(a, min=b)


def _xp(a):
    return _TorchNS(a.device) if torch.is_tensor(a) else np


def mae_reference(ref, pred):
    xp = _xp(pred)
    ref = xp.asarray(ref)
    pred = xp.asarray(pred)
    ok = ~xp.isnan(pred)
    s = xp.sum(xp.where(ok, xp.abs(ref - pred), 0.0))
    return s / ref.shape[0]


def rmse_reference(ref, pred):
    xp = _xp(pred)
    ref = xp.asarray(ref)
    pred = xp.asarray(pred)
    ok = ~xp.isnan(pred)
    d = xp.where(ok, ref - pred, 0.0)
    return xp.sqrt(xp.sum(d * d) / ref.shape[0])


def max_error_reference(ref, pred):
    xp = _xp(pred)
    ref = xp.asarray(ref)
    pred = xp.asarray(pred)
    d = xp.abs(ref - pred)
    d = xp.where(xp.isnan(d), -xp.inf, d)
    m = xp.max(d)
    # reference starts maxErr at 0.0, so an all-NaN batch reports 0
    return xp.maximum(m, 0.0)


def mae_corrected(ref, pred):
    xp = _xp(pred)
    ref = xp.asarray(ref)
    pred = xp.asarray(pred)
    ok = ~xp.isnan(pred)
    n = xp.maximum(xp.sum(ok), 1)
    return xp.sum(xp.where(ok, xp.abs(ref - pred), 0.0)) / n


def rmse_corrected(ref, pred):
    xp = _xp(pred)
    ref = xp.asarray(ref)
    pred = xp.asarray(pred)
    ok = ~xp.isnan(pred)
    n = xp.maximum(xp.sum(ok), 1)
    d = xp.where(ok, ref - pred, 0.0)
    return xp.sqrt(xp.sum(d * d) / n)


def coverage(pred):
    """Fraction of finite predictions (bilinear leaves holes; paper Fig. 10)."""
    if torch.is_tensor(pred):
        return torch.mean((~torch.isnan(pred)).to(pred.dtype))
    pred = np.asarray(pred)
    return np.mean((~np.isnan(pred)).astype(pred.dtype))


def range_normalized_rmse(ref, pred):
    """RMSE as % of the reference value range (test_interpolation.py:111-146)."""
    xp = _xp(pred)
    ref = xp.asarray(ref)
    r = rmse_corrected(ref, pred)
    span = xp.max(ref) - xp.min(ref)
    return 100.0 * r / span


def all_reference_metrics(ref, pred) -> dict:
    return {
        "MAE": float(mae_reference(ref, pred)),
        "RMSE": float(rmse_reference(ref, pred)),
        "MaxError": float(max_error_reference(ref, pred)),
    }
