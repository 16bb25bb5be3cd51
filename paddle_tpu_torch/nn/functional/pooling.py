"""Pooling (counterpart of ``paddle_tpu/nn/functional/pooling.py``).

The reference's pools are ``lax.reduce_window`` over a padded window
grid: max pools pad with -inf, ``ceil_mode`` extends the high padding
until the last window fits, and an ``exclusive`` average divides by the
window's positions inside the input. Here they are torch's pools over
the same grid: the padding torch applies itself where it means the same
(symmetric, no ``ceil_mode``), else an explicit ``F.pad`` first. A
channels-last input (``data_format`` ``"NLC"``, ``"NHWC"``,
``"NDHWC"``) is pooled through its channels-first view.
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.nn.functional.conv import _same_pads, _tuple

__all__ = ["adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d",
           "max_pool3d"]

_F = torch.nn.functional
_MAX = {1: _F.max_pool1d, 2: _F.max_pool2d, 3: _F.max_pool3d}
_AVG = {1: _F.avg_pool1d, 2: _F.avg_pool2d, 3: _F.avg_pool3d}
_ADAPTIVE_AVG = {1: _F.adaptive_avg_pool1d, 2: _F.adaptive_avg_pool2d,
                 3: _F.adaptive_avg_pool3d}


def _grid(v, nd, kernel, stride, padding, ceil_mode):
    """kernel, stride and the (lo, hi) pads a spatial dim of channels-first
    ``v``, ``ceil_mode``'s extension of the high pads included."""
    kernel = _tuple(kernel, nd)
    stride = _tuple(kernel if stride is None else stride, nd)
    if isinstance(padding, str):
        pads = [(0, 0)] * nd if padding.upper() == "VALID" else _same_pads(
            v.shape[2:], kernel, stride, (1,) * nd)
        return kernel, stride, pads
    if isinstance(padding, (list, tuple)) and len(padding) == 2 * nd:
        pads = [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(nd)]
    else:
        pads = [(p, p) for p in _tuple(padding, nd)]
    if ceil_mode:
        for i, n in enumerate(v.shape[2:]):
            size = n + pads[i][0] + pads[i][1]
            out = -(-(size - kernel[i]) // stride[i]) + 1
            extra = max(0, (out - 1) * stride[i] + kernel[i] - size)
            pads[i] = (pads[i][0], pads[i][1] + extra)
    return kernel, stride, pads


def _pad(v, pads, value):
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return _F.pad(v, flat, value=value)


def _channels_first(fn, x, data_format):
    if data_format.startswith("NC"):
        return fn(x)
    return fn(x.movedim(-1, 1)).movedim(1, -1)


def _max_pool(x, nd, kernel_size, stride, padding, return_mask, ceil_mode,
              data_format):
    if return_mask:
        raise NotImplementedError("max pooling's return_mask is not ported")

    def fn(v):
        kernel, strides, pads = _grid(v, nd, kernel_size, stride, padding,
                                      ceil_mode)
        if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel)):
            return _MAX[nd](v, kernel, strides, tuple(lo for lo, _ in pads))
        return _MAX[nd](_pad(v, pads, -math.inf), kernel, strides)
    return _channels_first(fn, x, data_format)


def _avg_pool(x, nd, kernel_size, stride, padding, ceil_mode, exclusive,
              divisor_override, data_format):
    def fn(v):
        kernel, strides, pads = _grid(v, nd, kernel_size, stride, padding,
                                      ceil_mode)
        k = math.prod(kernel)
        total = _AVG[nd](_pad(v, pads, 0.0), kernel, strides) * k
        if exclusive and divisor_override is None:
            inside = _pad(torch.ones_like(v[:1, :1]), pads, 0.0)
            return total / (_AVG[nd](inside, kernel, strides) * k)
        return total / (k if divisor_override is None else divisor_override)
    return _channels_first(fn, x, data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL"):
    return _max_pool(x, 1, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW"):
    """Max over each window, the padding at -inf; ``ceil_mode`` keeps a
    last window that runs past the high padding."""
    return _max_pool(x, 2, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW"):
    return _max_pool(x, 3, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL"):
    return _avg_pool(x, 1, kernel_size, stride, padding, ceil_mode,
                     exclusive, None, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    """Mean over each window: ``exclusive`` divides by the positions that
    lie in the input, else by the window's size (or
    ``divisor_override``)."""
    return _avg_pool(x, 2, kernel_size, stride, padding, ceil_mode,
                     exclusive, divisor_override, data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW"):
    return _avg_pool(x, 3, kernel_size, stride, padding, ceil_mode,
                     exclusive, divisor_override, data_format)


def _adaptive_size(output_size, nd, spatial):
    sizes = _tuple(output_size, nd) if not isinstance(
        output_size, (list, tuple)) else tuple(output_size)
    return tuple(n if s is None else s for s, n in zip(sizes, spatial))


def _adaptive_avg(x, nd, output_size, data_format):
    def fn(v):
        return _ADAPTIVE_AVG[nd](v, _adaptive_size(output_size, nd,
                                                    v.shape[2:]))
    return _channels_first(fn, x, data_format)


def adaptive_avg_pool1d(x, output_size):
    """Window i of n outputs spans [floor(i L / n), ceil((i + 1) L / n))."""
    return _adaptive_avg(x, 1, output_size, "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive_avg(x, 2, output_size, data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return _adaptive_avg(x, 3, output_size, data_format)
