"""Convolutions (counterpart of ``paddle_tpu/nn/functional/conv.py``).

The reference lowers every conv to one ``lax.conv_general_dilated``
(XLA's, not a Pallas kernel); here it is ``torch.nn.functional.conv*d``
(cuDNN on the card). Paddle's forms are kept: the weight is ``[out,
in / groups, *kernel]`` whatever the data format, padding is an int,
per-dim ints, per-dim ``(lo, hi)`` pairs (flat or nested, nested ones
possibly carrying the batch and channel dims), or ``"SAME"`` /
``"VALID"`` as ``lax`` reads them (``"SAME"`` pads ``total // 2`` low and
the rest high, so with stride > 1 it may be asymmetric, which torch's own
``padding="same"`` refuses), and under autocast the inputs go through
:func:`~paddle_tpu_torch.amp.auto_cast.downcast_inputs` as ``conv{n}d``.
A channels-last input (``NHWC``) is handed to torch as its NCHW view,
which is torch's ``channels_last`` layout, so cuDNN runs its NHWC
kernels on it without a copy. The bias is added after the product in the
product's type, as the reference adds it.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.amp.auto_cast import downcast_inputs

__all__ = ["conv1d", "conv2d", "conv3d"]

_CONV = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
         3: torch.nn.functional.conv3d}


def _tuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    t = tuple(int(x) for x in v)
    return t * n if len(t) == 1 else t


def _padding(padding, n, data_format):
    """Paddle's padding forms as ``"SAME"``, ``"VALID"`` or ``(lo, hi)``
    pairs, one a spatial dim (``paddle_tpu/nn/functional/conv.py:24``).
    Nested pairs are read before flat ones: the reference reads a 2-D
    conv's four nested pairs (N, C and the two spatial dims) as a flat
    list and fails on them."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (int, np.integer)):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if padding and all(isinstance(p, (list, tuple)) for p in padding):
        pads = [tuple(int(q) for q in p) for p in padding]
        if len(pads) == n:
            return pads
        if len(pads) == n + 2:
            return pads[2:] if data_format.startswith("NC") else pads[1:-1]
    elif len(padding) == n:
        return [(int(p), int(p)) for p in padding]
    elif len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    raise ValueError(f"bad padding {padding!r}")


def _same_pads(sizes, kernel, stride, dilation):
    """``lax``'s ``"SAME"``: the output is ceil(size / stride), the total
    padding that takes split ``total // 2`` low, the rest high."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, stride, dilation):
        eff = d * (k - 1) + 1
        total = max((-(-n // s) - 1) * s + eff - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _conv(x, weight, bias, stride, padding, dilation, groups, nd,
          data_format):
    channel_last = not data_format.startswith("NC")
    stride, dilation = _tuple(stride, nd), _tuple(dilation, nd)
    v, w = downcast_inputs(x, weight, opname=f"conv{nd}d")
    if channel_last:
        v = v.movedim(-1, 1)
    pads = _padding(padding, nd, data_format)
    if pads == "VALID":
        pads = [(0, 0)] * nd
    elif pads == "SAME":
        pads = _same_pads(v.shape[2:], w.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        v = torch.nn.functional.pad(v, flat)
        sym = 0
    out = _CONV[nd](v, w, None, stride, sym, dilation, groups)
    if bias is not None:
        out = out + bias.to(out.dtype).reshape((1, -1) + (1,) * nd)
    return out.movedim(1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    df = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1, df)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)
