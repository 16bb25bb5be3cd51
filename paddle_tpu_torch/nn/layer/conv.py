"""Convolution layers (counterpart of ``paddle_tpu/nn/layer/conv.py``).

``weight`` is ``[out, in / groups, *kernel]`` in every data format and
``bias`` ``[out]``, the reference's names and layouts. The weight is
drawn from the reference's MSRA normal, ``Normal(0, sqrt(2 / fan_in))``
with ``fan_in = in / groups * prod(kernel)``, with an explicit
``torch.Generator``; the bias starts at zero, and ``bias_attr=False``
leaves it out. The transposed convolutions are not ported yet.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from paddle_tpu_torch.nn.functional import conv as F_conv
from paddle_tpu_torch.nn.functional.conv import _tuple
from paddle_tpu_torch.nn.layer.common import normal_parameter

__all__ = ["Conv1D", "Conv2D", "Conv3D"]


class _ConvNd(nn.Module):
    _nd = 2
    _fn = staticmethod(F_conv.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, dtype=None, generator=None):
        super().__init__()
        if padding_mode != "zeros" or weight_attr is not None:
            raise NotImplementedError(
                "Conv: only padding_mode='zeros' and the default weight "
                "initializer are ported")
        nd = self._nd
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _tuple(kernel_size, nd)
        self._stride = _tuple(stride, nd)
        self._padding = padding
        self._dilation = _tuple(dilation, nd)
        self._groups = groups
        self._data_format = data_format
        fan_in = in_channels // groups * math.prod(self._kernel_size)
        self.weight = normal_parameter(
            (out_channels, in_channels // groups) + self._kernel_size,
            math.sqrt(2.0 / fan_in), device, dtype, generator)
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(out_channels, device=device, dtype=dtype))

    def forward(self, x):
        return self._fn(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={list(self._stride)}")


class Conv1D(_ConvNd):
    _nd = 1
    _fn = staticmethod(F_conv.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 **factory):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **factory)


class Conv2D(_ConvNd):
    pass


class Conv3D(_ConvNd):
    _nd = 3
    _fn = staticmethod(F_conv.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **factory):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **factory)
