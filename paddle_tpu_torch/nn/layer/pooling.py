"""Pooling layers (counterpart of ``paddle_tpu/nn/layer/pooling.py``):
each calls its functional with what it was built with."""
from __future__ import annotations

from torch import nn

from paddle_tpu_torch.nn.functional import pooling as F_pool

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "MaxPool1D", "MaxPool2D", "MaxPool3D"]


class _Pool(nn.Module):
    def __init__(self, kernel_size=None, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kw = kwargs


class MaxPool1D(_Pool):
    def forward(self, x):
        return F_pool.max_pool1d(x, self.kernel_size, self.stride,
                                 self.padding,
                                 self.kw.get("return_mask", False),
                                 self.kw.get("ceil_mode", False))


class MaxPool2D(_Pool):
    def forward(self, x):
        return F_pool.max_pool2d(x, self.kernel_size, self.stride,
                                 self.padding,
                                 self.kw.get("return_mask", False),
                                 self.kw.get("ceil_mode", False),
                                 self.kw.get("data_format", "NCHW"))


class MaxPool3D(_Pool):
    def forward(self, x):
        return F_pool.max_pool3d(x, self.kernel_size, self.stride,
                                 self.padding,
                                 self.kw.get("return_mask", False),
                                 self.kw.get("ceil_mode", False),
                                 self.kw.get("data_format", "NCDHW"))


class AvgPool1D(_Pool):
    def forward(self, x):
        return F_pool.avg_pool1d(x, self.kernel_size, self.stride,
                                 self.padding, self.kw.get("exclusive", True),
                                 self.kw.get("ceil_mode", False))


class AvgPool2D(_Pool):
    def forward(self, x):
        return F_pool.avg_pool2d(x, self.kernel_size, self.stride,
                                 self.padding, self.kw.get("ceil_mode", False),
                                 self.kw.get("exclusive", True),
                                 self.kw.get("divisor_override"),
                                 self.kw.get("data_format", "NCHW"))


class AvgPool3D(_Pool):
    def forward(self, x):
        return F_pool.avg_pool3d(x, self.kernel_size, self.stride,
                                 self.padding, self.kw.get("ceil_mode", False),
                                 self.kw.get("exclusive", True),
                                 self.kw.get("divisor_override"),
                                 self.kw.get("data_format", "NCDHW"))


class _AdaptivePool(nn.Module):
    def __init__(self, output_size, return_mask=False, **kwargs):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask
        self.kw = kwargs


class AdaptiveAvgPool1D(_AdaptivePool):
    def forward(self, x):
        return F_pool.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(_AdaptivePool):
    def forward(self, x):
        return F_pool.adaptive_avg_pool2d(x, self.output_size,
                                          self.kw.get("data_format", "NCHW"))


class AdaptiveAvgPool3D(_AdaptivePool):
    def forward(self, x):
        return F_pool.adaptive_avg_pool3d(x, self.output_size,
                                          self.kw.get("data_format", "NCDHW"))
