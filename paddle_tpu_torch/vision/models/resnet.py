"""ResNet family (counterpart of ``paddle_tpu/vision/models/resnet.py``).

BasicBlock (18/34), BottleneckBlock (50/101/152) and the wide / ResNeXt
variants, with the reference's module names (``layer1.0.conv1.weight``,
``layer1.0.downsample.1._mean``) and ``data_format`` carried to every
conv, BatchNorm and pool: ``"NHWC"`` trains channels-last end to end,
which cuDNN's NHWC kernels take without a copy. ``remat=True`` (the
reference's recompute of each stage) is not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.core.device import model_factory
from paddle_tpu_torch.nn.layer import (AdaptiveAvgPool2D, BatchNorm2D,
                                       Conv2D, Linear, MaxPool2D, ReLU,
                                       Sequential)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
           "wide_resnet50_2", "wide_resnet101_2"]


def _norm(data_format, factory):
    """BatchNorm2D's keyword arguments: the data format and the device
    and dtype (BatchNorm draws nothing)."""
    return dict(data_format=data_format, device=factory.get("device"),
                dtype=factory.get("dtype"))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", **factory):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        df = dict(data_format=data_format, **factory)
        self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                            bias_attr=False, **df)
        self.bn1 = norm_layer(planes, **_norm(data_format, factory))
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            **df)
        self.bn2 = norm_layer(planes, **_norm(data_format, factory))
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", **factory):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        df = dict(data_format=data_format, **factory)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, **df)
        self.bn1 = norm_layer(width, **_norm(data_format, factory))
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation,
                            bias_attr=False, **df)
        self.bn2 = norm_layer(width, **_norm(data_format, factory))
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, **df)
        self.bn3 = norm_layer(planes * self.expansion,
                              **_norm(data_format, factory))
        self.relu = ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    """``ResNet(block, depth, width, num_classes, with_pool, groups,
    data_format)``, built on ``device`` (default CUDA; RuntimeError
    without it unless ``device="cpu"``), the convs drawn from one
    generator in construction order."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW", remat=False,
                 device=None, dtype=None, generator=None):
        super().__init__()
        if remat:
            raise NotImplementedError(
                "ResNet(remat=True) is not ported yet (ROADMAP A.3: its "
                "BatchNorm buffers' updates through recompute)")
        factory = model_factory(device, dtype, generator)
        self.data_format = data_format
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = BatchNorm2D
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, data_format=data_format,
                            **factory)
        self.bn1 = self._norm_layer(self.inplanes,
                                    **_norm(data_format, factory))
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1,
                                 data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0], factory)
        self.layer2 = self._make_layer(block, 128, layers[1], factory, 2)
        self.layer3 = self._make_layer(block, 256, layers[2], factory, 2)
        self.layer4 = self._make_layer(block, 512, layers[3], factory, 2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1), data_format=data_format)
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, **factory)

    def _make_layer(self, block, planes, blocks, factory, stride=1):
        df = self.data_format
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, data_format=df,
                       **factory),
                self._norm_layer(planes * block.expansion,
                                 **_norm(df, factory)),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, self.dilation,
                        self._norm_layer, data_format=df, **factory)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=self._norm_layer, data_format=df,
                                **factory))
        return Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise ValueError("no pretrained weights: the port loads state dicts "
                         "by name (framework.io.load_numpy_state_dict)")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, groups=32, width=4,
                   **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, groups=32, width=4,
                   **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, groups=64, width=4,
                   **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, groups=64, width=4,
                   **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, groups=32, width=4,
                   **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, groups=64, width=4,
                   **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, width=128, **kwargs)
