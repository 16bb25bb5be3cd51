"""Container layers (counterpart of ``paddle_tpu/nn/layer/container.py``),
on torch's containers, so their children's state-dict keys carry the
same indices as the reference's (``layer1.0.conv1.weight``)."""
from __future__ import annotations

from collections import OrderedDict

from torch import nn

__all__ = ["LayerDict", "LayerList", "ParameterList", "Sequential"]


class Sequential(nn.Sequential):
    """Layers called in order: ``Sequential(a, b)`` keys them ``0``,
    ``1``; ``Sequential(("x", a), ("y", b))`` or
    ``Sequential([("x", a), ("y", b)])`` by those names."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) \
                and layers[0] and isinstance(layers[0][0], tuple):
            layers = (OrderedDict(layers[0]),)
        elif layers and isinstance(layers[0], tuple):
            layers = (OrderedDict(layers),)
        super().__init__(*layers)


class LayerList(nn.ModuleList):
    """A list of layers keyed ``0``, ``1``, ...; not callable."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class LayerDict(nn.ModuleDict):
    """Layers by name (a dict or ``(name, layer)`` pairs)."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class ParameterList(nn.ParameterList):
    """Parameters keyed ``0``, ``1``, ..."""

    def __init__(self, parameters=None):
        super().__init__(parameters)
