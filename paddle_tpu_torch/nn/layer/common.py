"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``).

Weights keep the reference's layout and names: Linear holds
``weight [in, out]`` and ``bias [out]``, Embedding ``weight
[num, dim]``. Weights are drawn from ``Normal(0, std)`` with an explicit
``torch.Generator``; biases start at zero. Dropout draws from the global
key (:mod:`paddle_tpu_torch.framework.state`), as the reference's does.
"""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F

__all__ = ["AlphaDropout", "Bilinear", "CosineSimilarity", "Dropout",
           "Dropout2D", "Dropout3D", "Embedding", "Flatten", "Fold",
           "Identity", "Linear", "Pad1D", "Pad2D", "Pad3D", "Unflatten",
           "Unfold", "Upsample", "UpsamplingBilinear2D",
           "UpsamplingNearest2D", "ZeroPad2D", "normal_parameter"]


def module_generator(generator, device=None):
    """``generator``, or where it is None a fresh one seeded 0 on
    ``device``, for a module to thread through all its parameters so that
    no two of them start equal."""
    if generator is None:
        generator = torch.Generator(
            device=torch.empty(0, device=device).device).manual_seed(0)
    return generator


def _drawn_parameter(shape, device, dtype, generator, draw):
    t = torch.empty(shape, device=device, dtype=dtype)
    with torch.no_grad():
        draw(t, module_generator(generator, t.device))
    return nn.Parameter(t)


def normal_parameter(shape, std, device=None, dtype=None, generator=None):
    """A parameter drawn from Normal(0, std); ``generator`` must live on
    ``device`` (None: a fresh one seeded 0)."""
    return _drawn_parameter(shape, device, dtype, generator,
                            lambda t, g: t.normal_(0.0, std, generator=g))


def uniform_parameter(shape, bound, device=None, dtype=None,
                      generator=None):
    """A parameter drawn from Uniform(-bound, bound), as
    :func:`normal_parameter`."""
    return _drawn_parameter(
        shape, device, dtype, generator,
        lambda t, g: t.uniform_(-bound, bound, generator=g))


class Linear(nn.Module):
    def __init__(self, in_features, out_features, std=0.02, has_bias=True,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.weight = normal_parameter((in_features, out_features), std,
                                       device, dtype, generator)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if has_bias else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, std=0.02, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.weight = normal_parameter((num_embeddings, embedding_dim), std,
                                       device, dtype, generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class Dropout(nn.Module):
    """Dropout (see :func:`paddle_tpu_torch.nn.functional.dropout`): its
    masks come from the global key. A no-op in eval mode, which is how
    serving runs it."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self.p = float(p)
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, self.axis, self.training, self.mode)


class Dropout2D(nn.Module):
    """Drops whole channels (:func:`paddle_tpu_torch.nn.functional.
    dropout2d`)."""

    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(nn.Module):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(nn.Module):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Identity(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, input):
        return input


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Unflatten(nn.Module):
    """Axis ``axis`` of x reshaped to ``shape``."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = shape

    def forward(self, x):
        s = list(x.shape)
        return x.reshape(s[:self.axis] + list(self.shape)
                         + s[self.axis + 1:])


class Upsample(nn.Module):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(nn.Module):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, "nearest",
                             data_format=self.data_format)


class UpsamplingBilinear2D(nn.Module):
    """Bilinear with ``align_corners=True``, as the reference's."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, "bilinear",
                             align_corners=True,
                             data_format=self.data_format)


def param_attrs(layer, **attrs):
    """Paddle's ParamAttr arguments of ``layer``: each may be None, True
    or False (Paddle's ``bias_attr=False`` means no bias); any other
    ParamAttr comes with ``nn/initializer.py`` (ROADMAP A.7). Returns
    whether the layer keeps a bias: not with ``bias_attr=False``."""
    for name, attr in attrs.items():
        if attr not in (None, True, False):
            raise NotImplementedError(
                f"{layer}: {name}={attr!r}: ParamAttr comes with "
                f"nn/initializer.py (ROADMAP A.7)")
    return attrs.get("bias_attr") is not False


class Bilinear(nn.Module):
    """``weight [out, in1, in2]`` drawn from Normal(0, 1/sqrt(in1)) and
    ``bias [1, out]`` (zeros, none with ``bias_attr=False``)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, device=None,
                 dtype=None, generator=None):
        super().__init__()
        bias = param_attrs("Bilinear", weight_attr=weight_attr,
                           bias_attr=bias_attr)
        self.weight = normal_parameter(
            (out_features, in1_features, in2_features),
            in1_features ** -0.5, device, dtype, generator)
        self.bias = nn.Parameter(torch.zeros(
            1, out_features, device=device, dtype=dtype)) if bias else None

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class _PadNd(nn.Module):
    _spatial = 2
    _format = "NCHW"

    def __init__(self, padding, mode="constant", value=0.0, data_format=None,
                 name=None):
        super().__init__()
        self.padding = list(padding) if isinstance(padding, (list, tuple)) \
            else [padding] * (2 * self._spatial)
        self.mode = mode
        self.value = value
        self.data_format = data_format or self._format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad1D(_PadNd):
    _spatial = 1
    _format = "NCL"


class Pad2D(_PadNd):
    pass


class Pad3D(_PadNd):
    _spatial = 3
    _format = "NCDHW"


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(nn.Module):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Unfold(nn.Module):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Fold(nn.Module):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes, self.strides,
                      self.paddings, self.dilations)
