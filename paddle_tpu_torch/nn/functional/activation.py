"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``).

The in-place forms (``relu_``, ``elu_``, ``softmax_``, ``tanh_``) write
the result into x and return x, as the reference's ``_inplace_assign``
does. ``rrelu`` in training and ``gumbel_softmax`` draw from the global
key (:func:`paddle_tpu_torch.framework.state.next_key`) the reference's
bits: ``jax.random.uniform`` and ``jax.random.gumbel`` of the same key.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.amp.auto_cast import downcast_inputs
from paddle_tpu_torch.framework import random as threefry
from paddle_tpu_torch.framework.state import next_key

__all__ = ["celu", "elu", "elu_", "gelu", "glu", "gumbel_softmax",
           "hardshrink", "hardsigmoid", "hardswish", "hardtanh",
           "leaky_relu", "log_sigmoid", "log_softmax", "maxout", "mish",
           "prelu", "relu", "relu6", "relu_", "rrelu", "selu", "sigmoid",
           "silu", "softmax", "softmax_", "softplus", "softshrink",
           "softsign", "swish", "tanh", "tanh_", "tanhshrink",
           "thresholded_relu"]


def _inplace(x, out):
    with torch.no_grad():
        x.copy_(out)
    return x


def _scalar(value, x):
    """A Python float as a 0-d tensor of x's type on x's device: the
    reference's weak scalar, rounded to x's type before the op."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def relu(x):
    return torch.relu(x)


def relu_(x):
    return _inplace(x, relu(x))


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def elu(x, alpha=1.0):
    return torch.nn.functional.elu(x, alpha)


def elu_(x, alpha=1.0):
    return _inplace(x, elu(x, alpha))


def celu(x, alpha=1.0):
    return torch.nn.functional.celu(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    """``scale * (x if x > 0 else alpha * expm1(x))`` with the given
    constants (torch's ``selu`` fixes them)."""
    return _scalar(scale, x) * torch.where(
        x > 0, x, _scalar(alpha, x) * torch.expm1(x))


def leaky_relu(x, negative_slope=0.01):
    return torch.nn.functional.leaky_relu(x, negative_slope)


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form
    ``0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def sigmoid(x):
    return torch.sigmoid(x)


def hardsigmoid(x, slope=0.1666667, offset=0.5):
    """``clip(slope * x + offset, 0, 1)`` (Paddle's slope, not torch's
    1/6)."""
    return torch.clamp(_scalar(slope, x) * x + _scalar(offset, x), 0.0, 1.0)


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0):  # noqa: A002 (the reference's names)
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def tanhshrink(x):
    return x - torch.tanh(x)


def prelu(x, weight, data_format="NCHW"):
    """``x if x >= 0 else w * x``: one weight for every element, or one
    per channel (axis 1 for ``"NC..."``, the last for ``"N...C"``)."""
    if weight.numel() == 1:
        w = weight.reshape(())
    else:
        shape = [1] * x.dim()
        shape[1 if data_format[1] == "C" else x.dim() - 1] = weight.numel()
        w = weight.reshape(shape)
    return torch.where(x >= 0, x, w * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False):
    """``x if x >= 0 else a * x``: in training ``a`` is
    ``jax.random.uniform(next_key(), x.shape, f32, lower, upper)`` (cast
    to x's type), else ``(lower + upper) / 2``."""
    if training:
        n = x.numel()
        u = threefry.uniform01(threefry.random_bits(
            threefry.key_words(next_key(x.device)), n)).reshape(x.shape)
        lo = torch.full((), lower, dtype=torch.float32, device=x.device)
        hi = torch.full((), upper, dtype=torch.float32, device=x.device)
        a = torch.maximum(lo, u * (hi - lo) + lo).to(x.dtype)
    else:
        a = _scalar((lower + upper) / 2.0, x)
    return torch.where(x >= 0, x, a * x)


def log_sigmoid(x):
    return torch.nn.functional.logsigmoid(x)


def maxout(x, groups, axis=1):
    """The largest of each run of ``C / groups`` channels along
    ``axis``, reshaped as the reference's ``(groups, C // groups)``."""
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (groups, c // groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(dim=ax)


def softmax(x, axis=-1, dtype=None):
    """Softmax along ``axis``, in ``dtype`` when given; else under
    autocast a narrow-float input is raised to f32 first (``softmax`` is
    on the reference's black list)."""
    if dtype is not None:
        x = x.to(dtype)
    else:
        (x,) = downcast_inputs(x, opname="softmax")
    return torch.softmax(x, dim=axis)


def softmax_(x, axis=-1, dtype=None):
    return _inplace(x, softmax(x, axis, dtype))


def log_softmax(x, axis=-1, dtype=None):
    """Log-softmax along ``axis``, with ``dtype`` and autocast as
    :func:`softmax` (``log_softmax`` is on the black list)."""
    if dtype is not None:
        x = x.to(dtype)
    else:
        (x,) = downcast_inputs(x, opname="log_softmax")
    return torch.log_softmax(x, dim=axis)


def softplus(x, beta=1, threshold=20):
    """``log1p(exp(beta x)) / beta``, and x itself where ``beta x``
    passes ``threshold``."""
    inner = torch.log1p(torch.exp(beta * torch.clamp_max(
        x, threshold / beta))) / beta
    return torch.where(beta * x > threshold, x, inner)


def softsign(x):
    return x / (1 + x.abs())


def swish(x):
    return torch.nn.functional.silu(x)


silu = swish


def mish(x):
    return x * torch.tanh(torch.nn.functional.softplus(x))


def tanh(x):
    return torch.tanh(x)


def tanh_(x):
    return _inplace(x, tanh(x))


def thresholded_relu(x, threshold=1.0, value=0.0):
    return torch.where(x > threshold, x, _scalar(value, x))


def glu(x, axis=-1):
    a, b = x.chunk(2, dim=axis)
    return a * torch.sigmoid(b)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    """``softmax((x + g) / temperature)`` with ``g`` the reference's
    noise, ``jax.random.gumbel(next_key(), x.shape)``: its bits exactly,
    both logs correctly rounded (:func:`paddle_tpu_torch.serving.sampler.
    gumbel`), drawn in f32 and cast to x's type. ``hard`` returns the
    one-hot of the largest entry with the soft gradient (straight
    through)."""
    from paddle_tpu_torch.serving.sampler import gumbel
    g = gumbel(threefry.key_words(next_key(x.device)),
               x.numel()).reshape(x.shape).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        index = y.argmax(dim=axis, keepdim=True)
        one_hot = torch.zeros_like(y).scatter_(axis, index, 1.0)
        y = y + (one_hot - y).detach()
    return y
