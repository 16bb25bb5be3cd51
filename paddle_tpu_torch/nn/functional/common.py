"""Common functionals (counterpart of
``paddle_tpu/nn/functional/common.py``)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.amp.auto_cast import downcast_inputs
from paddle_tpu_torch.framework.state import key_tensor
from paddle_tpu_torch.ops.cuda import random as _random

__all__ = ["alpha_dropout", "dropout", "dropout2d", "dropout3d", "linear",
           "matmul"]


def linear(x, weight, bias=None):
    """``y = x @ W + b`` with W laid out ``[in, out]``, as in the
    reference. Under autocast an f32 master weight is cast to the
    activation's bf16 for the product, and its gradients (and the
    bias's) come back accumulated in f32."""
    x2, w2 = downcast_inputs(x, weight, opname="linear")
    if _is_master_downcast(x2, w2, weight):
        if bias is not None:
            return _LinearMaster.apply(x2, weight, bias, w2)
        return _MatmulMaster.apply(x2, weight, False, w2)
    return torch.nn.functional.linear(x2, w2.t(), bias)


def matmul(x, y, transpose_y=False):
    """``x @ y`` (``x @ y^T`` with ``transpose_y``); under autocast an f32
    master ``y`` takes the same wide-gradient path as :func:`linear`."""
    x2, y2 = downcast_inputs(x, y, opname="matmul")
    if _is_master_downcast(x2, y2, y):
        return _MatmulMaster.apply(x2, y, transpose_y, y2)
    return torch.matmul(x2, y2.transpose(-1, -2) if transpose_y else y2)


def _is_master_downcast(a2, w2, w):
    """True when autocast narrowed an f32 master weight for a product
    with an activation of the same narrow type: the one predicate that
    selects the wide-gradient path (``_is_master_downcast`` in the
    reference)."""
    return (w2.dtype != w.dtype
            and w2.dtype in (torch.bfloat16, torch.float16)
            and a2.dtype == w2.dtype
            and w.dim() == 2 and a2.dim() >= 2)


def _mm_f32(a, b):
    """``a @ b`` of two narrow-float matrices, accumulated and returned in
    f32: one bf16 GEMM with an f32 output on CUDA, the same products on
    upcast operands on the CPU."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _LinearMaster(torch.autograd.Function):
    """``_linear_master``: the product runs on ``wc``, the master W
    already cast to the activation type (by autocast), and b cast to it;
    da stays in that type, dw and db accumulate and land in f32 on the
    masters."""

    @staticmethod
    def forward(ctx, a, w, b, wc):
        ctx.save_for_backward(a, wc)
        return torch.nn.functional.linear(a, wc.t(), b.to(a.dtype))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, wc = ctx.saved_tensors
        a2 = a.reshape(-1, a.shape[-1])
        g2 = g.reshape(-1, g.shape[-1])
        da = torch.matmul(g, wc.t())
        dw = _mm_f32(a2.t(), g2)
        db = g2.sum(dim=0, dtype=torch.float32)
        return da, dw, db, None


class _MatmulMaster(torch.autograd.Function):
    """``_mm_master``: ``a @ W`` (``a @ W^T`` with ``trans_y``, the tied
    LM head) on ``wc``, W cast to the activation type; dw lands in f32."""

    @staticmethod
    def forward(ctx, a, w, trans_y, wc):
        ctx.save_for_backward(a, wc)
        ctx.trans_y = trans_y
        return torch.matmul(a, wc.t() if trans_y else wc)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, wc = ctx.saved_tensors
        a2 = a.reshape(-1, a.shape[-1])
        g2 = g.reshape(-1, g.shape[-1])
        if ctx.trans_y:                          # y = a @ W^T, W [n, k]
            return torch.matmul(g, wc), _mm_f32(g2.t(), a2), None, None
        return torch.matmul(g, wc.t()), _mm_f32(a2.t(), g2), None, None


def _keep(shape, keep_prob, dtype, device):
    """One draw of the global key (:func:`~paddle_tpu_torch.framework.
    state.next_key`'s split): ``bernoulli(sub, keep_prob, shape)`` as 1/0
    in ``dtype``, by the keep-mask kernel on CUDA."""
    with torch.no_grad():
        return _random.keep_mask(key_tensor(device), keep_prob, shape,
                                 dtype)[0]


def _scalar(value, x):
    """A Python float as a 0-d tensor of x's type on x's device (filled
    there: no host copy, so a capture takes it): the reference's weak
    scalar, rounded to x's type before the op."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train"):
    """Paddle's dropout with the reference's masks: ``keep =
    bernoulli(next_key(), 1 - p)`` over x's shape, or over the dims in
    ``axis`` (the mask broadcast along the others). ``"upscale_in_train"``
    returns ``x * keep / (1 - p)`` in training and x otherwise;
    ``"downscale_in_infer"`` returns ``x * keep`` in training and ``x *
    (1 - p)`` otherwise."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer', got {mode!r}")
    if not training or p == 0.0:
        return x if mode == "upscale_in_train" else x * _scalar(1.0 - p, x)
    if axis is None:
        shape = tuple(x.shape)
    else:
        axes = {a % x.dim() for a in ((axis,) if isinstance(axis, int)
                                      else axis)}
        shape = tuple(n if i in axes else 1 for i, n in enumerate(x.shape))
    keep = _keep(shape, 1.0 - p, x.dtype, x.device)
    if mode == "upscale_in_train":
        return x * keep / _scalar(1.0 - p, x)
    return x * keep


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    """Drops whole channels of ``[N, C, H, W]`` (or NHWC) maps."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW"):
    """Drops whole channels of ``[N, C, D, H, W]`` (or NDHWC) volumes."""
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True):
    """SELU's dropout: dropped elements take SELU's negative saturation,
    and an affine map keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    a = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    keep = _keep(tuple(x.shape), 1.0 - p, torch.bool, x.device)
    return _scalar(a, x) * torch.where(keep, x, _scalar(alpha_p, x)) \
        + _scalar(b, x)
