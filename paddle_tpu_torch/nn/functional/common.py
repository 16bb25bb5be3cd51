"""Common functionals (counterpart of
``paddle_tpu/nn/functional/common.py``)."""
from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.amp.auto_cast import downcast_inputs
from paddle_tpu_torch.framework.state import _rng, key_tensor
from paddle_tpu_torch.ops.cuda import random as _random

__all__ = ["alpha_dropout", "bilinear", "class_center_sample",
           "cosine_similarity", "dropout", "dropout2d", "dropout3d", "fold",
           "interpolate", "label_smooth", "linear", "matmul", "pad",
           "unfold", "upsample", "zeropad2d"]


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


# ------------------------------------------------------------ padding
def _pad_widths(nd, pad, data_format):
    """Per-dim ``(before, after)``: ``2 * nd`` values are pairs for
    every dim, first dim first; fewer are pairs for the spatial dims,
    last spatial dim first (torch's order), the spatial dims after N and
    C for ``"NC..."`` formats and between N and C otherwise."""
    if len(pad) == 2 * nd:
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    widths = [(0, 0)] * nd
    spatial = list(range(2, nd)) if data_format.startswith("NC") \
        else list(range(1, nd - 1))
    for i in range(len(pad) // 2):
        widths[spatial[len(spatial) - 1 - i]] = (pad[2 * i], pad[2 * i + 1])
    return widths


def _source_index(n, lo, hi, mode, device):
    """Indices into a dim of ``n`` that ``np.pad`` reads for each output
    position: ``reflect`` mirrors without repeating the edge,
    ``replicate`` repeats it, ``circular`` wraps."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate" or (mode == "reflect" and n == 1):
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i.remainder(n)
    if mode != "reflect":
        raise ValueError(f"pad mode must be constant, reflect, replicate "
                         f"or circular, got {mode!r}")
    period = 2 * (n - 1)
    j = i.remainder(period)
    return torch.where(j >= n, period - j, j)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    """``np.pad`` of x (``mode`` ``"constant"`` with ``value``,
    ``"reflect"``, ``"replicate"``, ``"circular"``) by the widths ``pad``
    lists (see :func:`_pad_widths`); a tensor ``pad`` is read on the
    host."""
    if isinstance(pad, torch.Tensor):
        pad = pad.reshape(-1).tolist()
    widths = _pad_widths(x.dim(), [int(p) for p in pad], data_format)
    if mode == "constant":
        flat = []
        for lo, hi in reversed(widths):
            flat += [lo, hi]
        return torch.nn.functional.pad(x, flat, value=value)
    for d, (lo, hi) in enumerate(widths):
        if lo or hi:
            x = x.index_select(d, _source_index(x.shape[d], lo, hi, mode,
                                                x.device))
    return x


def zeropad2d(x, padding, data_format="NCHW"):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


# ------------------------------------------------------- similarities
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """``sum(x1 x2) / max(|x1| |x2|, eps)`` along ``axis``."""
    dot = (x1 * x2).sum(dim=axis)
    n1 = torch.sqrt((x1 * x1).sum(dim=axis))
    n2 = torch.sqrt((x2 * x2).sum(dim=axis))
    return dot / torch.clamp_min(n1 * n2, eps)


def bilinear(x1, x2, weight, bias=None):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] (+ bias)``; weight
    ``[out, in1, in2]``, bias ``[1, out]``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def label_smooth(label, prior_dist=None, epsilon=0.1):
    """``(1 - epsilon) label + epsilon / K`` over the last axis of K
    classes, or ``+ epsilon prior_dist``."""
    if prior_dist is None:
        return (1.0 - epsilon) * label + epsilon / label.shape[-1]
    return (1.0 - epsilon) * label + epsilon * prior_dist


# ------------------------------------------------------ unfold / fold
def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _pads4(p):
    p = (p,) * 4 if isinstance(p, int) else tuple(p)
    return (p[0], p[0], p[1], p[1]) if len(p) == 2 else p


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col of ``[N, C, H, W]``: ``[N, C kh kw, L]``, the patches in
    the reference's order (channel, kernel row, kernel column).
    ``paddings`` of four are (top, left, bottom, right)."""
    ks, st, dl = _pair(kernel_sizes), _pair(strides), _pair(dilations)
    pd = _pads4(paddings)
    n, c = x.shape[:2]
    x = torch.nn.functional.pad(x, (pd[1], pd[3], pd[0], pd[2]))
    oh = (x.shape[2] - (dl[0] * (ks[0] - 1) + 1)) // st[0] + 1
    ow = (x.shape[3] - (dl[1] * (ks[1] - 1) + 1)) // st[1] + 1
    patches = [x[:, :, i * dl[0]: i * dl[0] + oh * st[0]: st[0],
                 j * dl[1]: j * dl[1] + ow * st[1]: st[1]]
               for i in range(ks[0]) for j in range(ks[1])]
    return torch.stack(patches, dim=2).reshape(n, c * ks[0] * ks[1],
                                               oh * ow)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    """col2im, :func:`unfold`'s adjoint: ``[N, C kh kw, L]`` summed into
    ``[N, C, H, W]``."""
    os_, ks = _pair(output_sizes), _pair(kernel_sizes)
    st, dl, pd = _pair(strides), _pair(dilations), _pads4(paddings)
    n, ckk, _ = x.shape
    c = ckk // (ks[0] * ks[1])
    ph, pw = os_[0] + pd[0] + pd[2], os_[1] + pd[1] + pd[3]
    oh = (ph - (dl[0] * (ks[0] - 1) + 1)) // st[0] + 1
    ow = (pw - (dl[1] * (ks[1] - 1) + 1)) // st[1] + 1
    x = x.reshape(n, c, ks[0], ks[1], oh, ow)
    out = x.new_zeros((n, c, ph, pw))
    for i in range(ks[0]):
        for j in range(ks[1]):
            rows = slice(i * dl[0], i * dl[0] + oh * st[0], st[0])
            cols = slice(j * dl[1], j * dl[1] + ow * st[1], st[1])
            out[:, :, rows, cols] = out[:, :, rows, cols] + x[:, :, i, j]
    return out[:, :, pd[0]: ph - pd[2], pd[1]: pw - pd[3]]


# -------------------------------------------------------- interpolate
_RESIZE = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
           "trilinear": "linear", "bicubic": "cubic", "area": "linear"}


def _f32(v, device):
    return torch.full((), v, dtype=torch.float32, device=device)


def _triangle(x):
    return torch.clamp_min(1.0 - x, 0.0)


def _keys_cubic(x):
    """The Keys cubic kernel at a = -0.5 (``jax.image``'s)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in, n_out, kernel, device):
    """``jax.image.scale_and_translate``'s ``[n_in, n_out]`` weights at
    scale ``n_out / n_in`` (half-pixel centres), antialiased: the kernel
    is widened by the scale when downsampling; f32 throughout."""
    inv = _f32(1.0 / (n_out / n_in), device)
    kscale = torch.clamp_min(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                           device=device)[:, None]).abs()
    w = kernel(dist / kscale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _linspace(start, stop, num, device):
    """``jnp.linspace`` in f32: ``start (1 - t) + stop t`` for ``t =
    i / (num - 1)``, the last point exactly ``stop``."""
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    t = torch.arange(num - 1, dtype=torch.float32, device=device) \
        / _f32(num - 1, device)
    body = _f32(start, device) * (1 - t) + _f32(stop, device) * t
    return torch.cat([body, _f32(stop, device).reshape(1)])


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW"):
    """Resize the spatial dims of x (``"NC..."`` or ``"N...C"``) to
    ``size`` or ``floor(dim * scale_factor)``, as the reference does:
    ``"nearest"`` takes ``floor(i * in / out)``; the linear and cubic
    modes with ``align_corners`` interpolate linearly between the corners
    (cubic too); otherwise they are ``jax.image.resize`` (half-pixel
    centres, antialiased when downsampling, the Keys cubic at a = -0.5;
    ``"area"`` is linear). ``align_mode`` is read by neither."""
    if isinstance(size, torch.Tensor):
        size = [int(s) for s in size.reshape(-1).tolist()]
    elif size is not None and not isinstance(size, (list, tuple)):
        size = [int(size)]
    if isinstance(scale_factor, torch.Tensor):
        scale_factor = [float(s) for s in scale_factor.reshape(-1).tolist()]
    chan_last = not data_format.startswith("NC")
    nd = x.dim() - 2
    axes = list(range(1, 1 + nd)) if chan_last else list(range(2, 2 + nd))
    spatial = [x.shape[a] for a in axes]
    if size is not None:
        out_spatial = [int(s) for s in size]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * nd
        out_spatial = [int(math.floor(s * f)) for s, f in zip(spatial, sf)]
    method = _RESIZE[mode.lower()]
    dev = x.device
    if method == "nearest":
        for a, si, so in zip(axes, spatial, out_spatial):
            ind = torch.floor(torch.arange(so, dtype=torch.float32,
                                           device=dev) * _f32(si / so, dev))
            x = x.index_select(a, ind.to(torch.int64).clamp(0, si - 1))
        return x
    if align_corners:
        for a, si, so in zip(axes, spatial, out_spatial):
            pos = _linspace(0.0, si - 1.0, so, dev)
            lo = torch.floor(pos).to(torch.int64)
            hi = (lo + 1).clamp(0, si - 1)
            shape = [1] * x.dim()
            shape[a] = so
            w = (pos - lo.float()).to(x.dtype).reshape(shape)
            x = x.index_select(a, lo) * (1 - w) + x.index_select(a, hi) * w
        return x
    if not x.is_floating_point():
        x = x.float()
    kernel = _triangle if method == "linear" else _keys_cubic
    for a, si, so in zip(axes, spatial, out_spatial):
        if si == so:
            continue
        w = _resize_weights(si, so, kernel, dev).to(x.dtype)
        x = torch.tensordot(x, w, dims=([a], [0])).movedim(-1, a)
    return x


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW"):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


# ------------------------------------------------------ class centres
def class_center_sample(label, num_classes, num_samples, group=None,
                        rank=None, nranks=None, seed=None):
    """PartialFC's class-centre sampling, host-side as the reference's
    (``paddle_tpu/nn/functional/common.py:class_center_sample``): every
    positive centre of this rank's ``num_classes`` (sorted), topped up
    with negatives drawn by numpy's ``default_rng(seed + 7919 r)`` up to
    ``num_samples``, and the labels remapped into the concatenated
    sampled space of the ``nranks`` ranks. Returns this rank's
    ``(remapped_label, sampled_class_center)``, int64 on the label's
    device. ``seed`` defaults to the global seed."""
    if num_samples > num_classes:
        raise ValueError(f"num_samples ({num_samples}) must be <= "
                         f"num_classes ({num_classes})")
    device = label.device if isinstance(label, torch.Tensor) else None
    y = np.asarray(label.detach().cpu().numpy()
                   if isinstance(label, torch.Tensor) else label)
    y = y.reshape(-1).astype(np.int64)
    if group is False:
        nranks, rank = 1, 0
    if nranks is None:
        nranks = getattr(group, "nranks", 1) if group is not None else 1
    if rank is None:
        rank = getattr(group, "rank", 0) if group is not None else 0
    if seed is None:
        seed = _rng.seed_val
    total = nranks * num_classes
    if y.size and (y.min() < 0 or y.max() >= total):
        raise ValueError(
            f"class_center_sample: labels must lie in [0, {total}) "
            f"(nranks*num_classes); got range [{int(y.min())}, "
            f"{int(y.max())}]")
    per_rank, remap, base = [], {}, 0
    for r in range(nranks):
        lo, hi = r * num_classes, (r + 1) * num_classes
        pos = np.unique(y[(y >= lo) & (y < hi)]) - lo
        rng = np.random.default_rng(np.uint64(seed) + np.uint64(r) * 7919)
        chosen = set(pos.tolist())
        sampled = list(pos)
        while len(chosen) < num_samples:
            neg = int(rng.integers(0, num_classes))
            if neg not in chosen:
                chosen.add(neg)
                sampled.append(neg)
        for i, cls in enumerate(sampled):
            remap[cls + lo] = base + i
        per_rank.append(np.asarray(sampled, dtype=np.int64))
        base += len(sampled)
    remapped = np.asarray([remap[int(v)] for v in y], dtype=np.int64)
    return (torch.from_numpy(remapped).to(device),
            torch.from_numpy(per_rank[rank]).to(device))
