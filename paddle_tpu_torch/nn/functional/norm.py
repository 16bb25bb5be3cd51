"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``).

The fused path runs the LayerNorm and RMSNorm kernels of
:mod:`paddle_tpu_torch.ops.cuda.norm` through their autograd Functions
(forward kernel; LayerNorm's backward kernel recomputes the statistics,
RMSNorm's backward is a composition, as the reference's is); it is the
default for a tensor on CUDA, as the Pallas path
is the default on a TPU. A shape or type the kernels do not take
(``ln_kernel_takes``, ``rms_kernel_takes``: a hidden size past their
limit or not a multiple of 8, fp16) goes to the composition before any
launch, whatever ``fused`` says, as the reference's fused path falls back
to its composition; such calls are counted in ``norm.ROUTED``. A kernel
that fails raises: there is no fallback after a launch.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.amp.auto_cast import downcast_inputs
from paddle_tpu_torch.amp.policy import current_policy
from paddle_tpu_torch.ops.cuda import norm as _kernels

__all__ = ["batch_norm", "fused_add_layer_norm", "fused_ln_residual",
           "fused_norm_enabled", "layer_norm", "normalize", "rms_norm",
           "set_fused_norm"]


def normalize(x, p=2, axis=1, epsilon=1e-12):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    norm = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(norm, epsilon)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None):
    """Paddle's batch norm (``paddle_tpu/nn/functional/norm.py:24``) on
    ``torch.nn.functional.batch_norm`` (cuDNN on the card; the reference's
    is XLA's, no Pallas kernel). In training (and not
    ``use_global_stats``) it normalises with the batch's statistics,
    taken in f32 and centred (never as E[x^2] - E[x]^2), and updates the
    running ones in place on their device, so a captured step replays the
    update: ``r = m r + (1 -
    m) b`` with paddle's ``momentum`` m (torch's is ``1 - m``), the
    variance unbiased (``n / (n - 1)``). Otherwise it uses the running
    statistics. The output has x's type; the statistics and the affine
    are f32. ``data_format`` ``"N...C"`` is normalised through its
    channels-first view."""
    use_batch = training and not use_global_stats

    def fn(v):
        return torch.nn.functional.batch_norm(
            v, running_mean, running_var, weight, bias, training=use_batch,
            momentum=1.0 - momentum, eps=epsilon)
    if data_format.startswith("NC"):
        return fn(x)
    return fn(x.movedim(-1, 1)).movedim(1, -1)


_FUSED_NORM = [False]


def set_fused_norm(flag=True):
    """Turn the fused LayerNorm / RMSNorm path on (or off) for tensors
    off CUDA too, where it computes the kernels' plain versions; returns
    the previous value. On CUDA the fused path is the default whatever
    this says, as on a TPU in the reference."""
    prev = _FUSED_NORM[0]
    _FUSED_NORM[0] = bool(flag)
    return prev


def fused_norm_enabled():
    return _FUSED_NORM[0]


def _use_fused(fused, x):
    """An explicit ``fused`` wins; None means "on CUDA, or everywhere
    under :func:`set_fused_norm`", as the reference's None means "on a
    TPU, or everywhere under its flag". On a CPU tensor the fused path
    computes the kernel's plain version."""
    if fused is not None:
        return bool(fused)
    return _FUSED_NORM[0] or x.is_cuda


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               fused=None):
    """LayerNorm over the trailing ``normalized_shape`` axes. The
    composition is the reference's: under autocast a narrow x is raised to
    f32 first (``layer_norm`` is on the black list), and under a bf16
    activation policy the result returns to x's type."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    nd = len(tuple(normalized_shape))
    if nd == 1 and _use_fused(fused, x):
        xc = x.contiguous()
        if _kernels.ln_kernel_takes(xc, weight, bias):
            return _kernels.ln_fwd(xc, weight, bias, epsilon)
        _kernels.ROUTED["layer_norm"] += 1
    orig_dtype = x.dtype
    (x,) = downcast_inputs(x, opname="layer_norm")
    axes = tuple(range(x.dim() - nd, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
    out = (x - mean) / torch.sqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    pol = current_policy()
    if pol is not None and pol.dtype is not None and out.dtype != orig_dtype:
        out = out.to(orig_dtype)
    return out


def fused_ln_residual(x, residual, weight=None, bias=None, epsilon=1e-5,
                      act=None, fused=None):
    """``h = x + residual; y = act(LN(h))``, returning ``(h, y)``: the
    residual-stream update and the next sublayer's normalized input.
    The fused path (one kernel) needs a weight; the composition below
    takes its statistics from h in h's type, as the reference's does.
    ``act`` is None or ``"gelu"`` (tanh form)."""
    if _use_fused(fused, x) and weight is not None:
        xc, rc = x.contiguous(), residual.contiguous()
        if _kernels.ln_kernel_takes(xc, weight, bias, rc):
            return _kernels.ln_res_fwd(xc, rc, weight, bias, epsilon, act)
        _kernels.ROUTED["fused_ln_residual"] += 1
    h = x + residual
    hf = h.float()
    mean = hf.mean(dim=-1, keepdim=True)
    var = ((hf - mean) ** 2).mean(dim=-1, keepdim=True)
    out = (hf - mean) / torch.sqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    if act == "gelu":
        out = torch.nn.functional.gelu(out, approximate="tanh")
    return h, out.to(h.dtype)


def fused_add_layer_norm(x, residual, weight, bias=None, epsilon=1e-5):
    """The post-LN join ``LN(x + residual)``, y alone: the kernel's
    y-only entry (:func:`paddle_tpu_torch.ops.cuda.norm.
    fused_add_layer_norm`) whenever it takes the tensors, as the
    reference's post-LN blocks call the Pallas kernel whatever the
    device; other tensors go to the composition of
    :func:`fused_ln_residual` before any launch, counted in ``ROUTED``.
    y is in promote_types(x, residual)."""
    xc, rc = x.contiguous(), residual.contiguous()
    if _kernels.ln_kernel_takes(xc, weight, bias, rc):
        return _kernels.fused_add_layer_norm(xc, rc, weight, bias, epsilon)
    _kernels.ROUTED["fused_add_layer_norm"] += 1
    return fused_ln_residual(x, residual, weight, bias, epsilon,
                             fused=False)[1]


def rms_norm(x, weight=None, epsilon=1e-6, fused=None):
    """RMSNorm over the last axis. The fused path (the kernel) computes in
    f32 and returns x's type. The composition is the reference's: the
    normalised x is rounded to x's type before the weight multiplies it,
    so a bf16 x with an f32 weight gives f32 there."""
    if _use_fused(fused, x):
        xc = x.contiguous()
        if _kernels.rms_kernel_takes(xc, weight):
            return _kernels.rms_fwd(xc, weight, epsilon)
        _kernels.ROUTED["rms_norm"] += 1
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    out = (xf / torch.sqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out
