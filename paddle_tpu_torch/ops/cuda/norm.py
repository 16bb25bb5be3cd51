"""LayerNorm kernels (``csrc/norm.cu``): wrappers, autograd, plain
versions and launch counts.

- :func:`ln_fwd` replaces ``paddle_tpu/ops/pallas/norm.py:_ln_kernel``;
- :func:`ln_res_fwd` replaces ``paddle_tpu/ops/pallas/norm.py:_ln_res_kernel``;
  :func:`fused_add_layer_norm` is its y-only entry, the post-LN join
  (``paddle_tpu/ops/pallas/norm.py:350``);
- :func:`ln_bwd` replaces ``_ln_bwd_kernel_plain`` and ``_ln_bwd_kernel_res``
  (one kernel; ``gh=None`` is the plain variant);
- :func:`rms_fwd` replaces ``paddle_tpu/ops/pallas/norm.py:_rms_kernel``.

:func:`ln_fwd` and :func:`ln_res_fwd` are differentiable: autograd
Functions that save only the LayerNorm's input (``x``, or ``h`` for the
residual form) and the weights, and whose backward recomputes the
statistics in :func:`ln_bwd`, as the reference's custom VJPs do
(``_ln_fwd_rule``/``_ln_bwd_rule``, ``_ln_res_fwd_rule``/``_ln_res_bwd_rule``).
:func:`rms_fwd` is an autograd Function that saves x and the weight and
whose backward is the plain composition :func:`_rms_bwd_ref`, as the
reference's ``_rms_bwd_rule`` is jnp.

A wrapper given CPU tensors computes its plain version
(:func:`_ln_fwd_ref`, :func:`_ln_res_fwd_ref`, :func:`_ln_bwd_ref`,
:func:`_rms_fwd_ref`: the same f32 arithmetic in PyTorch). Given CUDA tensors it launches the
kernel on the current stream, without synchronising, or raises.
``LAUNCHES`` counts the kernel launches (``ln_bwd`` and ``ln_bwd_res``
count the plain and residual variants apart).

:func:`ln_kernel_takes` and :func:`rms_kernel_takes` say whether the
kernels take a call's tensors (f32/bf16, hidden a multiple of 8 up to
``MAX_HIDDEN`` or ``MAX_RMS_HIDDEN``, 16-byte aligned). The normalization
functionals ask them before the call and send what they refuse to the
composition, counting those calls in ``ROUTED``; the wrappers themselves
still raise on what they do not take.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from paddle_tpu_torch.ops.cuda import cost, launch

__all__ = ["LAUNCHES", "MAX_HIDDEN", "MAX_RMS_HIDDEN", "ROUTED",
           "fused_add_layer_norm", "ln_bwd", "ln_bwd_split", "ln_fwd",
           "ln_fwd_split", "ln_kernel_takes", "ln_res_fwd", "rms_fwd",
           "rms_kernel_takes"]

LAUNCHES = launch.counts(("ln_fwd", "ln_res_fwd", "ln_bwd", "ln_bwd_res",
                          "rms_fwd"))
# calls the normalization functionals sent to their composition because
# the kernels do not take the tensors (ln_kernel_takes, rms_kernel_takes)
ROUTED = launch.counts(("layer_norm", "fused_ln_residual",
                        "fused_add_layer_norm", "rms_norm"))
MAX_HIDDEN = 4096        # forward and backward: H/8 threads a row, <= 512
MAX_RMS_HIDDEN = 16384   # rms_fwd: a block of <= 512 threads, 32 values each
_CHUNK = 8               # hidden must be a multiple: 16-byte accesses
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GELU_K = 0.7978845608028654   # sqrt(2/pi)
_GELU_C = 0.044715
_BWD_THREADS = 512        # ln_bwd: at most a block's threads (`slots` rows)
_BWD_BLOCKS_PER_SM = 2    # ln_bwd: blocks a launch aims for, per SM
_FWD_SM_THREADS = 1024    # ln_fwd, ln_res_fwd: resident threads an SM
                          # (norm.cu: kFwdBlocksPerSm x 512 threads)
_FWD_ONE_WARP_SLOTS = 4   # rows a block when one warp holds a row

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ln_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,
               _P],
    "ln_res_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                   ctypes.c_float, _I, _P],
    "ln_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
               _I, _I, ctypes.c_float, _I, _P],
    "rms_fwd": [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P],
}


def _lib():
    return launch.bind(_SIGNATURES)


# ------------------------------------------------------ plain versions
def _gelu_tanh(u):
    t = torch.tanh(_GELU_K * (u + _GELU_C * u * u * u))
    return 0.5 * u * (1.0 + t)


def _normalize(hf, weight, bias, eps):
    mean = hf.mean(dim=-1, keepdim=True)
    xc = hf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
        if bias is not None:
            y = y + bias.float()
    return y


def _ln_fwd_ref(x, weight, bias, eps):
    """Plain version of :func:`ln_fwd`: f32 math, output in x's type."""
    return _normalize(x.float(), weight, bias, eps).to(x.dtype)


def _ln_res_fwd_ref(x, residual, weight, bias, eps, act=None):
    """Plain version of :func:`ln_res_fwd`: ``h = x + r`` in f32, the
    statistics from that f32 h, both outputs in promote_types(x, r)."""
    out = torch.promote_types(x.dtype, residual.dtype)
    h = x.float() + residual.float()
    y = _normalize(h, weight, bias, eps)
    if act == "gelu":
        y = _gelu_tanh(y)
    return h.to(out), y.to(out)


def _gelu_tanh_grad(u):
    t = torch.tanh(_GELU_K * (u + _GELU_C * u * u * u))
    return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * _GELU_K \
        * (1.0 + 3.0 * _GELU_C * u * u)


def _ln_bwd_ref(h, gy, weight, bias, eps, act=None, gh=None):
    """Plain version of :func:`ln_bwd` (``_ln_bwd_core``): statistics
    recomputed from h in f32; dx (+ gh) in h's type, dw/db summed in f32
    and cast to the weights' types. With no weight it is the reference's
    no-affine composition (``_ln_bwd_jnp``): dw and db are None."""
    hf = h.float()
    g = gy.float()
    mean = hf.mean(dim=-1, keepdim=True)
    xc = hf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    if act == "gelu":
        u = xhat * weight.float()
        if bias is not None:
            u = u + bias.float()
        g = g * _gelu_tanh_grad(u)
    gw = g * weight.float() if weight is not None else g
    m1 = gw.mean(dim=-1, keepdim=True)
    m2 = (gw * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (gw - m1 - xhat * m2)
    if gh is not None:
        dx = dx + gh.float()
    lead = tuple(range(h.dim() - 1))
    dw = (g * xhat).sum(dim=lead).to(weight.dtype) \
        if weight is not None else None
    db = g.sum(dim=lead).to(bias.dtype) if bias is not None else None
    return dx.to(h.dtype), dw, db


def _rms_fwd_ref(x, weight, eps):
    """Plain version of :func:`rms_fwd` (``_rms_kernel``): f32 math,
    ``(x * rsqrt(mean(x^2) + eps)) * w``, output in x's type."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def _rms_bwd_ref(x, gy, weight, eps):
    """RMSNorm backward, the reference's ``_rms_bwd_rule``: statistics
    recomputed from x in f32; dx in x's type, dw summed in f32 over every
    leading axis and cast to the weight's type (None without a weight)."""
    xf = x.float()
    g = gy.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    gw = g * weight.float() if weight is not None else g
    dx = rstd * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    dw = None if weight is None else \
        (g * xhat).sum(dim=tuple(range(x.dim() - 1))).to(weight.dtype)
    return dx.to(x.dtype), dw


# -------------------------------------------------------------- checks
# Each *_fault returns the exception a check raises, or None: the checks
# raise it, and the *_kernel_takes predicates ask whether there is one.
def _rows_fault(name, t, hidden=None, limit=MAX_HIDDEN):
    if t.dtype not in _DTYPES:
        return TypeError(f"{name}: dtype {t.dtype} not supported "
                         f"(float32 or bfloat16)")
    if not t.is_contiguous():
        return ValueError(f"{name}: tensor must be contiguous")
    if t.dim() < 1 or t.shape[-1] == 0:
        return ValueError(f"{name}: shape {tuple(t.shape)} has no last axis")
    h = t.shape[-1]
    if hidden is not None and h != hidden:
        return ValueError(f"{name}: last axis {h} != {hidden}")
    if h % _CHUNK or h > limit:
        return ValueError(f"{name}: hidden {h} must be a multiple of "
                          f"{_CHUNK} and at most {limit}")
    if t.data_ptr() % 16:
        return ValueError(f"{name}: data must be 16-byte aligned")
    return None


def _vector_fault(name, t, hidden, device, dtype=None):
    if t is None:
        return None
    if t.device != device:
        return ValueError(f"{name}: on {t.device}, input on {device}")
    if t.dtype not in _DTYPES or (dtype is not None and t.dtype != dtype):
        return TypeError(f"{name}: dtype {t.dtype} not supported")
    if tuple(t.shape) != (hidden,) or not t.is_contiguous():
        return ValueError(f"{name}: must be a contiguous [{hidden}] vector")
    if t.data_ptr() % 16:
        return ValueError(f"{name}: data must be 16-byte aligned")
    return None


def _check_rows(name, t, hidden=None, limit=MAX_HIDDEN):
    fault = _rows_fault(name, t, hidden, limit)
    if fault is not None:
        raise fault


def _check_vector(name, t, hidden, device, dtype=None):
    fault = _vector_fault(name, t, hidden, device, dtype)
    if fault is not None:
        raise fault


def ln_kernel_takes(x, weight=None, bias=None, residual=None):
    """True exactly when the LayerNorm kernels take these tensors (the
    checks of :func:`ln_fwd`, or with ``residual`` of
    :func:`ln_res_fwd`, pass): contiguous f32/bf16 rows of a hidden size
    that is a multiple of 8 and at most ``MAX_HIDDEN``, 16-byte aligned,
    and matching weight/bias vectors (a bias without a weight is ignored,
    as in :func:`ln_fwd`). It asks nothing of the device type."""
    if _rows_fault("x", x) is not None:
        return False
    hidden = x.shape[-1]
    if residual is not None and (
            residual.shape != x.shape
            or _rows_fault("residual", residual, hidden) is not None):
        return False
    if weight is None:
        return residual is None
    return _vector_fault("weight", weight, hidden, x.device) is None and \
        _vector_fault("bias", bias, hidden, x.device, weight.dtype) is None


def rms_kernel_takes(x, weight=None):
    """True exactly when :func:`rms_fwd`'s kernel takes these tensors:
    as :func:`ln_kernel_takes`, with hidden at most ``MAX_RMS_HIDDEN``."""
    return _rows_fault("x", x, limit=MAX_RMS_HIDDEN) is None and \
        _vector_fault("weight", weight, x.shape[-1], x.device) is None


def ln_bwd_split(rows, hidden, sm_count):
    """How :func:`ln_bwd`'s kernel splits ``rows``: ``(slots,
    rows_per_block, n_blocks)``. A block holds ``slots`` rows at once,
    hidden/8 threads each (rounded up to a warp), at most 512 threads;
    the launch aims for two blocks an SM, each a run of ``rows_per_block``
    consecutive rows (a multiple of ``slots``), the last one ragged.
    ``n_blocks`` is also the count of f32 dw/db partial rows."""
    per_slot = -(-hidden // _CHUNK // 32) * 32
    slots = max(1, _BWD_THREADS // per_slot)
    per_block = -(-rows // (sm_count * _BWD_BLOCKS_PER_SM))
    per_block = -(-per_block // slots) * slots
    return slots, per_block, -(-rows // per_block)


def ln_fwd_split(rows, hidden, sm_count):
    """How the LayerNorm forwards split ``rows``: ``(threads, slots,
    blocks)``. A row belongs to a team of hidden/8 threads (rounded up to
    a warp), one 16-byte chunk a lane; a team of several warps is a block,
    one-warp teams go ``slots`` to a block of ``threads``. The launch has
    ``blocks`` blocks, at most one wave of resident blocks on ``sm_count``
    SMs; team s of block i takes row ``i * slots + s``, then every
    ``blocks * slots``-th row after it."""
    warps = -(-hidden // _CHUNK // 32)
    slots = _FWD_ONE_WARP_SLOTS if warps == 1 else 1
    threads = 32 * warps * slots
    wave = sm_count * (_FWD_SM_THREADS // threads)
    return threads, slots, min(-(-rows // slots), wave)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fwd_grid(rows, hidden, device):
    """(slots, blocks) of :func:`ln_fwd_split` on ``device``: what the
    forwards' C entry points take (the threads follow from hidden)."""
    return ln_fwd_split(rows, hidden, _sm_count(device.index))[1:]


def _route(*tensors):
    return launch.route("LayerNorm", *tensors)


def _route_rms(*tensors):
    return launch.route("RMSNorm", *tensors)


# ----------------------------------------------------------- launchers
@launch.booked(cost.ln_fwd)
def _ln_fwd_launch(x, weight, bias, eps):
    if _route(x, weight, bias) == "cpu":
        return _ln_fwd_ref(x, weight, bias, eps)
    _check_rows("ln_fwd x", x)
    hidden = x.shape[-1]
    _check_vector("ln_fwd weight", weight, hidden, x.device)
    _check_vector("ln_fwd bias", bias, hidden, x.device,
                  None if weight is None else weight.dtype)
    y = torch.empty_like(x)
    rows = x.numel() // hidden
    if rows == 0:
        return y
    rc = _lib().ln_fwd(
        x.data_ptr(), launch.ptr(weight), launch.ptr(bias), y.data_ptr(),
        rows, hidden, *_fwd_grid(rows, hidden, x.device),
        _DTYPES[x.dtype], _DTYPES[weight.dtype] if weight is not None else 0,
        float(eps), x.device.index, launch.stream(x.device))
    launch.raise_on(rc, "ln_fwd")
    LAUNCHES["ln_fwd"] += 1
    return y


@launch.booked(cost.ln_res_fwd)
def _ln_res_fwd_launch(x, residual, weight, bias, eps, act):
    if _route(x, residual, weight, bias) == "cpu":
        return _ln_res_fwd_ref(x, residual, weight, bias, eps, act)
    _check_rows("ln_res_fwd x", x)
    hidden = x.shape[-1]
    _check_rows("ln_res_fwd residual", residual, hidden)
    if residual.shape != x.shape:
        raise ValueError(f"ln_res_fwd: residual {tuple(residual.shape)} != "
                         f"x {tuple(x.shape)}")
    _check_vector("ln_res_fwd weight", weight, hidden, x.device)
    _check_vector("ln_res_fwd bias", bias, hidden, x.device, weight.dtype)
    out_dtype = torch.promote_types(x.dtype, residual.dtype)
    h = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    y = torch.empty_like(h)
    rows = x.numel() // hidden
    if rows == 0:
        return h, y
    rc = _lib().ln_res_fwd(
        x.data_ptr(), residual.data_ptr(), weight.data_ptr(),
        launch.ptr(bias),
        h.data_ptr(), y.data_ptr(), rows, hidden,
        *_fwd_grid(rows, hidden, x.device),
        _DTYPES[x.dtype],
        _DTYPES[residual.dtype], _DTYPES[weight.dtype], int(act == "gelu"),
        float(eps), x.device.index, launch.stream(x.device))
    launch.raise_on(rc, "ln_res_fwd")
    LAUNCHES["ln_res_fwd"] += 1
    return h, y


@launch.booked(cost.rms_fwd)
def _rms_fwd_launch(x, weight, eps):
    if _route_rms(x, weight) == "cpu":
        return _rms_fwd_ref(x, weight, eps)
    _check_rows("rms_fwd x", x, limit=MAX_RMS_HIDDEN)
    hidden = x.shape[-1]
    _check_vector("rms_fwd weight", weight, hidden, x.device)
    y = torch.empty_like(x)
    rows = x.numel() // hidden
    if rows == 0:
        return y
    rc = _lib().rms_fwd(
        x.data_ptr(), launch.ptr(weight), y.data_ptr(), rows, hidden,
        _DTYPES[x.dtype], _DTYPES[weight.dtype] if weight is not None else 0,
        float(eps), x.device.index, launch.stream(x.device))
    launch.raise_on(rc, "rms_fwd")
    LAUNCHES["rms_fwd"] += 1
    return y


@launch.booked(cost.ln_bwd)
def ln_bwd(h, gy, weight, bias=None, eps=1e-5, act=None, gh=None):
    """LayerNorm backward from the saved pre-norm rows ``h`` and the
    cotangent ``gy`` of its output (``act`` as in the forward); ``gh``,
    the cotangent of h itself in the residual form, is added to dx.
    Returns ``(dx, dw, db)``: dx in h's type, dw/db in the weights'
    types (db None without a bias)."""
    if act not in (None, "gelu"):
        raise ValueError(f"act must be None or 'gelu', got {act!r}")
    if weight is None:
        raise ValueError("ln_bwd needs a weight")
    if _route(h, gy, gh, weight, bias) == "cpu":
        return _ln_bwd_ref(h, gy, weight, bias, eps, act, gh)
    _check_rows("ln_bwd h", h)
    hidden = h.shape[-1]
    for name, t in (("gy", gy), ("gh", gh)):
        if t is None:
            continue
        _check_rows(f"ln_bwd {name}", t, hidden)
        if t.shape != h.shape or t.dtype != h.dtype:
            raise ValueError(f"ln_bwd: {name} {tuple(t.shape)} {t.dtype} != "
                             f"h {tuple(h.shape)} {h.dtype}")
    _check_vector("ln_bwd weight", weight, hidden, h.device)
    _check_vector("ln_bwd bias", bias, hidden, h.device, weight.dtype)
    dx = torch.empty_like(h)
    rows = h.numel() // hidden
    if rows == 0:
        return (dx, torch.zeros_like(weight),
                None if bias is None else torch.zeros_like(bias))
    lib = _lib()
    slots, per_block, n_blocks = ln_bwd_split(rows, hidden,
                                              _sm_count(h.device.index))
    parts = torch.empty((2, n_blocks, hidden), dtype=torch.float32,
                        device=h.device)
    dw = torch.empty_like(weight)
    db = None if bias is None else torch.empty_like(bias)
    rc = lib.ln_bwd(
        h.data_ptr(), gy.data_ptr(), launch.ptr(gh), weight.data_ptr(),
        launch.ptr(bias), dx.data_ptr(), parts[0].data_ptr(),
        parts[1].data_ptr(), dw.data_ptr(), launch.ptr(db), rows, hidden,
        per_block, slots, _DTYPES[h.dtype], _DTYPES[weight.dtype],
        int(act == "gelu"), float(eps), h.device.index,
        launch.stream(h.device))
    launch.raise_on(rc, "ln_bwd")
    LAUNCHES["ln_bwd" if gh is None else "ln_bwd_res"] += 1
    return dx, dw, db


# ------------------------------------------------------------ autograd
class _LayerNorm(torch.autograd.Function):
    """``_ln_fwd_rule``/``_ln_bwd_rule``: saves x and the weights."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return _ln_fwd_launch(x, weight, bias, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        x, weight, bias = ctx.saved_tensors
        if weight is None:             # no kernel: the plain composition
            dx, _, _ = _ln_bwd_ref(x, gy, None, None, ctx.eps)
            return dx, None, None, None
        dx, dw, db = ln_bwd(x, gy.contiguous(), weight, bias, ctx.eps)
        return dx, dw, db, None


class _LayerNormResidual(torch.autograd.Function):
    """``_ln_res_fwd_rule``/``_ln_res_bwd_rule``: saves h and the
    weights; an unused h (no cotangent) takes the plain backward."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, eps, act):
        h, y = _ln_res_fwd_launch(x, residual, weight, bias, eps, act)
        ctx.save_for_backward(h, weight, bias)
        ctx.eps, ctx.act = eps, act
        ctx.dtypes = (x.dtype, residual.dtype)
        ctx.set_materialize_grads(False)
        return h, y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gh, gy):
        h, weight, bias = ctx.saved_tensors
        dw = db = None
        if gy is not None:
            gh = None if gh is None else gh.contiguous()
            dh, dw, db = ln_bwd(h, gy.contiguous(), weight, bias, ctx.eps,
                                ctx.act, gh)
        elif gh is not None:
            dh = gh
        else:
            return None, None, None, None, None, None
        x_dtype, r_dtype = ctx.dtypes
        return dh.to(x_dtype), dh.to(r_dtype), dw, db, None, None


class _RMSNorm(torch.autograd.Function):
    """``_rms_fwd_rule``/``_rms_bwd_rule``: saves x and the weight."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_fwd_launch(x, weight, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        dx, dw = _rms_bwd_ref(x, gy, weight, ctx.eps)
        return dx, dw, None


# ------------------------------------------------------------ wrappers
def ln_fwd(x, weight=None, bias=None, eps=1e-5):
    """LayerNorm over the last axis of ``x`` (f32 math, output in x's
    type). ``weight``/``bias`` may be None; a bias without a weight is
    ignored, as in the TPU kernel. Differentiable in x, weight and bias."""
    if weight is None:
        bias = None
    return _LayerNorm.apply(x, weight, bias, eps)


def ln_res_fwd(x, residual, weight, bias=None, eps=1e-5, act=None):
    """``h = x + residual; y = act(LN(h) * weight + bias)`` over the last
    axis; returns ``(h, y)`` in promote_types(x, residual). ``act`` is
    None or ``"gelu"`` (tanh form). Differentiable in x, residual, weight
    and bias."""
    if act not in (None, "gelu"):
        raise ValueError(f"act must be None or 'gelu', got {act!r}")
    if weight is None:
        raise ValueError("ln_res_fwd needs a weight")
    return _LayerNormResidual.apply(x, residual, weight, bias, eps, act)


def fused_add_layer_norm(x, residual, weight, bias=None, eps=1e-5,
                         act=None):
    """The post-LN join ``y = act(LN(x + residual))``, returning y alone
    (``fused_add_layer_norm``, ``paddle_tpu/ops/pallas/norm.py:350``):
    :func:`ln_res_fwd`'s kernel forward, whose h no one reads, so its
    backward gets no cotangent for h and runs :func:`ln_bwd` without
    ``gh`` (``_add_ln_bwd_rule``). dx comes back in x's type and
    dresidual in the residual's; y is in promote_types(x, residual)."""
    return ln_res_fwd(x, residual, weight, bias, eps, act)[1]


def rms_fwd(x, weight=None, eps=1e-6):
    """RMSNorm over the last axis of ``x``: ``x * rsqrt(mean(x^2) + eps)
    * weight`` with f32 math, output in x's type (f32 or bf16 x, f32 or
    bf16 weight, which may be None). The kernel takes a hidden size that
    is a multiple of 8 up to ``MAX_RMS_HIDDEN``. Differentiable in x and
    weight."""
    return _RMSNorm.apply(x, weight, eps)
