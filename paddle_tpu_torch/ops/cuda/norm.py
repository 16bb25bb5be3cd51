"""LayerNorm forward kernels (``csrc/norm.cu``): wrappers, plain
versions and launch counts.

- :func:`ln_fwd` replaces ``paddle_tpu/ops/pallas/norm.py:_ln_kernel``;
- :func:`ln_res_fwd` replaces ``paddle_tpu/ops/pallas/norm.py:_ln_res_kernel``.

A wrapper given CPU tensors computes its plain version
(:func:`_ln_fwd_ref`, :func:`_ln_res_fwd_ref`: the same f32 arithmetic
in PyTorch). Given CUDA tensors it launches the kernel on the current
stream, without synchronising, or raises. ``LAUNCHES`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.ops.cuda import build

__all__ = ["LAUNCHES", "MAX_HIDDEN", "ln_fwd", "ln_res_fwd"]

LAUNCHES = {"ln_fwd": 0, "ln_res_fwd": 0}
MAX_HIDDEN = 4096        # one warp holds a row in registers
_CHUNK = 8               # hidden must be a multiple: 16-byte accesses
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GELU_K = 0.7978845608028654   # sqrt(2/pi)
_GELU_C = 0.044715

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ln_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P],
    "ln_res_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   ctypes.c_float, _I, _P],
}
_declared = False


def _lib():
    global _declared
    lib = build.load_library()
    if not _declared:
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _declared = True
    return lib


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


# -------------------------------------------------------------- checks
def _check_rows(name, t, hidden=None):
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        f"(float32 or bfloat16)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.dim() < 1 or t.shape[-1] == 0:
        raise ValueError(f"{name}: shape {tuple(t.shape)} has no last axis")
    h = t.shape[-1]
    if hidden is not None and h != hidden:
        raise ValueError(f"{name}: last axis {h} != {hidden}")
    if h % _CHUNK or h > MAX_HIDDEN:
        raise ValueError(f"{name}: hidden {h} must be a multiple of "
                         f"{_CHUNK} and at most {MAX_HIDDEN}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _check_vector(name, t, hidden, device, dtype=None):
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, input on {device}")
    if t.dtype not in _DTYPES or (dtype is not None and t.dtype != dtype):
        raise TypeError(f"{name}: dtype {t.dtype} not supported")
    if tuple(t.shape) != (hidden,) or not t.is_contiguous():
        raise ValueError(f"{name}: must be a contiguous [{hidden}] vector")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _route(*tensors):
    """"cpu" for the plain version, "cuda" for the kernel; anything
    else (a mix of devices, another device type) raises."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no LayerNorm kernel for device {device}")
    return device.type


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# ------------------------------------------------------------ wrappers
def ln_fwd(x, weight=None, bias=None, eps=1e-5):
    """LayerNorm over the last axis of ``x`` (f32 math, output in x's
    type). ``weight``/``bias`` may be None; a bias without a weight is
    ignored, as in the TPU kernel."""
    if weight is None:
        bias = None
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
        x.data_ptr(), _ptr(weight), _ptr(bias), y.data_ptr(), rows, hidden,
        _DTYPES[x.dtype], _DTYPES[weight.dtype] if weight is not None else 0,
        float(eps), x.device.index, _stream(x.device))
    _raise_on(rc, "ln_fwd")
    LAUNCHES["ln_fwd"] += 1
    return y


def ln_res_fwd(x, residual, weight, bias=None, eps=1e-5, act=None):
    """``h = x + residual; y = act(LN(h) * weight + bias)`` over the last
    axis; returns ``(h, y)`` in promote_types(x, residual). ``act`` is
    None or ``"gelu"`` (tanh form)."""
    if act not in (None, "gelu"):
        raise ValueError(f"act must be None or 'gelu', got {act!r}")
    if weight is None:
        raise ValueError("ln_res_fwd needs a weight")
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
        x.data_ptr(), residual.data_ptr(), weight.data_ptr(), _ptr(bias),
        h.data_ptr(), y.data_ptr(), rows, hidden, _DTYPES[x.dtype],
        _DTYPES[residual.dtype], _DTYPES[weight.dtype], int(act == "gelu"),
        float(eps), x.device.index, _stream(x.device))
    _raise_on(rc, "ln_res_fwd")
    LAUNCHES["ln_res_fwd"] += 1
    return h, y
