"""What every kernel wrapper of the port shares: binding the built
library's C functions, routing a call by the devices of its tensors, and
turning a launch's CUDA error code into an exception."""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.ops.cuda import build

__all__ = ["bind", "ptr", "raise_on", "route", "stream"]

_bound = {}           # C function name -> the library it was declared on


def bind(signatures):
    """The loaded library (built first if needed), with ``argtypes`` set
    for ``signatures`` (``{name: [ctypes types]}``) and an int result."""
    lib = build.load_library()
    for name, argtypes in signatures.items():
        if _bound.get(name) is not lib:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _bound[name] = lib
    return lib


def route(what, *tensors):
    """"cpu" for the plain version, "cuda" for the kernel; anything
    else (a mix of devices, another device type) raises."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {device}")
    return device.type


def ptr(t):
    return None if t is None else t.data_ptr()


def stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
