"""What every kernel wrapper of the port shares: binding the built
library's C functions, routing a call by the devices of its tensors,
turning a launch's CUDA error code into an exception, and the counts.

Each wrapper module declares its counts (``LAUNCHES``, ``ROUTED``) with
:func:`counts`, and a wrapper adds one where it launches its kernel (or
routes a call), in Python. The counts mean calls executed on the device:
a CUDA graph replays its kernels without the host, so the region it
captured is counted by :func:`captured_counts`, which takes the region's
increases back out of the counts and keeps them, and each replay adds
them once with :func:`add_replay_counts`.

:func:`booked` puts a wrapper's launch in the roofline profiler's books
(:mod:`paddle_tpu_torch.observability.profile`) while one walks a call:
one row at the call boundary, costed by :mod:`.cost`, whether the call
launches the kernel or computes its plain version, and nothing for the
plain version's own operations. :func:`op_scope` names a contraction of
a plain version for that walk. The profiler sets :data:`WALK`; this
layer never imports it.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from paddle_tpu_torch.ops.cuda import build

__all__ = ["add_replay_counts", "bind", "booked", "captured_counts",
           "counts", "op_scope", "ptr", "raise_on", "route", "stream"]

_bound = {}           # C function name -> the library it was declared on
_counts = []          # every dict declared with counts()
# the profiler's walk in progress, or None: what booked() books into
WALK = [None]


def booked(cost):
    """Decorator of a kernel wrapper: while a profiler walk is active,
    the call is booked as the launches ``cost(*args, **kwargs)`` returns
    (:class:`~paddle_tpu_torch.ops.cuda.cost.KernelCost` s), and the
    operations inside it are not."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            walk = WALK[0]
            if walk is None:
                return fn(*args, **kwargs)
            with walk.kernel(cost(*args, **kwargs)):
                return fn(*args, **kwargs)
        return call
    return wrap


def op_scope(name):
    """The profiler's op scope ``name`` (the name the reference's einsum
    gives a contraction) while a walk is active, else nothing."""
    walk = WALK[0]
    return contextlib.nullcontext() if walk is None else walk.op_scope(name)


def counts(names):
    """A dict of counts, one per name, all 0, that the capture and replay
    helpers below know."""
    d = dict.fromkeys(names, 0)
    _counts.append(d)
    return d


@contextlib.contextmanager
def captured_counts():
    """Around a graph capture: yields a list that, on exit, holds each
    count's increase inside the region (``(counts, name, n)``), and the
    counts are as they were before it: a capture executes nothing."""
    before = [dict(d) for d in _counts]
    added = []
    try:
        yield added
    finally:
        for d, was in zip(_counts, before):
            for name, n in d.items():
                if n != was[name]:
                    added.append((d, name, n - was[name]))
            d.update(was)


def add_replay_counts(added):
    """One replay of a region :func:`captured_counts` recorded."""
    for d, name, n in added:
        d[name] += n


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
