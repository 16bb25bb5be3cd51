"""Autocast (counterpart of ``paddle_tpu/amp/auto_cast.py``, level O1).

Under :class:`auto_cast` the functionals of white-listed ops (matrix
products) cast their f32 inputs down to bf16, and those of black-listed
ops (the loss) raise narrow inputs to f32. Each op's functional calls
:func:`downcast_inputs` with its name, as the reference's op
implementations do. The state is per thread and set only inside the
context manager.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["BLACK_LIST", "WHITE_LIST", "auto_cast", "downcast_inputs",
           "is_enabled"]

# the ops of the reference's lists (paddle_tpu/amp/auto_cast.py) whose
# functionals the port has: an op joins with the functional that calls
# downcast_inputs for it
WHITE_LIST = {"einsum", "linear", "matmul"}
BLACK_LIST = {"cross_entropy", "softmax"}
_NARROW = (torch.bfloat16, torch.float16)


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False


_state = _AmpState()


class auto_cast:
    """Context manager enabling O1 autocast to bf16 on this thread."""

    def __enter__(self):
        self._prev = _state.enabled
        _state.enabled = True
        return self

    def __exit__(self, *exc):
        _state.enabled = self._prev
        return False


def is_enabled():
    """True inside :class:`auto_cast` on this thread."""
    return _state.enabled


def downcast_inputs(*tensors, opname="matmul"):
    """The autocast hook: white-listed ops get f32 inputs cast to bf16,
    black-listed ops get narrow-float inputs cast to
    f32, anything else (or autocast off) passes through."""
    if not _state.enabled:
        return tensors
    if opname in BLACK_LIST:
        return tuple(t.float() if isinstance(t, torch.Tensor)
                     and t.dtype in _NARROW else t for t in tensors)
    if opname in WHITE_LIST:
        return tuple(t.to(torch.bfloat16) if isinstance(t, torch.Tensor)
                     and t.dtype == torch.float32 else t for t in tensors)
    return tensors
