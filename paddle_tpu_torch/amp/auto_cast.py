"""Autocast (counterpart of ``paddle_tpu/amp/auto_cast.py``, level O1).

Under :class:`auto_cast` the functionals of white-listed ops (matrix
products, convolutions) cast their f32 inputs down to the autocast
dtype (bf16 by default), and those of black-listed ops (the loss,
softmax, LayerNorm's composition) raise narrow inputs to f32. Each op's
functional calls :func:`downcast_inputs` with its name, as the
reference's op implementations do. The state is per thread and set only
inside the context manager.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["BLACK_LIST", "WHITE_LIST", "amp_guard", "amp_state", "auto_cast",
           "downcast_inputs", "is_enabled"]

# the ops of the reference's lists (paddle_tpu/amp/auto_cast.py) whose
# functionals the port has: an op joins with the functional that calls
# downcast_inputs for it
WHITE_LIST = {"conv1d", "conv2d", "conv3d", "einsum", "linear", "matmul"}
BLACK_LIST = {"cross_entropy", "layer_norm", "log_softmax", "softmax"}
_NARROW = (torch.bfloat16, torch.float16)


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def amp_state():
    """This thread's autocast state (``enabled``, ``dtype``, ``level``,
    ``custom_white``, ``custom_black``)."""
    return _state


class auto_cast:
    """Context manager enabling autocast on this thread
    (``paddle.amp.auto_cast``): ``dtype`` "bfloat16" (or any name with
    "bf" in it) or "float16", extra op names in ``custom_white_list`` /
    ``custom_black_list``; ``enable=False`` turns autocast off inside.
    Every field is restored on exit."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        self.enable = enable
        self.level = level
        self.dtype = torch.bfloat16 if "bf" in str(dtype) else torch.float16
        self.white = set(custom_white_list or [])
        self.black = set(custom_black_list or [])

    def __enter__(self):
        self._prev = (_state.enabled, _state.dtype, _state.level,
                      _state.custom_white, _state.custom_black)
        _state.enabled = self.enable
        _state.dtype = self.dtype
        _state.level = self.level
        _state.custom_white = self.white
        _state.custom_black = self.black
        return self

    def __exit__(self, *exc):
        (_state.enabled, _state.dtype, _state.level,
         _state.custom_white, _state.custom_black) = self._prev
        return False


amp_guard = auto_cast


def is_enabled():
    """True inside an enabled :class:`auto_cast` on this thread."""
    return _state.enabled


def downcast_inputs(*tensors, opname="matmul"):
    """The autocast hook: white-listed ops (and the custom white list)
    get f32 inputs cast to the autocast dtype, black-listed ops (and the
    custom black list, which wins) get narrow-float inputs cast to f32,
    anything else (or autocast off) passes through."""
    if not _state.enabled:
        return tensors
    if opname in BLACK_LIST or opname in _state.custom_black:
        return tuple(t.float() if isinstance(t, torch.Tensor)
                     and t.dtype in _NARROW else t for t in tensors)
    if opname in WHITE_LIST or opname in _state.custom_white:
        return tuple(t.to(_state.dtype) if isinstance(t, torch.Tensor)
                     and t.dtype == torch.float32 else t for t in tensors)
    return tensors
