"""NaN and Inf detection (counterpart of ``paddle_tpu/amp/debugging.py``).

:func:`check_numerics` and :func:`compute_nan_inf_count` check one
tensor (host reads). :func:`enable_tensor_checker` is the reference's
``jax_debug_nans`` mode: every operator's floating outputs are checked
as it runs, through a ``TorchDispatchMode`` on this thread, and the
first NaN raises FloatingPointError naming the operator. Each check is
a host read, so the checker is for eager debugging, not for a captured
step.
"""
from __future__ import annotations

import contextlib
import enum

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["DebugMode", "TensorCheckerConfig", "check_nan_inf",
           "check_numerics", "compute_nan_inf_count",
           "disable_tensor_checker", "enable_tensor_checker"]


class DebugMode(enum.Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 2


class TensorCheckerConfig:
    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None,
                 stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir


class _NanChecker(TorchDispatchMode):
    """Raises at the first operator whose floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"NaN in the output of {func} (shape "
                    f"{tuple(t.shape)}, dtype {t.dtype})")
        return out


_checker = []           # the modes enable_tensor_checker entered


def enable_tensor_checker(config=None):
    """Check every operator's floating outputs for NaN on this thread
    until :func:`disable_tensor_checker`."""
    if config is not None and not config.enable:
        return
    mode = _NanChecker()
    mode.__enter__()
    _checker.append(mode)


def disable_tensor_checker():
    while _checker:
        _checker.pop().__exit__(None, None, None)


@contextlib.contextmanager
def check_nan_inf(enable=True):
    """The checker for the dynamic extent."""
    if not enable:
        yield
        return
    with _NanChecker():
        yield


def compute_nan_inf_count(tensor):
    """``(NaN count, Inf count)`` of a tensor (a host read)."""
    t = torch.as_tensor(tensor)
    if not (t.is_floating_point() or t.is_complex()):
        return 0, 0
    return int(torch.isnan(t).sum()), int(torch.isinf(t).sum())


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """``tensor`` when it is finite (or not floating); FloatingPointError
    with its counts otherwise."""
    nan_ct, inf_ct = compute_nan_inf_count(tensor)
    if nan_ct or inf_ct:
        t = torch.as_tensor(tensor)
        raise FloatingPointError(
            f"check_numerics failed for {op_type or 'tensor'} "
            f"{var_name or ''}: {nan_ct} NaN, {inf_ct} Inf "
            f"(shape {tuple(t.shape)}, dtype {t.dtype})")
    return tensor
