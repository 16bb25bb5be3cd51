"""bf16 activation residency for training (counterpart of
``paddle_tpu/amp/policy.py``).

Under an :class:`ActivationPolicy` with a ``dtype``, every module
boundary casts f32 floating positional inputs down to that dtype (once,
at the first boundary: downstream modules see the narrow dtype and keep
it). Parameters are untouched: they stay f32 master weights, and the
matrix-product functionals consume them through the O1 autocast
downcasts that :func:`activation_residency` enters alongside, with their
weight gradients accumulated and returned in f32.

The cast is a global module forward pre-hook that the policy registers
on entry and removes on exit, and it acts only on the thread that
entered: the policy is scoped to the wrapped step, never global. It runs
before every other global pre-hook, so the cast happens at the boundary,
outside the module's profiler scope (as the reference casts before
entering the layer's scope).

The policy also carries the reference's remat mode: ``remat=True``
turns on the model's recompute units (its decoder blocks, through
:mod:`paddle_tpu_torch.distributed.recompute`) for the wrapped step;
``remat="bf16"`` also stores each region's saved f32 boundary
activations in bf16 (:meth:`ActivationPolicy.cast_saved`).
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.nn.modules import module as _module

from paddle_tpu_torch.amp.auto_cast import auto_cast

__all__ = ["ActivationPolicy", "activation_residency", "current_policy",
           "remat_active"]

_tls = threading.local()


class ActivationPolicy:
    """One step's mixed-precision storage policy: ``dtype`` is the
    residency dtype of activations ("bf16"/"bfloat16", or None to leave
    them alone); ``remat`` False (off), True (recompute blocks, saving
    their boundaries as they are) or "bf16" (recompute blocks, saving
    f32 boundaries in bf16)."""

    __slots__ = ("dtype", "remat")

    def __init__(self, dtype="bfloat16", remat=False):
        if dtype is None:
            self.dtype = None
        elif str(dtype) in ("bf16", "bfloat16"):
            self.dtype = torch.bfloat16
        else:
            raise ValueError("activation residency dtype must be None or "
                             f"'bf16'/'bfloat16'; got {dtype!r}")
        if remat not in (False, True, "bf16"):
            raise ValueError(
                f"remat must be False, True or 'bf16'; got {remat!r}")
        self.remat = remat

    def cast_input(self, t):
        """Module-boundary cast of one positional input: f32 floating
        tensors to the residency dtype (a recorded op, so gradients flow
        back through it)."""
        if self.dtype is not None and isinstance(t, torch.Tensor) \
                and t.dtype == torch.float32:
            return t.to(self.dtype)
        return t

    def cast_saved(self, t):
        """Storage cast of a recompute region's saved boundary: f32 to
        bf16 under ``remat="bf16"`` only."""
        if self.remat == "bf16" and t.dtype == torch.float32:
            return t.to(torch.bfloat16)
        return t

    def __repr__(self):
        return f"ActivationPolicy(dtype={self.dtype}, remat={self.remat!r})"


def current_policy():
    """The ActivationPolicy active on this thread, or None."""
    return getattr(_tls, "policy", None)


def remat_active():
    """The active policy's remat mode (False, True or "bf16")."""
    pol = current_policy()
    return pol.remat if pol is not None else False


def _cast_hook(_module, args):
    pol = current_policy()
    if pol is None or pol.dtype is None:
        return None
    return tuple(pol.cast_input(a) for a in args)


@contextlib.contextmanager
def activation_residency(dtype="bfloat16", remat=False):
    """Push an :class:`ActivationPolicy` (or build one from ``dtype`` and
    ``remat``) for the dynamic extent, with the matching O1 autocast when
    it has a residency dtype."""
    pol = dtype if isinstance(dtype, ActivationPolicy) else \
        ActivationPolicy(dtype, remat=remat)
    prev = current_policy()
    _tls.policy = pol
    handle = _module.register_module_forward_pre_hook(_cast_hook)
    _module._global_forward_pre_hooks.move_to_end(handle.id, last=False)
    try:
        if pol.dtype is not None:
            with auto_cast():
                yield pol
        else:
            yield pol
    finally:
        handle.remove()
        _tls.policy = prev
